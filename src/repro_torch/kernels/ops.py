"""Model-layout wrappers around the attention kernels and the SSD and RG-LRU
scans.

These adapt model-layout tensors ((B, S, H, D) etc.) to the kernel
layouts, as the JAX package's ``kernels/ops.py`` does for its Pallas
kernels. Which implementation runs is decided inside the kernel wrappers,
by the device of the tensors: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import bullet_attention as _bullet
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import ssd_scan as _ssd


def _heads_major(x):
    """(B, S, H, D) -> (B·H, S, D), contiguous."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def flash_attention_op(q, k, v, *, causal=True, window=0, q_offset=0):
    """Model layout: q (B,Sq,H,D), k/v (B,Sk,K,D), query row i at position
    ``q_offset + i`` among the keys. Returns (B,Sq,H,D). The layout
    changes are autograd ops, so a gradient flows through kernel 1's
    ``FlashAttention`` to q, k and v."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    o = _flash.flash_attention(_heads_major(q), _heads_major(k),
                               _heads_major(v), causal=causal, window=window,
                               group=h // kh, q_offset=q_offset)
    return o.reshape(b, h, s, d).transpose(1, 2)


def decode_attention_op(q, k_cache, v_cache, kv_positions, pos):
    """Model layout: q (B,1,H,D), caches (B,S,K,D), kv_positions (B,S)
    int32, pos (B,) int32. Returns (B,1,H,D)."""
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    qr = q.reshape(b, kh, h // kh, d)
    o = _decode.decode_attention(qr, k_cache, v_cache, kv_positions, pos)
    return o.reshape(b, 1, h, d)


def paged_decode_attention_op(q, k_pages, v_pages, block_tables, pos):
    """Model layout: q (B,1,H,D), pages (P,ps,K,D), block_tables (B,n_b)
    int32 physical pages, pos (B,) int32. Returns (B,1,H,D)."""
    b, _, h, d = q.shape
    kh = k_pages.shape[2]
    qr = q.reshape(b, kh, h // kh, d)
    o = _paged.paged_decode_attention(qr, k_pages, v_pages, block_tables, pos)
    return o.reshape(b, 1, h, d)


def bullet_attention_op(qp, kp, vp, qd, kd, vd, kv_positions, pos, *,
                        decode_share=0.5, causal=True, window=0):
    """Fused hybrid-batch attention with dense decode KV (model layouts).

    Prefill: qp (Bp,Sp,H,D), kp/vp (Bp,Sp,K,D).
    Decode:  qd (Bd,1,H,D), kd/vd (Bd,Sk,K,D), kv_positions (Bd,Sk) int32,
             pos (Bd,) int32.
    Returns (out_p (Bp,Sp,H,D), out_d (Bd,1,H,D)).
    """
    bp, sp, h, d = qp.shape
    kh = kp.shape[2]
    bd = qd.shape[0]
    op, od = _bullet.bullet_attention(
        _heads_major(qp), _heads_major(kp), _heads_major(vp),
        qd.reshape(bd, kh, h // kh, d), kd, vd, kv_positions, pos,
        decode_share=decode_share, causal=causal, window=window,
        group=h // kh)
    return op.reshape(bp, h, sp, d).transpose(1, 2), od.reshape(bd, 1, h, d)


def bullet_attention_paged_op(qp, kp, vp, qd, k_pages, v_pages, block_tables,
                              pos, *, decode_share=0.5, causal=True,
                              window=0):
    """Fused hybrid-batch attention with paged decode KV (model layouts).

    Prefill: qp (Bp,Sp,H,D), kp/vp (Bp,Sp,K,D).
    Decode:  qd (Bd,1,H,D), pages (P+1,ps,K,D), block_tables (Bd,n_b) int32
             physical pages (trash page past live context), pos (Bd,) int32.
    Returns (out_p (Bp,Sp,H,D), out_d (Bd,1,H,D)).
    """
    bp, sp, h, d = qp.shape
    kh = kp.shape[2]
    bd = qd.shape[0]
    op, od = _bullet.bullet_attention_paged(
        _heads_major(qp), _heads_major(kp), _heads_major(vp),
        qd.reshape(bd, kh, h // kh, d), k_pages, v_pages, block_tables, pos,
        decode_share=decode_share, causal=causal, window=window,
        group=h // kh)
    return op.reshape(bp, h, sp, d).transpose(1, 2), od.reshape(bd, 1, h, d)


def ssd_chunk_inputs(x, dt, A, B_, C, *, chunk=256):
    """The SSD kernel's inputs from the model layout: the sequence padded to
    a multiple of the chunk ``q = min(chunk, S)`` with dt = 0 steps (decay
    e^0 = 1, zero input: the state passes through unchanged), ``xw = x·dt``
    in x's dtype and the within-chunk cumulative log decay in fp32. Returns
    (xw (B,NC,Q,H,P), cum (B,NC,Q,H), B (B,NC,Q,N), C (B,NC,Q,N))."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    pad = (q - s % q) % q
    dtf = dt.float()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // q
    cum = torch.cumsum((dtf * A.float()).reshape(b, nc, q, h), dim=2)
    xw = (x.float() * dtf[..., None]).to(x.dtype)
    return (xw.reshape(b, nc, q, h, p).contiguous(), cum.contiguous(),
            B_.to(x.dtype).reshape(b, nc, q, n).contiguous(),
            C.to(x.dtype).reshape(b, nc, q, n).contiguous())


def ssd_scan_op(x, dt, A, B_, C, D, *, chunk=256, state0=None):
    """Model layout (the contract of ``repro_torch.models.ssm.ssd_chunked``):

    x (B,S,H,P), dt (B,S,H) softplus'd fp32, A (H,) negative, B_/C (B,S,N),
    D (H,). Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32).

    The kernel's inputs come from :func:`ssd_chunk_inputs`, the ``D`` skip
    is added after the scan, and the final state is the one the kernel
    writes. ``state0`` (B,H,P,N), the state a chunk of a prompt continues
    from (chunked prefill), enters the first chunk; the padded tail
    (dt = 0) carries the state unchanged, as in the JAX ``ssd_chunked``."""
    b, s, h, p = x.shape
    if state0 is not None:
        state0 = state0.float().contiguous()
    y, state = _ssd.ssd_scan(*ssd_chunk_inputs(x, dt, A, B_, C, chunk=chunk),
                             state0)
    y = y.reshape(b, -1, h, p)[:, :s].float() \
        + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def rglru_scan_op(a, b, h0=None):
    """a, b: (B,S,W) (the contract of ``src/repro/kernels/ops.py``'s
    ``rglru_scan_op``), h0: (B,W) or None. Returns (y (B,S,W) in a's
    dtype, h_T (B,W) fp32). h_T is the state the kernel carried in fp32,
    where the JAX op rounds ``y[:, -1]`` to y's dtype first."""
    return _rglru.rglru_scan(a.contiguous(), b.contiguous(),
                             None if h0 is None
                             else h0.float().contiguous())
