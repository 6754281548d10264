"""Model-layout wrappers around the attention kernels.

These adapt model-layout tensors ((B, S, H, D) etc.) to the kernel
layouts, as the JAX package's ``kernels/ops.py`` does for its Pallas
kernels. Which implementation runs is decided inside the kernel wrappers,
by the device of the tensors: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.
"""

from __future__ import annotations

from repro_torch.kernels import bullet_attention as _bullet
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged


def _heads_major(x):
    """(B, S, H, D) -> (B·H, S, D), contiguous."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def flash_attention_op(q, k, v, *, causal=True, window=0):
    """Model layout: q (B,S,H,D), k/v (B,S,K,D). Returns (B,S,H,D)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    o = _flash.flash_attention(_heads_major(q), _heads_major(k),
                               _heads_major(v), causal=causal, window=window,
                               group=h // kh)
    return o.reshape(b, h, s, d).transpose(1, 2)


def paged_decode_attention_op(q, k_pages, v_pages, block_tables, pos):
    """Model layout: q (B,1,H,D), pages (P,ps,K,D), block_tables (B,n_b)
    int32 physical pages, pos (B,) int32. Returns (B,1,H,D)."""
    b, _, h, d = q.shape
    kh = k_pages.shape[2]
    qr = q.reshape(b, kh, h // kh, d)
    o = _paged.paged_decode_attention(qr, k_pages, v_pages, block_tables, pos)
    return o.reshape(b, 1, h, d)


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
