"""Mamba-2 SSD chunk scan: the wrapper of the CUDA kernel ``ssd_scan_fwd``
(``csrc/ssd_scan.cu``), its launch counter and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:66`` (``ssd_scan``).
Per (batch row, head) the scan walks the chunks in order, carrying the
recurrent state (P×N, fp32); per chunk, with ``cum`` the within-chunk
cumulative log decay:

    y_intra = (C Bᵀ ⊙ L) xw,          L_ij = e^{cum_i − cum_j} for j <= i
    y_inter = (C ⊙ e^{cum}) state
    state   = e^{cum_last} state + Bᵀ (xw ⊙ e^{cum_last − cum})

The scan starts from ``state0`` (B, H, P, N) fp32 where one is given (a
chunk of a prompt continues from the state the chunks before it left:
chunked prefill), else from zeros, as the TPU kernel always does. The
kernel writes ``y`` and the final state (from shared memory), where the
TPU kernel left its state in scratch and ``ops.ssd_scan_op`` recovered it
analytically. It takes a chunk of up to 256 rows and a state of up to 128;
P and H are free. Bound on the card: bytes, narrowly over operations.

The dtype picks the body. fp32 runs the first body, on the CUDA cores. bf16
makes three CUDA launches behind the one C entry, every product on the
tensor cores: C Bᵀ once per row and chunk and each chunk's own state
(into workspaces this wrapper allocates), a pass over the chunks, then
every chunk's outputs at once; ``kernels/ref.py``'s ``ssd_scan_tc_ref``
states its roundings plainly. ``launches`` counts one per call either
way.

Its gradient: where grad mode is on and an input requires grad,
:func:`ssd_scan` runs as :class:`SsdScan`, whose forward is the kernel
above (or the plain version, for CPU tensors) and whose backward is
:func:`ssd_scan_bwd`: for CUDA tensors the hand-written kernels behind
``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``; fp32, on the CUDA cores) and
``ssd_scan_bwd_tc`` (``csrc/ssd_scan_bwd_tc.cu``; bf16, on the tensor
cores: C Bᵀ once per (row, chunk, tile pair), a CTA walking a group of
heads over it), P up to 64; the plain backward ``ref.ssd_scan_bwd_ref``
for CPU tensors. It replaces no TPU kernel: the JAX package takes the
scan's gradient through XLA.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention
from repro_torch.kernels import ref
from repro_torch.kernels.geometry import SSD_P_SLICES, SSD_TILE

#: kernel launches since the counter was last reset (plain integer)
launches = 0
#: backward launches (one a backward call: its four kernels) since the
#: counter was last reset
bwd_launches = 0

#: the largest chunk and state size the kernel's shared buffers hold
MAX_CHUNK, MAX_STATE = 256, 128
#: the largest head dim P the backward's shared buffers hold
MAX_BWD_P = 64

#: the plain backward: the gradient written out (ref.py)
ssd_scan_bwd_plain = ref.ssd_scan_bwd_ref
#: rows of a chunk per tile of the bf16 backward (``csrc/ssd_scan_bwd_tc.cu``)
BWD_TILE = 64


def bwd_heads_a_group(ctas: int, h: int, sms: int) -> int:
    """Heads one CTA of the bf16 backward's tile kernel walks: ``ctas``
    CTAs a head group (batch rows × chunks × row tiles × 2 roles), enough
    groups for four CTAs an SM on ``sms`` SMs where the heads allow, the
    heads split evenly over them."""
    groups = min(h, max(1, -(-4 * sms // max(ctas, 1))))
    return -(-h // groups)


def ssd_scan_plain(xw, cum, B_, C, state0=None):
    """The chunk scan in plain PyTorch: the TPU kernel's per-chunk algebra,
    looped over the chunks, in fp32, from ``state0`` (zeros without it).
    Same contract as :func:`ssd_scan`."""
    b, nc, q, h, p = xw.shape
    n = B_.shape[-1]
    causal = torch.ones(q, q, dtype=torch.bool, device=xw.device).tril()
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=xw.device)
             if state0 is None else state0.float())
    ys = []
    for ci in range(nc):
        x_c = xw[:, ci].float()                             # (B,Q,H,P)
        cum_c = cum[:, ci].float()                          # (B,Q,H)
        b_c, c_c = B_[:, ci].float(), C[:, ci].float()      # (B,Q,N)
        seg = cum_c[:, :, None, :] - cum_c[:, None, :, :]   # (B,Q,Q,H)
        L = torch.exp(torch.where(causal[None, :, :, None], seg,
                                  float("-inf")))
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)         # (B,Q,Q)
        y_intra = torch.einsum("bij,bijh,bjhp->bihp", cb, L, x_c)
        y_inter = torch.einsum("bin,bih,bhpn->bihp", c_c, torch.exp(cum_c),
                               state)
        d_end = torch.exp(cum_c[:, -1:, :] - cum_c)         # (B,Q,H)
        state = (state * torch.exp(cum_c[:, -1, :])[..., None, None]
                 + torch.einsum("bjn,bjh,bjhp->bhpn", b_c, d_end, x_c))
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).to(xw.dtype), state


def ssd_scan(xw, cum, B_, C, state0=None, *, p_slice: int = 0):
    """xw: (B, NC, Q, H, P) dt-scaled inputs per chunk; cum: (B, NC, Q, H)
    fp32 within-chunk cumulative log decay; B_, C: (B, NC, Q, N) in xw's
    dtype; state0: (B, H, P, N) fp32, the state entering the first chunk,
    or None for zeros. Returns (y (B, NC, Q, H, P) in xw's dtype, final
    state (B, H, P, N) fp32).

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    ``p_slice`` (bf16 only) names the columns of P per CTA of the output
    kernel, one of ``geometry.SSD_P_SLICES``; 0 takes the build's
    ``SSD_P_SLICE``.

    Where grad mode is on and an input requires grad, the call goes
    through :class:`SsdScan` (the module docstring)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xw, cum, B_, C, state0)):
        return SsdScan.apply(xw, cum, B_, C, state0, p_slice)
    return _forward(xw, cum, B_, C, state0, p_slice=p_slice)


class SsdScan(torch.autograd.Function):
    """Kernel 6 with its gradient: forward :func:`_forward`, backward
    :func:`ssd_scan_bwd` (the outputs' gradients made contiguous). Saves
    the inputs; the backward recomputes the states entering the chunks."""

    @staticmethod
    def forward(ctx, xw, cum, B_, C, state0, p_slice):
        y, state = _forward(xw, cum, B_, C, state0, p_slice=p_slice)
        ctx.save_for_backward(xw, cum, B_, C, state0)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        xw, cum, B_, C, state0 = ctx.saved_tensors
        dxw, dcum, dB, dC, dstate0 = ssd_scan_bwd(
            xw, cum, B_, C, state0, dy.contiguous(), dstate.contiguous())
        return (dxw.to(xw.dtype), dcum, dB.to(B_.dtype), dC.to(C.dtype),
                dstate0, None)


def ssd_scan_bwd(xw, cum, B_, C, state0, dy, dstate):
    """The gradient of :func:`ssd_scan`: its inputs, dy (B, NC, Q, H, P)
    and dstate (B, H, P, N) or None (zeros). Returns (dxw, dcum, dB, dC,
    dstate0) fp32, dstate0 None without ``state0``.

    CUDA tensors launch ``ssd_scan_bwd`` (float32, Q <= 256, N <= 128, P
    <= 64); CPU tensors run the plain backward; meta tensors get empty
    gradients."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("ssd_scan_bwd", lambda: (
                cost.ssd_bwd_price(xw, B_, state0))):
            return _backward(xw, cum, B_, C, state0, dy, dstate)
    return _backward(xw, cum, B_, C, state0, dy, dstate)


def _backward(xw, cum, B_, C, state0, dy, dstate):
    if xw.device.type == "cpu":
        return ssd_scan_bwd_plain(xw, cum, B_, C, state0, dy, dstate)
    fp32 = tuple(t for t in (cum, state0, dstate) if t is not None)
    code = build.check_inputs("ssd_scan_bwd", (xw, B_, C, dy), fp32=fp32,
                              head_dim=False)
    b, nc, q, h, p = xw.shape
    n = B_.shape[-1]
    if (tuple(cum.shape) != (b, nc, q, h) or B_.shape != C.shape
            or tuple(B_.shape) != (b, nc, q, n) or dy.shape != xw.shape
            or any(tuple(t.shape) != (b, h, p, n)
                   for t in (state0, dstate) if t is not None)):
        raise ValueError(f"ssd_scan_bwd: xw {tuple(xw.shape)}, cum "
                         f"{tuple(cum.shape)}, B {tuple(B_.shape)}, C "
                         f"{tuple(C.shape)}, dy {tuple(dy.shape)}")
    if q > MAX_CHUNK or n > MAX_STATE or p > MAX_BWD_P:
        raise ValueError(f"ssd_scan_bwd: chunk {q} (at most {MAX_CHUNK}), "
                         f"state {n} (at most {MAX_STATE}) and head dim {p} "
                         f"(at most {MAX_BWD_P})")
    tc = code == build.DTYPE_CODES["torch.bfloat16"]
    if tc and (n % 8 or p % 8):
        raise ValueError(f"ssd_scan_bwd: in bfloat16 the state {n} and the "
                         f"head dim {p} must be multiples of 8")
    dxw = torch.empty_like(xw)
    dcum = torch.empty_like(cum)
    dB = torch.empty_like(B_)
    dC = torch.empty_like(C)
    dstate0 = None if state0 is None else torch.empty_like(state0)
    if xw.is_meta:
        return dxw, dcum, dB, dC, dstate0
    if dxw.numel() == 0 or dB.numel() == 0:
        for t in (dxw, dcum, dB, dC):
            t.zero_()
        if dstate0 is not None:
            dstate0.copy_(torch.zeros_like(state0) if dstate is None
                          else dstate)
        return dxw, dcum, dB, dC, dstate0
    f32 = dict(dtype=torch.float32, device=xw.device)
    # the states entering every chunk and the last (S), the gradient of
    # the state each chunk leaves (G), the two halves of cum's gradient
    states = torch.empty(b, nc + 1, h, p, n, **f32)
    grads = torch.empty(b, nc, h, p, n, **f32)
    dcum2 = torch.empty(2, b, nc, q, h, **f32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if tc:
        build.check_aligned("ssd_scan_bwd", (xw, B_, C, dy))
        nt = -(-q // BWD_TILE)
        hg = bwd_heads_a_group(b * nc * nt * 2, h,
                               decode_attention.sm_count(xw.device.index))
        groups = -(-h // hg)
        # C Bᵀ per (row, chunk) in whole tiles, B's and C's gradients per
        # head group
        cb = torch.empty(b, nc, nt * BWD_TILE, nt * BWD_TILE, **f32)
        dbg = torch.empty(b, nc, groups, q, n, **f32)
        dcg = torch.empty(b, nc, groups, q, n, **f32)
        rc = build.library().ssd_scan_bwd_tc(
            xw.data_ptr(), cum.data_ptr(), B_.data_ptr(), C.data_ptr(),
            ptr(state0), dy.data_ptr(), ptr(dstate), dxw.data_ptr(),
            dcum.data_ptr(), dB.data_ptr(), dC.data_ptr(), ptr(dstate0),
            states.data_ptr(), grads.data_ptr(), cb.data_ptr(),
            dbg.data_ptr(), dcg.data_ptr(), dcum2.data_ptr(), b, nc, q, h,
            p, n, hg, build.stream_of(xw))
    else:
        # B's and C's gradients per head
        dbh = torch.empty(b, nc, h, q, n, **f32)
        dch = torch.empty(b, nc, h, q, n, **f32)
        rc = build.library().ssd_scan_bwd(
            xw.data_ptr(), cum.data_ptr(), B_.data_ptr(), C.data_ptr(),
            ptr(state0), dy.data_ptr(), ptr(dstate), dxw.data_ptr(),
            dcum.data_ptr(), dB.data_ptr(), dC.data_ptr(), ptr(dstate0),
            states.data_ptr(), grads.data_ptr(), dbh.data_ptr(),
            dch.data_ptr(), dcum2.data_ptr(), b, nc, q, h, p, n,
            build.stream_of(xw))
    build.check(rc, "ssd_scan_bwd")
    global bwd_launches
    bwd_launches += 1
    return dxw, dcum, dB, dC, dstate0


def _forward(xw, cum, B_, C, state0=None, *, p_slice: int = 0):
    """Kernel 6's forward: the kernel for CUDA tensors, the plain version
    for CPU tensors, empty outputs for meta tensors (no autograd of its
    own)."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("ssd_scan", lambda: (
                cost.ssd_price(xw, B_, state0))):
            return _dispatch(xw, cum, B_, C, state0, p_slice)
    return _dispatch(xw, cum, B_, C, state0, p_slice)


def _dispatch(xw, cum, B_, C, state0, p_slice):
    if xw.device.type == "cpu":
        return ssd_scan_plain(xw, cum, B_, C, state0)
    fp32 = (cum,) if state0 is None else (cum, state0)
    code = build.check_inputs("ssd_scan", (xw, B_, C), fp32=fp32,
                              head_dim=False)
    b, nc, q, h, p = xw.shape
    n = B_.shape[-1]
    if (tuple(cum.shape) != (b, nc, q, h) or B_.shape != C.shape
            or tuple(B_.shape) != (b, nc, q, n)
            or (state0 is not None
                and tuple(state0.shape) != (b, h, p, n))):
        raise ValueError(f"ssd_scan: xw {tuple(xw.shape)}, cum "
                         f"{tuple(cum.shape)}, B {tuple(B_.shape)}, C "
                         f"{tuple(C.shape)}, state0 "
                         f"{None if state0 is None else tuple(state0.shape)}")
    if q > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {q} (at most {MAX_CHUNK}) and "
                         f"state {n} (at most {MAX_STATE})")
    if p_slice and p_slice not in SSD_P_SLICES:
        raise ValueError(f"ssd_scan: P slice {p_slice} not in "
                         f"{SSD_P_SLICES}")
    y = torch.empty_like(xw)
    state = torch.empty(b, h, p, n, dtype=torch.float32, device=xw.device)
    if xw.is_meta:
        return y, state
    if y.numel() == 0:
        return y, (state.zero_() if state0 is None
                   else state.copy_(state0))
    work = (None, None, None)
    if xw.dtype == torch.bfloat16:
        # C Bᵀ per row and chunk (each chunk's rows rounded up to a tile),
        # each chunk's own state (fp32) and the state entering it (bf16)
        qp = -(-q // SSD_TILE) * SSD_TILE
        work = (torch.empty(b, nc, qp, qp, dtype=torch.float32,
                            device=xw.device),
                torch.empty(b, nc, h, p, n, dtype=torch.float32,
                            device=xw.device),
                torch.empty(b, nc, h, p, n, dtype=torch.bfloat16,
                            device=xw.device))
    rc = build.library().ssd_scan_fwd(
        xw.data_ptr(), cum.data_ptr(), B_.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(),
        None if state0 is None else state0.data_ptr(),
        *(None if t is None else t.data_ptr() for t in work),
        b, nc, q, h, p, n, p_slice, code, build.stream_of(xw))
    build.check(rc, "ssd_scan")
    global launches
    launches += 1
    return y, state
