"""RG-LRU linear recurrence: the wrapper of the CUDA kernel ``rglru_scan_fwd``
(``csrc/rglru_scan.cu``), its launch counter and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rglru_scan.py:37``
(``rglru_scan``): per channel, ``h_t = a_t * h_{t-1} + b_t`` along the
sequence with the state in fp32, ``y_t = h_t`` in the inputs' dtype. The
kernel also writes the final state ``h_T`` in fp32 from the register that
carried it, where the TPU op took ``y[:, -1]`` (rounded to y's dtype); the
model's RG-LRU cache keeps that fp32 state. It takes any B, S and W. Bound
on the card: bytes (see the source's header note).

Its gradient: where grad mode is on and a, b or h0 requires grad,
:func:`rglru_scan` runs as :class:`RglruScan`, whose forward is the kernel
above (or the plain version, for CPU tensors) and whose backward is
:func:`rglru_scan_bwd`: the hand-written kernel ``rglru_scan_bwd``
(``csrc/rglru_scan.cu``; fp32) for CUDA tensors, the plain backward
``ref.rglru_scan_bwd_ref`` for CPU tensors. It replaces no TPU kernel:
the JAX package takes the recurrence's gradient through XLA. On the card a
bf16 input that needs a gradient raises ``ValueError`` at the forward
(ROADMAP §2 R18), so no result is ever cut off from the graph.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import ref

#: kernel launches since the counter was last reset (plain integer)
launches = 0
#: backward launches since the counter was last reset (plain integer)
bwd_launches = 0

#: the plain backward: the gradient written out (ref.py)
rglru_scan_bwd_plain = ref.rglru_scan_bwd_ref


def rglru_scan_plain(a, b, h0=None):
    """The recurrence in plain PyTorch, one step per position: the
    kernel's arithmetic (an fp32 multiply, then an add) in the same order.
    Same contract as :func:`rglru_scan`."""
    bsz, s, w = a.shape
    af, bf = a.float(), b.float()
    h = (torch.zeros(bsz, w, dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        h = af[:, t] * h + bf[:, t]
        ys.append(h)
    y = (torch.stack(ys, dim=1) if ys
         else torch.empty(bsz, 0, w, dtype=torch.float32, device=a.device))
    return y.to(a.dtype), h


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, W) of one dtype (fp32 or bf16); h0: (B, W) fp32 or None
    (zeros). Returns (y (B, S, W) in a's dtype, h_T (B, W) fp32).

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Where grad mode is on and an input requires grad, the call goes
    through :class:`RglruScan` (the module docstring)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        if a.is_cuda and a.dtype != torch.float32:
            raise ValueError(f"rglru_scan: the backward on the card takes "
                             f"float32, got {a.dtype} (bf16: ROADMAP §2 "
                             "R18)")
        return RglruScan.apply(a, b, h0)
    return _forward(a, b, h0)


class RglruScan(torch.autograd.Function):
    """Kernel 7 with its gradient: forward :func:`_forward`, backward
    :func:`rglru_scan_bwd` (the output's gradients made contiguous). Saves
    a, the output y (h_{t-1} for the backward) and h0."""

    @staticmethod
    def forward(ctx, a, b, h0):
        y, h_last = _forward(a, b, h0)
        ctx.save_for_backward(a, y, h0)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, y, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_bwd(a, y, h0, dy.contiguous(),
                                     dh_last.contiguous())
        return da.to(a.dtype), db.to(a.dtype), dh0


def rglru_scan_bwd(a, y, h0, dy, dh_last):
    """The gradient of :func:`rglru_scan`: a, y (its output), dy (B, S, W);
    h0, dh_last (B, W) or None (zeros). Returns (da, db, dh0) fp32, dh0
    None without h0.

    CUDA tensors launch ``rglru_scan_bwd`` (float32); CPU tensors run the
    plain backward; meta tensors get empty gradients."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("rglru_scan_bwd", lambda: (
                cost.rglru_bwd_price(a, h0))):
            return _backward(a, y, h0, dy, dh_last)
    return _backward(a, y, h0, dy, dh_last)


def _backward(a, y, h0, dy, dh_last):
    if a.device.type == "cpu":
        return rglru_scan_bwd_plain(a, y, h0, dy, dh_last)
    fp32 = tuple(t for t in (h0, dh_last) if t is not None)
    code = build.check_inputs("rglru_scan_bwd", (a, y, dy), fp32=fp32,
                              head_dim=False)
    if code != build.DTYPE_CODES["torch.float32"]:
        raise ValueError(f"rglru_scan_bwd: float32 only, got {a.dtype} "
                         "(bf16: ROADMAP §2 R18)")
    if (a.dim() != 3 or y.shape != a.shape or dy.shape != a.shape
            or any(tuple(t.shape) != (a.shape[0], a.shape[2])
                   for t in fp32)):
        raise ValueError(f"rglru_scan_bwd: a {tuple(a.shape)}, y "
                         f"{tuple(y.shape)}, dy {tuple(dy.shape)}, h0/dh_last "
                         f"{[tuple(t.shape) for t in fp32]}")
    bsz, s, w = a.shape
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if a.is_meta:
        return da, db, dh0
    if da.numel() == 0:
        if dh0 is not None:
            dh0.copy_(torch.zeros_like(h0) if dh_last is None else dh_last)
        return da, db, dh0
    rc = build.library().rglru_scan_bwd(
        a.data_ptr(), y.data_ptr(), None if h0 is None else h0.data_ptr(),
        dy.data_ptr(), None if dh_last is None else dh_last.data_ptr(),
        da.data_ptr(), db.data_ptr(), None if dh0 is None else dh0.data_ptr(),
        bsz, s, w, build.stream_of(a))
    build.check(rc, "rglru_scan_bwd")
    global bwd_launches
    bwd_launches += 1
    return da, db, dh0


def _forward(a, b, h0=None):
    """Kernel 7's forward: the kernel for CUDA tensors, the plain version
    for CPU tensors, empty outputs for meta tensors (no autograd of its
    own)."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("rglru_scan", lambda: (
                cost.rglru_price(a, h0))):
            return _dispatch(a, b, h0)
    return _dispatch(a, b, h0)


def _dispatch(a, b, h0):
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    code = build.check_inputs("rglru_scan", (a, b),
                              fp32=() if h0 is None else (h0,),
                              head_dim=False)
    if a.dim() != 3 or a.shape != b.shape or (
            h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2])):
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    bsz, s, w = a.shape
    y = torch.empty_like(a)
    h_last = torch.empty(bsz, w, dtype=torch.float32, device=a.device)
    if a.is_meta:
        return y, h_last
    if y.numel() == 0:
        return y, h_last.zero_() if h0 is None else h0.clone()
    rc = build.library().rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), bsz, s, w, code,
        build.stream_of(a))
    build.check(rc, "rglru_scan")
    global launches
    launches += 1
    return y, h_last
