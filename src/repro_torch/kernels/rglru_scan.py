"""RG-LRU linear recurrence: the wrapper of the CUDA kernel ``rglru_scan_fwd``
(``csrc/rglru_scan.cu``), its launch counter and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rglru_scan.py:37``
(``rglru_scan``): per channel, ``h_t = a_t * h_{t-1} + b_t`` along the
sequence with the state in fp32, ``y_t = h_t`` in the inputs' dtype. The
kernel also writes the final state ``h_T`` in fp32 from the register that
carried it, where the TPU op took ``y[:, -1]`` (rounded to y's dtype); the
model's RG-LRU cache keeps that fp32 state. It takes any B, S and W. Bound
on the card: bytes (see the source's header note).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

#: kernel launches since the counter was last reset (plain integer)
launches = 0


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

    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    build.refuse_grad("rglru_scan", (a, b, h0), "ROADMAP §1 item 8b")
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
