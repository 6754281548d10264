"""Flash attention for prefill: the wrapper of the CUDA kernel
``flash_attention_fwd`` (``csrc/attention.cu``), its launch counter and its
plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:77``
(``flash_attention``). Layout as there: q (BH, Sq, D), k/v (BH/group, Sk,
D), kv head = bh // group; softmax scale D^-0.5 applied inside; query row
i sits at position ``q_offset + i`` among the keys and key row j at j (the
JAX ``flash_ref_attention``'s ``q_offset``: a chunk of a prompt attends
the rows cached before it; 0 for a whole prompt, as the TPU kernel
takes it). Unlike the TPU kernel it masks ragged tails, so any Sq and Sk
work. In bf16 the kernel computes both products on the
tensor cores (wgmma, fp32 accumulators, probabilities rounded to bf16),
with K/V tiles brought by TMA; in fp32 it runs its CUDA-core body. Bound on
the card: operations (see the source's header note for what the design
does about it).

Its gradient: where grad mode is on and q, k or v requires grad,
:func:`flash_attention` runs as a ``torch.autograd.Function`` whose
forward is the kernel above (or the plain version, for CPU tensors) and
whose backward is :func:`flash_attention_bwd`: the hand-written kernel
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``; fp32, D = 64,
128 and 256, ``q_offset`` 0) for CUDA tensors, the plain backward
``ref.flash_attention_bwd_ref`` for CPU tensors. It replaces no TPU
kernel: the JAX package takes attention's gradient through XLA. On the
card a bf16 input (ROADMAP §2 R18), another head dim or a query offset
that needs a gradient raises ``ValueError`` at the forward, so no result
is ever cut off from the graph.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import ref

#: kernel launches since the counter was last reset (plain integer)
launches = 0
#: backward launches (one a backward call: its pre-pass, dK/dV and dQ
#: kernels) since the counter was last reset
bwd_launches = 0

#: the plain version: the XLA-path math on the kernel layout (ref.py)
flash_attention_plain = ref.flash_attention_ref
#: the plain backward: its gradient written out (ref.py)
flash_attention_bwd_plain = ref.flash_attention_bwd_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    group: int = 1, q_offset: int = 0):
    """q: (BH, Sq, D); k, v: (BH/group, Sk, D); query row i at position
    ``q_offset + i``. Returns (BH, Sq, D).

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Where grad mode is on and an input requires grad, the call goes
    through :class:`FlashAttention` (the module docstring)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset:
            raise ValueError(f"flash_attention: no gradient at q_offset "
                             f"{q_offset} (the backward takes 0)")
        if q.is_cuda and q.dtype != torch.float32:
            raise ValueError(
                f"flash_attention: the backward on the card takes float32, "
                f"got {q.dtype} (bf16: ROADMAP §2 R18)")
        if q.is_cuda and q.shape[-1] not in build.BWD_HEAD_DIMS:
            raise ValueError(
                f"flash_attention: the backward on the card takes head dims "
                f"{build.BWD_HEAD_DIMS}, got {q.shape[-1]}")
        return FlashAttention.apply(q, k, v, causal, window, group)
    return _forward(q, k, v, causal=causal, window=window, group=group,
                    q_offset=q_offset)


class FlashAttention(torch.autograd.Function):
    """Kernel 1 with its gradient: forward :func:`_forward`, backward
    :func:`flash_attention_bwd` (the output's gradient made contiguous),
    q_offset 0. Saves q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, group):
        o = _forward(q, k, v, causal=causal, window=window, group=group)
        ctx.save_for_backward(q, k, v, o)
        ctx.mask = (causal, window, group)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        causal, window, group = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         causal=causal, window=window,
                                         group=group)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        window: int = 0, group: int = 1):
    """The gradient of :func:`flash_attention` at q_offset 0: q, o, do
    (BH, Sq, D); k, v (BH/group, Sk, D). Returns (dq, dk, dv) in the
    inputs' shapes.

    CUDA tensors launch ``flash_attention_bwd`` (float32, D = 64, 128 or
    256); CPU tensors run the plain backward; meta tensors get empty
    gradients."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("flash_attention_bwd", lambda: (
                cost.flash_bwd_price(q, k, causal, window, group))):
            return _backward(q, k, v, o, do, causal=causal, window=window,
                             group=group)
    return _backward(q, k, v, o, do, causal=causal, window=window,
                     group=group)


def _backward(q, k, v, o, do, *, causal, window, group):
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         window=window, group=group)
    build.check_inputs("flash_attention_bwd", (q, k, v, o, do),
                       head_dims=build.BWD_HEAD_DIMS)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: float32 only, got {q.dtype} "
                         "(bf16: ROADMAP §2 R18)")
    if (k.shape != v.shape or k.shape[0] * group != bh or k.shape[2] != d
            or o.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}, "
                         f"group {group}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if q.is_meta:
        return dq, dk, dv
    work = torch.empty(2, bh, sq, dtype=torch.float32, device=q.device)
    rc = build.library().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        work[0].data_ptr(), work[1].data_ptr(), bh, sq, sk, d, group,
        int(causal), int(window), 0, build.DTYPE_CODES["torch.float32"],
        build.stream_of(q))
    build.check(rc, "flash_attention_bwd")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


def _forward(q, k, v, *, causal: bool = True, window: int = 0,
             group: int = 1, q_offset: int = 0):
    """Kernel 1's forward: the kernel for CUDA tensors, the plain version
    for CPU tensors, an empty output for meta tensors (no autograd of its
    own)."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("flash_attention", lambda: cost.flash_price(
                q, k, causal, window, group, q_offset)):
            return _dispatch(q, k, v, causal=causal, window=window,
                             group=group, q_offset=q_offset)
    return _dispatch(q, k, v, causal=causal, window=window, group=group,
                     q_offset=q_offset)


def _dispatch(q, k, v, *, causal, window, group, q_offset):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     group=group, q_offset=q_offset)
    bh, sq, d = q.shape
    sk = k.shape[1]
    code = build.check_inputs("flash_attention", (q, k, v))
    if code == build.DTYPE_CODES["torch.bfloat16"]:
        build.check_aligned("flash_attention", (q, k, v))
    if (k.shape != v.shape or k.shape[0] * group != bh
            or k.shape[2] != d or q_offset < 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"group {group}, q_offset {q_offset}")
    out = torch.empty_like(q)
    if out.numel() == 0 or q.is_meta:
        return out
    rc = build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, sq, sk, d, group, int(causal), int(window), int(q_offset), code,
        build.stream_of(q))
    build.check(rc, "flash_attention")
    global launches
    launches += 1
    return out
