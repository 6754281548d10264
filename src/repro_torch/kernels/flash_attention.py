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
whose backward is :func:`flash_attention_bwd`: for CUDA tensors the
hand-written kernels ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``;
fp32, on the CUDA cores) and ``flash_attention_bwd_tc``
(``csrc/flash_attention_bwd_tc.cu``; bf16, on the tensor cores, reading
each row's log-sum-exp from the forward, which on the card in bf16 is
``flash_attention_fwd_lse``), D = 64, 128 and 256, ``q_offset`` 0; the
plain backward
``ref.flash_attention_bwd_ref`` for CPU tensors. It replaces no TPU
kernel: the JAX package takes attention's gradient through XLA. On the
card another head dim or a query offset that needs a gradient raises
``ValueError`` at the forward, so no result is ever cut off from the
graph.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention
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
#: the plain log2-sum-exp2 that the bf16 training forward writes (ref.py)
flash_lse_plain = ref.flash_lse_ref

#: query rows and keys per tile of the bf16 backward
#: (``csrc/flash_attention_bwd_tc.cu``)
BWD_TILE = 64


def bwd_split(sq: int, sk: int, group: int, n_kvh: int, causal: bool,
              window: int, slots: int) -> int:
    """CTAs the bf16 backward's dK/dV pass splits each key tile's items
    over: its (query head, query tile) pairs that the mask keeps, G x the
    query tiles meeting it (the kernel's ``tiles_meet``). The pass takes
    as long as its longest CTA, so a key tile with many items (the first
    of a causal prompt, any inside a long window) is shared out: the
    heaviest tile's items over the mean a CTA slot gets (``slots``: the
    card's SMs times the CTAs one SM holds), rounded, at most 8; but a
    tile of at most 8 items is not split, since its fp32 partials' round
    trip through memory costs more than it saves (on an H100, read across
    splits 1-16: S 128 best unsplit, S 2048 at 2, Granite's D = 64 at 3-4,
    RecurrentGemma's window at 4). The partials are summed in share order,
    so the split changes no bit from run to run."""
    n_qt, n_kt = -(-sq // BWD_TILE), -(-sk // BWD_TILE)
    loads = []
    for kt in range(n_kt):
        k0 = kt * BWD_TILE
        k1 = min(k0 + BWD_TILE, sk) - 1
        lo = (kt if sq > k0 else n_qt) if causal else 0
        hi = (min(n_qt - 1, (k1 + window - 1) // BWD_TILE) if window > 0
              else n_qt - 1)
        loads.append(group * max(0, hi - lo + 1))
    peak = max(loads)
    if peak <= 8:
        return 1
    mean = n_kvh * sum(loads) / slots
    return max(1, min(8, round(peak / max(mean, 1.0))))


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
        if q.is_cuda and q.shape[-1] not in build.BWD_HEAD_DIMS:
            raise ValueError(
                f"flash_attention: the backward on the card takes head dims "
                f"{build.BWD_HEAD_DIMS}, got {q.shape[-1]}")
        return FlashAttention.apply(q, k, v, causal, window, group)
    return _forward(q, k, v, causal=causal, window=window, group=group,
                    q_offset=q_offset)


class FlashAttention(torch.autograd.Function):
    """Kernel 1 with its gradient: forward :func:`_forward` (on the card in
    bf16 :func:`_forward_lse`, which also keeps each row's log-sum-exp),
    backward :func:`flash_attention_bwd` (the output's gradient made
    contiguous), q_offset 0. Saves q, k, v, the output and the
    log-sum-exp where there is one."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, group):
        lse = None
        if q.is_cuda and q.dtype == torch.bfloat16:
            o, lse = _forward_lse(q, k, v, causal=causal, window=window,
                                  group=group)
        else:
            o = _forward(q, k, v, causal=causal, window=window, group=group)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, group)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, group = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         causal=causal, window=window,
                                         group=group, lse=lse)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        window: int = 0, group: int = 1, lse=None):
    """The gradient of :func:`flash_attention` at q_offset 0: q, o, do
    (BH, Sq, D); k, v (BH/group, Sk, D); ``lse`` (BH, Sq) fp32, each row's
    log2-sum-exp2 as the bf16 training forward (:func:`_forward_lse`)
    wrote it, or None (the bf16 kernel then runs that forward for it; the
    fp32 kernel and the plain backward recompute it). Returns (dq, dk, dv)
    in the inputs' shapes.

    CUDA tensors launch ``flash_attention_bwd`` (float32) or
    ``flash_attention_bwd_tc`` (bfloat16), D = 64, 128 or 256; CPU tensors
    run the plain backward; meta tensors get empty gradients."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("flash_attention_bwd", lambda: (
                cost.flash_bwd_price(q, k, causal, window, group))):
            return _backward(q, k, v, o, do, causal=causal, window=window,
                             group=group, lse=lse)
    return _backward(q, k, v, o, do, causal=causal, window=window,
                     group=group, lse=lse)


def _backward(q, k, v, o, do, *, causal, window, group, lse=None):
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         window=window, group=group)
    code = build.check_inputs("flash_attention_bwd", (q, k, v, o, do),
                              head_dims=build.BWD_HEAD_DIMS)
    bh, sq, d = q.shape
    sk = k.shape[1]
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
    if code == build.DTYPE_CODES["torch.bfloat16"]:
        build.check_aligned("flash_attention_bwd", (q, k, v, o, do))
        if lse is None:
            lse = _dispatch_lse(q, k, v, causal, window, group)[1]
        build.check_inputs("flash_attention_bwd", (q,), fp32=(lse,),
                           head_dims=build.BWD_HEAD_DIMS)
        if tuple(lse.shape) != (bh, sq):
            raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)}"
                             f", want {(bh, sq)}")
        delta = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
        split = bwd_split(sq, sk, group, bh // group, causal, window,
                          decode_attention.sm_count(q.device.index)
                          * (1 if d == 256 else 2))
        part = (None if split == 1 else
                torch.empty(2, split, bh // group, sk, d,
                            dtype=torch.float32, device=q.device))
        rc = build.library().flash_attention_bwd_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if part is None else part.data_ptr(), bh, sq, sk, d,
            group, int(causal), int(window), split, build.stream_of(q))
    else:
        work = torch.empty(2, bh, sq, dtype=torch.float32, device=q.device)
        rc = build.library().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            work[0].data_ptr(), work[1].data_ptr(), bh, sq, sk, d, group,
            int(causal), int(window), 0, code, build.stream_of(q))
    build.check(rc, "flash_attention_bwd")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


def _forward_lse(q, k, v, *, causal: bool, window: int, group: int):
    """Kernel 1's bf16 forward on the card as the training path runs it
    (``flash_attention_fwd_lse``): the output, and each query row's
    log2-sum-exp2 of its scaled logits (BH, Sq) fp32 for the backward."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("flash_attention", lambda: cost.flash_price(
                q, k, causal, window, group)):
            return _dispatch_lse(q, k, v, causal, window, group)
    return _dispatch_lse(q, k, v, causal, window, group)


def _dispatch_lse(q, k, v, causal, window, group):
    code = build.check_inputs("flash_attention", (q, k, v),
                              head_dims=build.BWD_HEAD_DIMS)
    if code != build.DTYPE_CODES["torch.bfloat16"]:
        raise ValueError(f"flash_attention: the log-sum-exp forward takes "
                         f"bfloat16, got {q.dtype}")
    build.check_aligned("flash_attention", (q, k, v))
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] * group != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"group {group}")
    out = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    rc = build.library().flash_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, sq, k.shape[1], d, group, int(causal),
        int(window), build.stream_of(q))
    build.check(rc, "flash_attention")
    global launches
    launches += 1
    return out, lse


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
