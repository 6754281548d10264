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
with K/V tiles brought by TMA; in fp32 it runs its register-tiled body on
the CUDA cores (fp32 FMAs, K/V tiles through cp.async). Bound on the card:
operations (see the source's header note for what the design does about
it).

Its gradient: where grad mode is on and q, k or v requires grad,
:func:`flash_attention` runs as a ``torch.autograd.Function`` whose
forward is the kernel above (on the card ``flash_attention_fwd_lse``, the
same body that also keeps each row's log-sum-exp; the plain version for
CPU tensors) and whose backward is :func:`flash_attention_bwd`: for CUDA
tensors the hand-written kernels ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``; fp32, register-tiled on the CUDA cores,
a key tile's dK/dV items shared over CTAs by :func:`bwd_split`) and
``flash_attention_bwd_tc`` (``csrc/flash_attention_bwd_tc.cu``; bf16, on
the tensor cores), both reading the forward's log-sum-exp, D = 64, 128
and 256, ``q_offset`` 0; the plain backward
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
from repro_torch.kernels import geometry
from repro_torch.kernels import ref

#: kernel launches since the counter was last reset (plain integer)
launches = 0
#: backward launches (one a backward call: its delta pass, its dK/dV and
#: dQ items, and the split's sum) since the counter was last reset
bwd_launches = 0

#: the plain version: the XLA-path math on the kernel layout (ref.py)
flash_attention_plain = ref.flash_attention_ref
#: the plain backward: its gradient written out (ref.py)
flash_attention_bwd_plain = ref.flash_attention_bwd_ref
#: the plain log2-sum-exp2 that the training forward writes (ref.py)
flash_lse_plain = ref.flash_lse_ref

#: query rows and keys per tile of the bf16 backward
#: (``csrc/flash_attention_bwd_tc.cu``); the fp32 backward's are
#: ``geometry.rt_bwd_tile(d)``
BWD_TILE = 64


def bwd_split(sq: int, sk: int, group: int, n_kvh: int, causal: bool,
              window: int, slots: int, tile: int = BWD_TILE) -> int:
    """CTAs a backward's dK/dV pass splits each key tile's items over, for
    ``tile`` query rows and keys a tile (the bf16 body's BWD_TILE, the
    fp32 body's ``geometry.rt_bwd_tile``): its (query head, query tile)
    pairs that the mask keeps, G x the query tiles meeting it (those the
    kernels' dK/dV items walk). The pass takes as long as its longest CTA,
    so a key tile with many items (the first of a causal prompt, any
    inside a long window) is shared out: the heaviest tile's items over
    the mean a CTA slot gets (``slots``: the card's SMs times the CTAs one
    SM holds), rounded, at most 8; but a tile of at most 8 items is not
    split, since its fp32 partials' round trip through memory costs more
    than it saves (on an H100 in bf16, read across splits 1-16: S 128 best
    unsplit, S 2048 at 2, Granite's D = 64 at 3-4, RecurrentGemma's window
    at 4; the fp32 body's sweep is chip_smoke.py's, PERF.md). The partials
    are summed in share order, so the split changes no bit from run to
    run."""
    n_qt, n_kt = -(-sq // tile), -(-sk // tile)
    loads = []
    for kt in range(n_kt):
        k0 = kt * tile
        k1 = min(k0 + tile, sk) - 1
        lo = (kt if sq > k0 else n_qt) if causal else 0
        hi = (min(n_qt - 1, (k1 + window - 1) // tile) if window > 0
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
    """Kernel 1 with its gradient: forward :func:`_forward` (on the card
    :func:`_forward_lse`, which also keeps each row's log-sum-exp, in
    either dtype), backward :func:`flash_attention_bwd` (the output's
    gradient made contiguous), q_offset 0. Saves q, k, v, the output and
    the log-sum-exp where there is one."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, group):
        lse = None
        if q.is_cuda:
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
    log2-sum-exp2 as the training forward (:func:`_forward_lse`) wrote
    it, or None (on the card that forward then runs for it, in either
    dtype; the plain backward recomputes it). Returns (dq, dk, dv) in the
    inputs' shapes.

    CUDA tensors launch ``flash_attention_bwd`` (float32) or
    ``flash_attention_bwd_tc`` (bfloat16), D = 64, 128 or 256, each with
    its dK/dV pass split by :func:`bwd_split`; CPU tensors run the plain
    backward; meta tensors get empty gradients."""
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
    build.check_aligned("flash_attention_bwd", (q, k, v, o, do))
    if lse is None:
        lse = _dispatch_lse(q, k, v, causal, window, group)[1]
    build.check_inputs("flash_attention_bwd", (q,), fp32=(lse,),
                       head_dims=build.BWD_HEAD_DIMS)
    if tuple(lse.shape) != (bh, sq):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)}, "
                         f"want {(bh, sq)}")
    bf16 = code == build.DTYPE_CODES["torch.bfloat16"]
    delta = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    # the fp32 body and the bf16 body at D = 256 hold one CTA an SM
    split = bwd_split(sq, sk, group, bh // group, causal, window,
                      decode_attention.sm_count(q.device.index)
                      * (2 if bf16 and d != 256 else 1),
                      BWD_TILE if bf16 else geometry.rt_bwd_tile(d))
    part = (None if split == 1 else
            torch.empty(2, split, bh // group, sk, d, dtype=torch.float32,
                        device=q.device))
    entry = (build.library().flash_attention_bwd_tc if bf16
             else build.library().flash_attention_bwd)
    rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               lse.data_ptr(), delta.data_ptr(),
               None if part is None else part.data_ptr(), bh, sq, sk, d,
               group, int(causal), int(window), split, build.stream_of(q))
    build.check(rc, "flash_attention_bwd")
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


def _forward_lse(q, k, v, *, causal: bool, window: int, group: int):
    """Kernel 1's forward on the card as the training path runs it
    (``flash_attention_fwd_lse``, fp32 or bf16): the output, bit for bit
    the serving forward's, and each query row's log2-sum-exp2 of its
    scaled logits (BH, Sq) fp32 for the backward."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("flash_attention", lambda: cost.flash_price(
                q, k, causal, window, group)):
            return _dispatch_lse(q, k, v, causal, window, group)
    return _dispatch_lse(q, k, v, causal, window, group)


def _dispatch_lse(q, k, v, causal, window, group):
    """The launch of ``flash_attention_fwd_lse`` on CUDA tensors of either
    dtype (the fp32 body ``flash_rt_item`` or the bf16 ``flash_tc_item``,
    each in an instance that also stores the log-sum-exp), D = 64, 128 or
    256: (out, lse)."""
    code = build.check_inputs("flash_attention", (q, k, v),
                              head_dims=build.BWD_HEAD_DIMS)
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
        int(window), code, build.stream_of(q))
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
