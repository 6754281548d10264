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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

#: kernel launches since the counter was last reset (plain integer)
launches = 0

#: the plain version: the XLA-path math on the kernel layout (ref.py)
flash_attention_plain = ref.flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    group: int = 1, q_offset: int = 0):
    """q: (BH, Sq, D); k, v: (BH/group, Sk, D); query row i at position
    ``q_offset + i``. Returns (BH, Sq, D).

    CUDA tensors launch the kernel; CPU tensors run the plain version."""
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
    if out.numel() == 0:
        return out
    rc = build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, sq, sk, d, group, int(causal), int(window), int(q_offset), code,
        build.stream_of(q))
    build.check(rc, "flash_attention")
    global launches
    launches += 1
    return out
