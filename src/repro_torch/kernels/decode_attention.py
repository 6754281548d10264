"""Single-token GQA decode attention over a dense per-slot cache: the
wrapper of the CUDA kernel ``decode_attention_fwd`` (``csrc/attention.cu``),
its launch counter and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:62``
(``decode_attention``). Each slot owns a contiguous cache row ``(S, K, D)``
and ``kv_positions`` (B, S) gives the absolute position each row holds:
row ``j`` is attended when ``0 <= kv_positions[b, j] <= pos[b]``, so a ring
cache (positions in any order, holes of -1) is masked by position, not by
index. Any ``S`` works: the kernel masks the tail tile where the TPU
dispatcher only took ``S % 128 == 0``.

A slot with no attended row: the kernel returns zeros, as the TPU kernel
does; the plain version follows the XLA reference ``decode_attention``
and returns the mean of V. Compare the two on slots with an attended row.
Bound on the card: bytes (see the source's header note).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

#: kernel launches since the counter was last reset (plain integer)
launches = 0

#: the plain version: ``decode_attention`` on the kernel layout (ref.py)
decode_attention_plain = ref.decode_attention_ref


def _check_dense(name, q, k_cache, v_cache, kv_positions, pos):
    """Shapes of the dense decode operands (shared with the fused kernel)."""
    b, kh, g, d = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.dim() != 4
            or k_cache.shape[0] != b or k_cache.shape[2:] != (kh, d)
            or tuple(kv_positions.shape) != tuple(k_cache.shape[:2])
            or tuple(pos.shape) != (b,)):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, caches {tuple(k_cache.shape)}/"
            f"{tuple(v_cache.shape)}, kv_positions "
            f"{tuple(kv_positions.shape)}, pos {tuple(pos.shape)}")


def decode_attention(q, k_cache, v_cache, kv_positions, pos):
    """q: (B, K, G, D); caches: (B, S, K, D); kv_positions: (B, S) int32
    (-1 = empty); pos: (B,) int32. Returns (B, K, G, D).

    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_positions, pos)
    code = build.check_inputs("decode_attention", (q, k_cache, v_cache),
                              (kv_positions, pos))
    _check_dense("decode_attention", q, k_cache, v_cache, kv_positions, pos)
    b, kh, g, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = build.library().decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_positions.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, kh, g, d, k_cache.shape[1], code, build.stream_of(q))
    build.check(rc, "decode_attention")
    global launches
    launches += 1
    return out
