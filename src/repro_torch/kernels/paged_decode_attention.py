"""Block-paged single-token GQA decode attention: the wrapper of the CUDA
kernel ``paged_decode_fwd`` (``csrc/attention.cu``), its launch counter and
its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/paged_decode_attention.py:73``
(``paged_decode_attention``). The KV cache lives in a shared page pool
``(P+1, ps, K, D)`` (the last page is a write-off trash page); each slot
owns the pages its row of ``block_tables`` (B, n_b) names, and page ``i``
covers absolute positions ``[i·ps, (i+1)·ps)``. A slot attends positions
``<= pos``; any ``n_b`` works (the engine buckets it to powers of two).

Inactive slots (``pos < 0``): the kernel returns zeros, as the TPU kernel
does; the plain version follows the XLA reference ``paged_decode_ref`` and
returns the mean of V. Compare the two on active slots only. Bound on the
card: bytes (see the source's header note). Built for head dim 128 only
(``build.PAGED_HEAD_DIMS``): the paged path serves D = 128 models.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

#: kernel launches since the counter was last reset (plain integer)
launches = 0

#: the plain version: ``paged_decode_ref`` on the kernel layout (ref.py)
paged_decode_attention_plain = ref.paged_decode_attention_ref


def _check_decode(name, q, k_pages, v_pages, block_tables, pos):
    """Shapes of the decode operands (shared with the fused kernel)."""
    b, kh, g, d = q.shape
    if (k_pages.shape != v_pages.shape or k_pages.dim() != 4
            or k_pages.shape[2:] != (kh, d)
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or tuple(pos.shape) != (b,)):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, pages {tuple(k_pages.shape)}/"
            f"{tuple(v_pages.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, pos {tuple(pos.shape)}")


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos):
    """q: (B, K, G, D); pages: (P+1, ps, K, D); block_tables: (B, n_b)
    int32, every entry a valid page; pos: (B,) int32 (−1 = inactive).
    Returns (B, K, G, D).

    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, pos)
    code = build.check_inputs("paged_decode_attention", (q, k_pages, v_pages),
                              (block_tables, pos),
                              head_dims=build.PAGED_HEAD_DIMS)
    _check_decode("paged_decode_attention", q, k_pages, v_pages,
                  block_tables, pos)
    b, kh, g, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = build.library().paged_decode_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, kh, g, d, k_pages.shape[1], block_tables.shape[1], code,
        build.stream_of(q))
    build.check(rc, "paged_decode_attention")
    global launches
    launches += 1
    return out
