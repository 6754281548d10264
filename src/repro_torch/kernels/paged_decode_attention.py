"""Block-paged single-token GQA decode attention: the wrapper of the CUDA
kernel behind ``paged_decode_split_fwd`` (fp32 and bf16) in
``csrc/attention.cu``, its launch counter and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/paged_decode_attention.py:73``
(``paged_decode_attention``). The KV cache lives in a shared page pool
``(P+1, ps, K, D)`` (the last page is a write-off trash page); each slot
owns the pages its row of ``block_tables`` (B, n_b) names, and page ``i``
covers absolute positions ``[i·ps, (i+1)·ps)``. A slot attends positions
``<= pos``; any ``n_b`` works (the engine buckets it to powers of two).

In bf16 the kernel is the dense decode kernel's split body over the page
pool: the launch holds ``decode_attention.split_count`` pieces (from the
shapes alone) per (slot, kv head), one CTA each; a slot's own live rows,
in 64-row tiles, are split into ``geometry.slot_pieces`` of them (the
rest return at once), both products on the tensor cores (G <= 16 query
heads per kv head), the last piece to finish merging the partials in
piece order; the workspace comes from ``decode_attention.split_workspace``.
Where a slot's pieces fall depends on its own rows alone, so its result
is the same at every table width and beside any other slots. In fp32 it is
the dense kernel's fp32 split body over the page pool: the launch holds
``geometry.fp32_pieces(n_b·ps)`` pieces per (slot, kv head); a slot's own
live rows are cut into pieces of ``PIECE_ROWS`` rows (the rest return at
once), both products as fp32 FMAs on the CUDA cores, the last piece to
finish merging in piece order, so its result is the same at every table
width and beside any other slots too, and with linear positions equals
fp32 dense decode's bit for bit.

Inactive slots (``pos < 0``): the kernel returns zeros, as the TPU kernel
does; the plain version follows the XLA reference ``paged_decode_ref`` and
returns the mean of V. Compare the two on active slots only. Bound on the
card: bytes (see the source's header note). Built for head dims 64 and
128 (``build.PAGED_HEAD_DIMS``): the paged path serves Granite's D = 64 and
the D = 128 models.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import split_tile, split_workspace

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

    CUDA tensors launch the kernel; CPU tensors run the plain version;
    meta tensors get an empty output."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("paged_decode_attention", lambda: (
                cost.paged_price(q, pos, k_pages, block_tables))):
            return _dispatch(q, k_pages, v_pages, block_tables, pos)
    return _dispatch(q, k_pages, v_pages, block_tables, pos)


def _dispatch(q, k_pages, v_pages, block_tables, pos):
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, pos)
    build.refuse_grad("paged_decode_attention", (q, k_pages, v_pages),
                      "ROADMAP §2 R19")
    code = build.check_inputs("paged_decode_attention", (q, k_pages, v_pages),
                              (block_tables, pos),
                              head_dims=build.PAGED_HEAD_DIMS)
    _check_decode("paged_decode_attention", q, k_pages, v_pages,
                  block_tables, pos)
    b, kh, g, d = q.shape
    ps, n_b = k_pages.shape[1], block_tables.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0 or q.is_meta:
        return out
    build.check_aligned("paged_decode_attention", (q, k_pages, v_pages))
    n, *ws = split_workspace(q, n_b * ps, paged=True)
    rc = build.library().paged_decode_split_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in ws),
        b, kh, g, d, ps, n_b, n, split_tile(q.dtype), code,
        build.stream_of(q))
    build.check(rc, "paged_decode_attention")
    global launches
    launches += 1
    return out
