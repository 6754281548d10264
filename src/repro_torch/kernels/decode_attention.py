"""Single-token GQA decode attention over a dense per-slot cache: the
wrapper of the CUDA kernel behind ``decode_attention_split_fwd`` (fp32 and
bf16) in ``csrc/attention.cu``, its launch counter and its plain PyTorch
version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:62``
(``decode_attention``). Each slot owns a contiguous cache row ``(S, K, D)``
and ``kv_positions`` (B, S) gives the absolute position each row holds:
row ``j`` is attended when ``0 <= kv_positions[b, j] <= pos[b]``, so a ring
cache (positions in any order, holes of -1) is masked by position, not by
index. Any ``S`` works: the kernel masks the tail tile where the TPU
dispatcher only took ``S % 128 == 0``.

Both dtypes split each (slot, kv head)'s rows into pieces, one CTA each,
and the last piece to finish merges the partial softmaxes in piece order
(flash-decoding; the workspace is allocated here, ``split_workspace``). In
bf16 the rows are split into ``split_count(B, K, S, SMs, CTAs per SM)``
pieces and both products run on the tensor cores (G <= 16 query heads per
kv head); in fp32 into ``geometry.fp32_pieces(S)`` pieces of
``PIECE_ROWS`` rows, both products as fp32 FMAs on the CUDA cores (any G).

A slot with no attended row: the kernel returns zeros, as the TPU kernel
does; the plain version follows the XLA reference ``decode_attention``
and returns the mean of V. Compare the two on slots with an attended row.
Bound on the card: bytes (see the source's header note).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import ref
from repro_torch.kernels.geometry import (MAX_SPLIT, PIECE_ROWS, SPLIT_G,
                                          SPLIT_MIN_TILES, SPLIT_TILE,
                                          fp32_pieces)

#: kernel launches since the counter was last reset (plain integer)
launches = 0

#: the plain version: ``decode_attention`` on the kernel layout (ref.py)
decode_attention_plain = ref.decode_attention_ref

# SPLIT_TILE (rows per tile of the bf16 split body), MAX_SPLIT (pieces per
# (slot, kv head) at most), SPLIT_G (query heads per kv head at most),
# SPLIT_MIN_TILES (row tiles a piece takes at least) and PIECE_ROWS (rows
# per piece of the fp32 body) come from geometry.py, which the build
# passes to nvcc as well


def split_count(b: int, kh: int, s: int, n_sm: int, ctas_per_sm: int) -> int:
    """Pieces the bf16 kernel splits each (slot, kv head)'s ``s`` rows
    into: as many as keep the launch's ``b·kh·n`` CTAs within one wave of
    ``n_sm`` SMs that hold ``ctas_per_sm`` split CTAs each, but at least
    ``SPLIT_MIN_TILES`` row tiles a piece; at least 1, at most the row tiles (and
    ``MAX_SPLIT``). The fused kernels and the paged decode kernel take the
    same count, so the fused kernels' decode CTAs run the same items."""
    tiles = max(1, -(-s // SPLIT_TILE))
    want = max(1, ctas_per_sm) * n_sm // max(1, b * kh)
    return max(1, min(tiles // SPLIT_MIN_TILES, want, MAX_SPLIT))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def split_ctas_per_sm(device_index: int, d: int, paged: bool = False) -> int:
    """CTAs of the bf16 split kernel at head dim ``d`` one SM of the device
    holds at once (by its registers and shared memory), over the dense
    cache or (``paged``) the page pool."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = build.library().split_decode_ctas_per_sm(d, int(paged),
                                                      ctypes.byref(per_sm))
    build.check(rc, "decode_attention")
    return per_sm.value


def n_split(q, s: int, *, paged: bool = False) -> int:
    """Pieces per (slot, kv head) of a bf16 decode over ``s`` rows (the
    dense cache's S, or ``paged``: the block table's n_b·ps) for the CUDA
    tensor ``q`` (B, K, G, D) on its device. Shapes only: ``pos`` is never
    read on the host."""
    b, kh, _, d = q.shape
    dev = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    return split_count(b, kh, s, sm_count(dev),
                       split_ctas_per_sm(dev, d, paged))


#: arrival counters of the split launches, per (device, stream): zero
#: between launches (the merging CTA resets its own)
_COUNTS: dict = {}


def _counts(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    cnt = _COUNTS.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTS[key] = cnt
    return cnt


def split_tile(dtype) -> int:
    """The rows a piece of the split body is counted in, which the C entry
    checks against its own: SPLIT_TILE-row tiles in bf16, pieces of
    PIECE_ROWS rows in fp32."""
    return PIECE_ROWS if dtype == torch.float32 else SPLIT_TILE


def split_workspace(q, s: int, *, paged: bool = False):
    """(n_split, ws_acc, ws_ml, counts) of a decode over ``s`` rows
    (``paged``: over the page pool, ``s`` = n_b·ps) for ``q`` (B, K, G,
    D): the pieces per (slot, kv head) (bf16: ``n_split``; fp32:
    ``fp32_pieces(s)``, from the rows alone), the partial accumulators and
    (m, l) of every piece, and the arrival counters. With one piece no
    workspace is needed (``None``s). The paged and the dense kernels, and
    each fused kernel, size their splits here."""
    b, kh, g, d = q.shape
    fp32 = q.dtype == torch.float32
    if g > SPLIT_G and not fp32:
        name = "paged_decode_attention" if paged else "decode_attention"
        raise ValueError(f"{name}: bfloat16 takes at most {SPLIT_G} query "
                         f"heads per kv head, got {g}")
    dev = q.device
    n = (fp32_pieces(s) if fp32 else n_split(q, s, paged=paged)) \
        if b * kh else 1
    if n == 1:
        return 1, None, None, None
    ws_acc = torch.empty(b * kh * n * g * d, dtype=torch.float32, device=dev)
    ws_ml = torch.empty(b * kh * n * g * 2, dtype=torch.float32, device=dev)
    return n, ws_acc, ws_ml, _counts(dev, b * kh)


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

    CUDA tensors launch the kernel; CPU tensors run the plain version;
    meta tensors get an empty output."""
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("decode_attention", lambda: (
                cost.dense_price(q, kv_positions, pos))):
            return _dispatch(q, k_cache, v_cache, kv_positions, pos)
    return _dispatch(q, k_cache, v_cache, kv_positions, pos)


def _dispatch(q, k_cache, v_cache, kv_positions, pos):
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_positions, pos)
    build.refuse_grad("decode_attention", (q, k_cache, v_cache),
                      "ROADMAP §2 R19")
    code = build.check_inputs("decode_attention", (q, k_cache, v_cache),
                              (kv_positions, pos))
    _check_dense("decode_attention", q, k_cache, v_cache, kv_positions, pos)
    b, kh, g, d = q.shape
    s = k_cache.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0 or q.is_meta:
        return out
    build.check_aligned("decode_attention", (q, k_cache, v_cache))
    n, *ws = split_workspace(q, s)
    rc = build.library().decode_attention_split_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_positions.data_ptr(), pos.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in ws),
        b, kh, g, d, s, n, split_tile(q.dtype), code, build.stream_of(q))
    build.check(rc, "decode_attention")
    global launches
    launches += 1
    return out
