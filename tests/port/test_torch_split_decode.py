"""The bf16 decode kernels' split across CTAs, on the CPU: the
``split_count`` function that sizes it (shared by the dense and the paged
kernel and by both fused kernels), the plain split-and-merge mirror
``decode_attention_split_ref`` against the JAX package's Pallas
``decode_attention`` in interpret mode (fp32, atol 2e-5): linear rows, a
wrapped ring, holes, a piece with no attended row, a slot with none
(zeros, as the kernel returns) and more pieces than tiles; the paged
mirror ``paged_decode_attention_split_ref`` against the Pallas
``paged_decode_attention`` (same tolerance) at page sizes 8, 16 and 32,
with the trash page full of large garbage; and the split's geometry,
stated once in ``geometry.py`` and passed to nvcc."""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as jax_paged
from repro_torch.kernels import build
from repro_torch.kernels import bullet_attention as TB
from repro_torch.kernels import decode_attention as TD
from repro_torch.kernels import geometry
from repro_torch.kernels import paged_decode_attention as TP
from repro_torch.kernels import ref

ATOL = 2e-5


@pytest.mark.parametrize("b,kh,s,n_sm,per_sm", [
    (4, 1, 2048, 132, 1),    # RecurrentGemma: 4 slots, MQA, 2048-row ring
    (8, 8, 1000, 132, 2),    # Qwen3-1.7B: 8 slots x 8 kv heads, 1000 rows
    (2, 8, 1000, 132, 2),    # 16 (slot, kv head) pairs: 8 pieces of 2 tiles
    (1, 1, 64, 132, 2),      # one tile: one piece
    (1, 1, 100000, 132, 2),  # long rows: capped at MAX_SPLIT
    (64, 8, 4096, 132, 2),   # B*K fills the card: one piece
    (3, 2, 1, 8, 2),         # a single row
    (0, 8, 1000, 132, 2),    # no slot
    (5, 3, 700, 1, 2),       # one SM
    (80, 1, 4096, 132, 1),   # D=256, one CTA an SM: 80 items, one piece
    (40, 1, 4096, 132, 1),   # D=256: 3 pieces of 40 fill one wave of 132
])
def test_split_count_bounds(b, kh, s, n_sm, per_sm):
    n = TD.split_count(b, kh, s, n_sm, per_sm)
    tiles = -(-s // TD.SPLIT_TILE)
    assert 1 <= n <= min(tiles, TD.MAX_SPLIT)
    # two row tiles a piece at least, where there are two
    assert n == 1 or tiles // n >= TD.SPLIT_MIN_TILES
    # one wave of CTAs, as full as the rows allow
    if b * kh and n > 1:
        assert b * kh * n <= per_sm * n_sm
    if b * kh and n < min(tiles // TD.SPLIT_MIN_TILES, TD.MAX_SPLIT):
        assert b * kh * (n + 1) > per_sm * n_sm
    assert n == TD.split_count(b, kh, s, n_sm, per_sm)    # a pure function


def test_split_count_fills_recurrentgemma_decode():
    """One CTA a slot would run 4 CTAs for RecurrentGemma's 4-slot MQA
    decode; the split runs 16 pieces of 2 row tiles for each of the 4
    slots (the D=256 split kernel's shared memory fits one CTA an SM)."""
    n = TD.split_count(4, 1, 2048, 132, 1)
    assert n == 16 and 4 * n > 4


def test_split_count_keeps_one_wave_at_one_cta_per_sm():
    """At D=256 an SM holds one split CTA: 100 (slot, kv head) items take
    one piece each, where two CTAs an SM would have given two (200 CTAs,
    two waves of 132)."""
    assert TD.split_count(100, 1, 4096, 132, 1) == 1
    assert TD.split_count(100, 1, 4096, 132, 2) == 2


def test_fused_dense_kernel_takes_the_same_split():
    """Kernel 5's decode CTAs loop over kernel 4's (slot, head, piece)
    items: both wrappers size the split with the one function."""
    assert TB.split_workspace is TD.split_workspace
    q = torch.zeros(4, 1, 10, 256)
    # on the CPU only the count is computed (no card, no workspace)
    assert TD.split_count(*q.shape[:2], 2048, 132, 1) == 16


def _cases(seed, b=5, kh=2, g=3, s=200, d=32):
    """Five slots over S = 200 rows (tiles of 64: three full and a tail):
    linear positions with rows past pos; a ring that has wrapped
    (positions pos-199 .. pos in ring order); holes in the first 128 rows
    (so the first pieces attend no row); no attended row at all (pos -1);
    a ring whose only attended row is its newest."""
    rng = np.random.default_rng(seed)
    j = np.arange(s)
    pos = np.array([150, 450, 199, -1, 0], np.int32)
    kvpos = np.stack([
        j,
        pos[1] - np.remainder(pos[1] - j, s),
        np.where(j < 128, -1, j),
        j,
        np.where(j == 7, 0, np.where(j % 3 == 0, -1, 300 + j)),
    ]).astype(np.int32)
    q = rng.normal(size=(b, kh, g, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    return q, kc, vc, kvpos, pos


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 7])
def test_split_mirror_matches_pallas(n_split):
    """n_split = 7 is more pieces than the 4 tiles: three pieces are
    empty and weigh 0."""
    q, kc, vc, kvpos, pos = _cases(n_split)
    got = ref.decode_attention_split_ref(
        *map(torch.from_numpy, (q, kc, vc, kvpos, pos)), n_split).numpy()
    want = np.asarray(jax_decode(*map(jnp.asarray, (q, kc, vc, kvpos, pos)),
                                 block_s=64, interpret=True), np.float32)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got[3] == 0).all()            # no attended row: zeros


@pytest.mark.parametrize("n_split", [2, 7])
def test_split_mirror_matches_plain_where_a_row_is_attended(n_split):
    """Against the port's own plain version (the XLA reference), which
    returns the mean of V for the slot with no attended row instead."""
    q, kc, vc, kvpos, pos = _cases(10 + n_split)
    args = [torch.from_numpy(x) for x in (q, kc, vc, kvpos, pos)]
    got = ref.decode_attention_split_ref(*args, n_split)
    want = TD.decode_attention_plain(*args)
    act = torch.tensor([True, True, True, False, True])
    torch.testing.assert_close(got[act], want[act], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the paged kernel: the same split over a slot's block-table rows
# ---------------------------------------------------------------------------

PAGED_CONTEXTS = (1, 64, 65, 150, 0)


def _paged_cases(ps, seed=0, kh=2, g=3, d=32, rows=256):
    """Five slots over a pool of ``ps``-row pages, tables of ``rows`` =
    256 rows (4 tiles of 64): contexts 1, 64 (a tile's edge), 65, 150 and
    an inactive slot (pos -1), the pages in shuffled order; past each
    slot's live pages its table points at the trash page, which holds
    large garbage, so a read of it would show."""
    rng = np.random.default_rng(seed)
    b, n_b = len(PAGED_CONTEXTS), rows // ps
    need = [-(-c // ps) for c in PAGED_CONTEXTS]
    n_pages = sum(need) + 3
    trash = n_pages
    kp = rng.normal(size=(n_pages + 1, ps, kh, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages + 1, ps, kh, d)).astype(np.float32)
    kp[trash] = 1e4
    vp[trash] = -1e4
    perm = rng.permutation(n_pages)
    bt = np.full((b, n_b), trash, np.int32)
    used = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[used:used + n]
        used += n
    pos = np.array([c - 1 for c in PAGED_CONTEXTS], np.int32)
    q = rng.normal(size=(b, kh, g, d)).astype(np.float32)
    return q, kp, vp, bt, pos


@functools.lru_cache(maxsize=None)
def _pallas_paged(ps):
    """The Pallas paged decode on ``_paged_cases(ps)`` (interpret mode);
    the split does not enter it, so one call serves every piece count."""
    return np.asarray(jax_paged(*map(jnp.asarray, _paged_cases(ps)),
                                interpret=True), np.float32)


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
def test_paged_split_mirror_matches_pallas(ps, n_split):
    """n_split = 7 is more pieces than the 4 tiles; each slot takes the
    pieces of its own live tiles (one for the slot of context 1), the
    inactive slot one without a row (zeros, as the Pallas kernel
    returns)."""
    args = [torch.from_numpy(x) for x in _paged_cases(ps)]
    got = ref.paged_decode_attention_split_ref(*args, n_split).numpy()
    np.testing.assert_allclose(got, _pallas_paged(ps), atol=ATOL)
    assert (got[4] == 0).all()


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_split_mirror_matches_plain_on_active_slots(ps):
    """Against the port's plain version (through the wrapper on CPU
    tensors), which returns the mean of V for the inactive slot."""
    args = [torch.from_numpy(x) for x in _paged_cases(ps, seed=1)]
    got = ref.paged_decode_attention_split_ref(*args, 3)
    want = TP.paged_decode_attention(*args)
    act = args[4] >= 0
    torch.testing.assert_close(got[act], want[act], atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,kh,n_sm,per_sm", [
    (8, 8, 132, 2), (1, 8, 132, 4), (6, 2, 132, 1), (64, 8, 132, 2)])
def test_slot_pieces_is_the_split_count_at_the_slots_rows(b, kh, n_sm,
                                                          per_sm):
    """A paged slot's pieces, from the count of any table width that
    holds it, are the split count at its own live rows: where the pieces
    fall depends on the slot alone (the launch's slot count fixed)."""
    for live in (0, 1, 63, 64, 65, 127, 128, 129, 700, 2000, 5000):
        want = TD.split_count(b, kh, live, n_sm, per_sm)
        for width in (64, 256, 1024, 4096, 8192, 32768):
            if width < live:
                continue
            n = TD.split_count(b, kh, width, n_sm, per_sm)
            assert geometry.slot_pieces(n, live) == want, (live, width)


def test_paged_split_mirror_same_at_every_table_width():
    """The paged mirror cuts each slot's own live rows: tables widened by
    trash-page columns (a larger launch count) give every slot the same
    result bit for bit, and slots of 300 and 2000 rows take 2 and 16
    pieces of a count of 32."""
    rng = np.random.default_rng(3)
    ps, kh, g, d, contexts = 16, 2, 3, 32, (1, 300, 2000, 0)
    need = [-(-c // ps) for c in contexts]
    n_pages = sum(need)
    kp = torch.from_numpy(rng.normal(size=(n_pages + 1, ps, kh, d)))
    vp = torch.from_numpy(rng.normal(size=(n_pages + 1, ps, kh, d)))
    kp[n_pages], vp[n_pages] = 1e4, -1e4
    bt = torch.full((len(contexts), 128), n_pages, dtype=torch.int32)
    used = 0
    for i, n in enumerate(need):
        bt[i, :n] = torch.arange(used, used + n)
        used += n
    pos = torch.tensor([c - 1 for c in contexts], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(len(contexts), kh, g, d)))
    assert [geometry.slot_pieces(32, c) for c in contexts] == [1, 2, 16, 1]
    base = ref.paged_decode_attention_split_ref(q, kp, vp, bt, pos, 16)
    wide = torch.cat([bt, torch.full_like(bt, n_pages)], dim=1)
    got = ref.paged_decode_attention_split_ref(q, kp, vp, wide, pos, 32)
    assert torch.equal(got, base)
    act = pos >= 0
    torch.testing.assert_close(
        got[act], TP.paged_decode_attention(q, kp, vp, bt, pos)[act],
        atol=ATOL, rtol=0)


def test_paged_kernels_take_the_same_split():
    """Kernel 3's decode CTAs loop over kernel 2's (slot, head, piece)
    items: both wrappers size the split with the one function, over the
    table's n_b·ps rows."""
    assert TP.split_workspace is TD.split_workspace
    assert TB.split_workspace is TD.split_workspace
    # Qwen3's serve batch: 8 slots x 8 kv heads over 64 pages of 16 rows,
    # two split CTAs an SM of 132 (on the CPU only the count is computed)
    assert TD.split_count(8, 8, 64 * 16, 132, 2) == 4


def test_paged_split_workspace_refuses_17_heads_and_needs_none_empty():
    """G > 16 is refused in bf16 (one 16-row tensor-core operand) before
    anything reaches the card, and taken in fp32 (the CUDA-core body holds
    any G); a launch with no slot needs no workspace (one piece)."""
    with pytest.raises(ValueError, match="paged_decode_attention.*query "
                                         "heads"):
        TD.split_workspace(torch.zeros(1, 1, 17, 128, dtype=torch.bfloat16),
                           64, paged=True)
    assert TD.split_workspace(torch.zeros(1, 1, 17, 128), 64,
                              paged=True) == (1, None, None, None)
    for dtype in (torch.float32, torch.bfloat16):
        assert TD.split_workspace(torch.zeros(0, 8, 2, 128, dtype=dtype),
                                  1024, paged=True) == (1, None, None, None)


# ---------------------------------------------------------------------------
# the split's geometry: stated once, in geometry.py
# ---------------------------------------------------------------------------

def test_split_geometry_is_stated_once():
    """The CUDA sources state no value of SPLIT_TILE, MAX_SPLIT or SPLIT_G
    (attention.cuh refuses to compile without them), the nvcc command
    carries them as defines, and the wrappers read the same module."""
    text = "".join((build.CSRC / n).read_text()
                   for n in build.SOURCES + build.HEADERS)
    header = (build.CSRC / "attention.cuh").read_text()
    cmd = build.compile_command("nvcc", "attention.cu", "attention.o")
    for name, value in geometry.DEFINES.items():
        assert not re.search(rf"#\s*define\s+{name}\b", text), name
        assert not re.search(rf"\b{name}\s*=\s*\d", text), name
        assert f"!defined({name})" in header, name
        assert f"-D{name}={value}" in cmd, name
        assert getattr(TD, name) == value == getattr(geometry, name)
    assert "#error" in header


def test_split_geometry_is_part_of_the_digest(monkeypatch):
    """Changing a define names another library, so it rebuilds."""
    before = build.library_path()
    monkeypatch.setitem(geometry.DEFINES, "MAX_SPLIT", 32)
    assert build.library_path() != before
