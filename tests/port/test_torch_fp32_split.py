"""The fp32 decode body's split across CTAs, on the CPU: its plain mirrors
``ref.decode_attention_fp32_split_ref`` (the dense cache's S rows in
pieces of ``geometry.PIECE_ROWS``, merged in piece order) and
``ref.paged_decode_attention_fp32_split_ref`` (each slot's own live rows in
such pieces) against the JAX package's Pallas ``decode_attention`` and
``paged_decode_attention`` in interpret mode, fp32, atol 2e-5 on the slots
with an attended row: linear rows, a wrapped ring, holes, a slot with no
attended row and an inactive slot (zeros, as the kernels return), page
sizes 8, 16 and 32 with the trash page full of large garbage; a slot's
result bit for bit the same at two table widths and beside other
neighbours; and the piece geometry, stated once in ``geometry.py`` and
passed to nvcc."""

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
P = geometry.PIECE_ROWS


def _dense_cases(seed, s, b=6, kh=2, g=3, d=32):
    """Six slots over S rows: linear positions past pos; a ring that has
    wrapped (positions pos-S+1 .. pos in ring order); holes in the first
    two pieces' rows (those pieces attend no row); no attended row at all
    (pos -1); a ring whose only attended row is its newest; and a slot
    whose positions all lie past pos (pos >= 0, no attended row)."""
    rng = np.random.default_rng(seed)
    j = np.arange(s)
    pos = np.array([s - 30, 3 * s + 7, s - 1, -1, 0, 5], np.int32)
    kvpos = np.stack([
        j,
        pos[1] - np.remainder(pos[1] - j, s),
        np.where(j < 2 * P, -1, j),
        j,
        np.where(j == s // 2, 0, np.where(j % 3 == 0, -1, 300 + j)),
        j + 6,
    ]).astype(np.int32)
    q = rng.normal(size=(b, kh, g, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    return q, kc, vc, kvpos, pos


def _attended(kvpos, pos):
    return ((kvpos >= 0) & (kvpos <= pos[:, None])).any(axis=1)


@pytest.mark.parametrize("s", [64, 200, 320])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_fp32_mirror_matches_pallas(s, seed):
    """One piece (S = 64), a tail piece (200 = 3 x 64 + 8) and five whole
    pieces (320); the slots without an attended row return zeros."""
    q, kc, vc, kvpos, pos = _dense_cases(seed, s)
    got = ref.decode_attention_fp32_split_ref(
        *map(torch.from_numpy, (q, kc, vc, kvpos, pos))).numpy()
    want = np.asarray(jax_decode(*map(jnp.asarray, (q, kc, vc, kvpos, pos)),
                                 block_s=64, interpret=True), np.float32)
    act = _attended(kvpos, pos)
    assert act.tolist() == [True, True, s > 2 * P, False, True, False]
    np.testing.assert_allclose(got[act], want[act], atol=ATOL)
    assert (got[~act] == 0).all()


@pytest.mark.parametrize("s", [200, 320])
def test_dense_fp32_mirror_matches_plain_where_a_row_is_attended(s):
    """Against the port's plain version (the XLA reference), which returns
    the mean of V for a slot with no attended row instead."""
    args = [torch.from_numpy(x) for x in _dense_cases(5, s)]
    got = ref.decode_attention_fp32_split_ref(*args)
    want = TD.decode_attention_plain(*args)
    act = torch.from_numpy(_attended(args[3].numpy(), args[4].numpy()))
    torch.testing.assert_close(got[act], want[act], atol=ATOL, rtol=0)


@pytest.mark.parametrize("piece_rows", [16, 32, 64, 128])
def test_dense_fp32_mirror_does_not_depend_on_the_piece_rows(piece_rows):
    """Any cut of the rows merges to the same softmax (up to the sums'
    order): the pieces change only where partials meet."""
    args = [torch.from_numpy(x) for x in _dense_cases(7, 320)]
    got = ref.decode_attention_fp32_split_ref(*args, piece_rows)
    want = ref.decode_attention_fp32_split_ref(*args, 320)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the paged body: each slot's own live rows in pieces of PIECE_ROWS
# ---------------------------------------------------------------------------

CONTEXTS = (1, 64, 65, 150, 300, 0)


def _paged_cases(ps, seed=0, kh=2, g=3, d=32, rows=512,
                 contexts=CONTEXTS):
    """Slots over a pool of ``ps``-row pages, tables of ``rows`` rows:
    contexts 1, 64 (a piece's edge), 65, 150, 300 (five pieces) and an
    inactive slot (pos -1), the pages in shuffled order; past each slot's
    live pages its table points at the trash page, which holds large
    garbage, so a read of it would show."""
    rng = np.random.default_rng(seed)
    b, n_b = len(contexts), rows // ps
    need = [-(-c // ps) for c in contexts]
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
    pos = np.array([c - 1 for c in contexts], np.int32)
    q = rng.normal(size=(b, kh, g, d)).astype(np.float32)
    return q, kp, vp, bt, pos


@functools.lru_cache(maxsize=None)
def _pallas_paged(ps):
    return np.asarray(jax_paged(*map(jnp.asarray, _paged_cases(ps)),
                                interpret=True), np.float32)


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_fp32_mirror_matches_pallas(ps):
    """Each slot takes the pieces of its own live rows (one for contexts
    1 and 64, two for 65 and 150, five for 300); the inactive slot one
    without a row (zeros, as the Pallas kernel returns)."""
    args = [torch.from_numpy(x) for x in _paged_cases(ps)]
    got = ref.paged_decode_attention_fp32_split_ref(*args).numpy()
    assert [geometry.fp32_pieces(c) for c in CONTEXTS] == [1, 1, 2, 3, 5, 1]
    act = args[4].numpy() >= 0
    np.testing.assert_allclose(got[act], _pallas_paged(ps)[act], atol=ATOL)
    assert (got[~act] == 0).all()


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_fp32_mirror_matches_plain_on_active_slots(ps):
    """Against the port's plain version (through the wrapper on CPU
    tensors), which returns the mean of V for the inactive slot."""
    args = [torch.from_numpy(x) for x in _paged_cases(ps, seed=1)]
    got = ref.paged_decode_attention_fp32_split_ref(*args)
    want = TP.paged_decode_attention(*args)
    act = args[4] >= 0
    torch.testing.assert_close(got[act], want[act], atol=ATOL, rtol=0)


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_paged_fp32_mirror_is_the_dense_mirror_over_the_live_rows(ps):
    """With linear positions over the gathered rows, the dense mirror
    over the whole table (its pieces past a slot's live rows attend
    nothing) gives the paged mirror's result: the fp32 paged body is the
    dense body over the page pool."""
    args = [torch.from_numpy(x) for x in _paged_cases(ps, seed=2)]
    q, kp, vp, bt, pos = args
    b = bt.shape[0]
    kc = kp[bt.long()].reshape(b, -1, *kp.shape[2:])
    vc = vp[bt.long()].reshape(b, -1, *vp.shape[2:])
    kvpos = torch.arange(kc.shape[1], dtype=torch.int32)[None].expand(b, -1)
    dense = ref.decode_attention_fp32_split_ref(q, kc, vc, kvpos, pos)
    paged = ref.paged_decode_attention_fp32_split_ref(*args)
    act = pos >= 0
    torch.testing.assert_close(dense[act], paged[act], atol=1e-6, rtol=0)


def _slot_table(rng, contexts, ps=16, kh=2, g=3, d=32, width=64):
    need = [-(-c // ps) for c in contexts]
    n_pages = sum(need)
    kp = torch.from_numpy(rng.normal(size=(n_pages + 1, ps, kh, d)))
    vp = torch.from_numpy(rng.normal(size=(n_pages + 1, ps, kh, d)))
    kp[n_pages], vp[n_pages] = 1e4, -1e4
    bt = torch.full((len(contexts), width), n_pages, dtype=torch.int32)
    used = 0
    for i, n in enumerate(need):
        bt[i, :n] = torch.arange(used, used + n)
        used += n
    pos = torch.tensor([c - 1 for c in contexts], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(len(contexts), kh, g, d)))
    return q, kp, vp, bt, pos


@pytest.mark.parametrize("width", [64, 128])
def test_paged_fp32_mirror_same_at_every_table_width(width):
    """A slot's pieces come from its own live rows: a table widened by
    trash-page columns (which raises the launch's piece count) gives every
    slot the same result bit for bit."""
    rng = np.random.default_rng(3)
    q, kp, vp, bt, pos = _slot_table(rng, (1, 300, 1000, 0), width=width)
    base = ref.paged_decode_attention_fp32_split_ref(q, kp, vp, bt, pos)
    wide = torch.cat([bt, torch.full_like(bt, kp.shape[0] - 1)], dim=1)
    assert (geometry.fp32_pieces(wide.shape[1] * 16)
            > geometry.fp32_pieces(bt.shape[1] * 16))
    got = ref.paged_decode_attention_fp32_split_ref(q, kp, vp, wide, pos)
    assert torch.equal(got, base)


def test_paged_fp32_mirror_same_beside_other_neighbours():
    """A slot's result does not depend on the other slots of its launch:
    the slot of 1000 rows beside slots of other contexts, and alone with
    the others inactive, bit for bit."""
    rng = np.random.default_rng(4)
    q, kp, vp, bt, pos = _slot_table(rng, (7, 1000, 130, 64))
    base = ref.paged_decode_attention_fp32_split_ref(q, kp, vp, bt, pos)
    alone = torch.full_like(pos, -1)
    alone[1] = pos[1]
    got = ref.paged_decode_attention_fp32_split_ref(q, kp, vp, bt, alone)
    assert torch.equal(got[1], base[1])
    # other neighbours: the other slots' queries and positions replaced
    q2 = q.clone()
    q2[[0, 2, 3]] = torch.from_numpy(rng.normal(size=(3, *q.shape[1:])))
    pos2 = pos.clone()
    pos2[[0, 2, 3]] = torch.tensor([99, 3, -1], dtype=torch.int32)
    got = ref.paged_decode_attention_fp32_split_ref(q2, kp, vp, bt, pos2)
    assert torch.equal(got[1], base[1])


# ---------------------------------------------------------------------------
# the piece geometry: stated once, in geometry.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,want", [(0, 1), (1, 1), (P, 1), (P + 1, 2),
                                       (1000, 16), (4096, 64),
                                       (32768, 512)])
def test_fp32_pieces_are_the_rows_over_piece_rows(rows, want):
    """At least one piece; no cap: a slot's count is its rows' alone."""
    assert geometry.fp32_pieces(rows) == want


def test_piece_rows_is_stated_once():
    """The CUDA sources state no value of PIECE_ROWS (attention.cuh refuses
    to compile without it), the nvcc command carries it, the library's
    digest covers it, and the wrappers read the same module."""
    text = "".join((build.CSRC / n).read_text()
                   for n in build.SOURCES + build.HEADERS)
    header = (build.CSRC / "attention.cuh").read_text()
    assert P % 16 == 0 and P % 32 == 0
    assert geometry.DEFINES["PIECE_ROWS"] == P
    assert geometry.all_defines()["PIECE_ROWS"] == P
    assert not re.search(r"#\s*define\s+PIECE_ROWS\b", text)
    assert not re.search(r"\bPIECE_ROWS\s*=\s*\d", text)
    assert "!defined(PIECE_ROWS)" in header
    cmd = build.compile_command("nvcc", "attention.cu", "attention.o")
    assert f"-DPIECE_ROWS={P}" in cmd
    assert TD.PIECE_ROWS == P
    assert TD.split_tile(torch.float32) == P
    assert TD.split_tile(torch.bfloat16) == geometry.SPLIT_TILE


def test_piece_rows_is_part_of_the_digest(monkeypatch):
    """Changing the piece rows names another library, so it rebuilds."""
    before = build.library_path()
    monkeypatch.setitem(geometry.DEFINES, "PIECE_ROWS", 2 * P)
    assert build.library_path() != before


def test_fp32_decode_entries_take_a_workspace():
    """The fp32 decode goes through the split entries (workspace, pieces,
    tile), as bf16 does; the entries without a workspace are gone."""
    assert "paged_decode_fwd" not in build.SIGNATURES
    assert "decode_attention_fwd" not in build.SIGNATURES
    for name in ("paged_decode_split_fwd", "decode_attention_split_fwd"):
        assert build.SIGNATURES[name][6:9] == [build._P] * 3


def test_fp32_prefill_tiles_are_the_bodys():
    """The fused launches' prefill order reads the fp32 body's tiles:
    64 query rows over 64-key tiles (FQ, FK in csrc/attention.cuh)."""
    header = (build.CSRC / "attention.cuh").read_text()
    fq = int(re.search(r"constexpr int FQ = (\d+);", header).group(1))
    fk = int(re.search(r"constexpr int FK = (\d+);", header).group(1))
    assert TB.FLASH_TILES[0] == (fq, fk) == (64, 64)
