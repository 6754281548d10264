"""The CUDA kernels against their plain versions on the card (marked
``cuda``; they skip where no CUDA device is present). Run on a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/port

Tolerances: fp32 atol 1e-4 (kernel sums in another order), bf16 atol 2e-2
(kernel and plain version round the probabilities at different maxima),
and bf16 flash, dense decode and paged decode also within ULPS bf16 ulps
of each output row's own scale.
The SSD scan is compared over its output's scale max(1, max|plain|): fp32
1e-4, bf16 y 1e-2 (y is rounded to bf16), the fp32 state 1e-4; the bf16
body also against its plain mirror ``ref.ssd_scan_tc_ref`` (the same
roundings, another summation order), tighter: y 2^-7 (one bf16 ulp of the
scale's binade: the two round y apart at most once), the state 1e-5.
The RG-LRU scan runs the plain version's arithmetic in the same order:
equal to it bit for bit."""

import pytest
import torch

from repro_torch.kernels import bullet_attention as TB
from repro_torch.kernels import decode_attention as TD
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as TP
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rglru_scan as TR
from repro_torch.kernels import ssd_scan as TS
from repro_torch.kernels.geometry import PIECE_ROWS, fp32_pieces, slot_pieces

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the bf16 flash and split decode bodies also hold each output row
#: within this many bf16 ulps of the row's own scale max|plain_row| (as
#: chip_smoke.py's RG_ATTN_ULPS); a result one key short reads far more
ULPS = 4
pytestmark = pytest.mark.cuda


def row_ulps(out, ref) -> float:
    """max|out - ref| over each row (the last dim), in bf16 ulps of the
    row's scale max|ref_row|; the largest over the rows."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    scale = ref.abs().amax(-1).clamp(min=2.0 ** -100)
    return (err / torch.exp2(torch.floor(torch.log2(scale)) - 7)).max().item()


def assert_bf16_close(out, ref):
    """TOL's absolute limit and ULPS per output row."""
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOL[torch.bfloat16], rtol=0)
    assert row_ulps(out, ref) <= ULPS


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _decode_case(gen, dtype, kh=2, g=2, d=128, ps=16):
    contexts = [1, 16, 17, 90, 0]
    n_b = 8
    n_pages = 16
    kp = torch.randn(n_pages + 1, ps, kh, d, generator=gen, device="cuda")
    vp = torch.randn(n_pages + 1, ps, kh, d, generator=gen, device="cuda")
    bt = torch.full((len(contexts), n_b), n_pages, dtype=torch.int32)
    nxt = 0
    for i, c in enumerate(contexts):
        need = -(-c // ps)
        bt[i, :need] = torch.arange(nxt, nxt + need)
        nxt += need
    pos = torch.tensor([c - 1 for c in contexts], dtype=torch.int32)
    q = torch.randn(len(contexts), kh, g, d, generator=gen, device="cuda")
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), bt.cuda(), pos.cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window", [(64, 0), (200, 0), (200, 17)])
def test_flash_kernel_matches_plain(gen, dtype, s, window):
    q = torch.randn(8, s, 128, generator=gen, device="cuda").to(dtype)
    k = torch.randn(4, s, 128, generator=gen, device="cuda").to(dtype)
    v = torch.randn(4, s, 128, generator=gen, device="cuda").to(dtype)
    before = TF.launches
    out = TF.flash_attention(q, k, v, window=window, group=2)
    ref = TF.flash_attention_plain(q, k, v, window=window, group=2)
    assert TF.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)
    if dtype == torch.bfloat16:
        assert row_ulps(out, ref) <= ULPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(gen, dtype):
    q, kp, vp, bt, pos = _decode_case(gen, dtype)
    out = TP.paged_decode_attention(q, kp, vp, bt, pos)
    ref = TP.paged_decode_attention_plain(q, kp, vp, bt, pos)
    act = pos >= 0
    torch.testing.assert_close(out[act].float(), ref[act].float(),
                               atol=TOL[dtype], rtol=0)
    if dtype == torch.bfloat16:
        assert row_ulps(out[act], ref[act]) <= ULPS
    assert bool((out[~act] == 0).all())


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_bullet_kernel_bit_equal_to_standalone(gen, share):
    q = torch.randn(8, 100, 128, generator=gen, device="cuda")
    k = torch.randn(4, 100, 128, generator=gen, device="cuda")
    v = torch.randn(4, 100, 128, generator=gen, device="cuda")
    qd, kp, vp, bt, pos = _decode_case(gen, torch.float32)
    op, od = TB.bullet_attention_paged(q, k, v, qd, kp, vp, bt, pos,
                                       decode_share=share, group=2)
    assert torch.equal(op, TF.flash_attention(q, k, v, group=2))
    assert torch.equal(od, TP.paged_decode_attention(qd, kp, vp, bt, pos))


def _dense_case(gen, dtype, ring, kh=2, g=2, d=128, s=72):
    """A dense per-slot cache: linear positions, or a scrambled ring with
    holes (tests/test_kernels.py), S = 72 so the last 16-row tile is a
    tail; every slot attends at least one row."""
    b = 3
    base = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    kvpos = (torch.where(base % 5 == 0, -1, (base * 13) % 80) if ring
             else base).to(torch.int32).contiguous()
    pos = torch.tensor([40, 71, 3], dtype=torch.int32)
    q = torch.randn(b, kh, g, d, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
    return q, kc, vc, kvpos.cuda(), pos.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_dense_decode_kernel_matches_plain(gen, dtype, ring):
    q, kc, vc, kvpos, pos = _dense_case(gen, dtype, ring)
    before = TD.launches
    out = TD.decode_attention(q, kc, vc, kvpos, pos)
    ref = TD.decode_attention_plain(q, kc, vc, kvpos, pos)
    assert TD.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)
    if dtype == torch.bfloat16:
        assert row_ulps(out, ref) <= ULPS
    # a slot with no attended row returns zeros, as the TPU kernel does
    none = torch.full_like(kvpos, -1)
    assert bool((TD.decode_attention(q, kc, vc, none, pos) == 0).all())


@pytest.mark.parametrize("dtype,ps,n_split", [
    (torch.float32, 16, None), (torch.bfloat16, 8, None),
    (torch.bfloat16, 16, None), (torch.bfloat16, 32, None),
    (torch.bfloat16, 16, 3), (torch.bfloat16, 16, 7)])
def test_dense_decode_equals_paged_decode_bit_for_bit(gen, monkeypatch,
                                                       dtype, ps, n_split):
    """With linear positions over the gathered rows the dense kernel walks
    the paged kernel's rows in the same tiles: fp32 in 16-row tiles over
    16-row pages, all S = n_b·ps rows at once; bf16 in the split body's
    64-row tiles over any page size, each slot's own live rows in its own
    pieces (``geometry.slot_pieces`` of the paged launch's count), which
    the dense kernel takes over S = live rows with that count (None: the
    paged wrapper's own count; else forced)."""
    if n_split is not None:
        monkeypatch.setattr(TD, "split_count", lambda *a: n_split)
    q, kp, vp, bt, pos = _paged_split_case(gen, dtype, ps)
    act = pos >= 0
    b, n_b = bt.shape
    kc = kp[bt.long()].reshape(b, -1, *kp.shape[2:]).contiguous()
    vc = vp[bt.long()].reshape(b, -1, *vp.shape[2:]).contiguous()
    paged = TP.paged_decode_attention(q, kp, vp, bt, pos)
    if dtype == torch.float32:
        kvpos = torch.arange(kc.shape[1], dtype=torch.int32,
                             device="cuda")[None].expand(b, -1).contiguous()
        dense = TD.decode_attention(q, kc, vc, kvpos, pos)
        assert torch.equal(dense[act], paged[act])
        return
    n = TD.n_split(q, n_b * ps, paged=True)
    for i in act.nonzero().flatten().tolist():
        live = int(pos[i]) + 1
        pieces = slot_pieces(n, live)
        monkeypatch.setattr(TD, "split_count", lambda *a: pieces)
        kvpos = torch.arange(live, dtype=torch.int32, device="cuda")[None]
        dense = TD.decode_attention(q[i:i + 1], kc[i:i + 1, :live].clone(),
                                    vc[i:i + 1, :live].clone(), kvpos,
                                    pos[i:i + 1])
        assert torch.equal(dense[0], paged[i]), i


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_split_paged_decode_same_at_every_table_width(gen, ps):
    """A slot's bf16 paged decode is bit-equal whatever the table's width
    (the engine's bucket, which the longest slot of a batch sets) and
    whatever the other slots of its launch hold (their number fixed, as
    the engine's decode batch is): slots of up to 2000 rows in tables
    widened by trash-page columns to 2 and 4 times 2048 rows, which raise
    the launch's piece count, and each slot with the others inactive and
    the table cut to its own bucket."""
    contexts = (1, 65, 300, 1000, 2000, 0)
    q, kp, vp, bt, pos = _paged_split_case(gen, torch.bfloat16, ps,
                                           contexts=contexts, rows=2048)
    base = TP.paged_decode_attention(q, kp, vp, bt, pos)
    trash = kp.shape[0] - 1
    counts = {TD.n_split(q, bt.shape[1] * ps, paged=True)}
    for f in (2, 4):
        wide = torch.full((bt.shape[0], f * bt.shape[1]), trash,
                          dtype=torch.int32, device="cuda")
        wide[:, :bt.shape[1]] = bt
        counts.add(TD.n_split(q, wide.shape[1] * ps, paged=True))
        out = TP.paged_decode_attention(q, kp, vp, wide, pos)
        assert torch.equal(out, base), f
    assert len(counts) > 1, counts
    for i, c in enumerate(contexts):
        if not c:
            continue
        n_b = 1 << (-(-c // ps) - 1).bit_length()
        alone = torch.full_like(pos, -1)
        alone[i] = pos[i]
        own = TP.paged_decode_attention(q, kp, vp,
                                        bt[:, :n_b].contiguous(), alone)
        assert torch.equal(own[i], base[i]), i


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_dense_bullet_kernel_bit_equal_to_standalone(gen, share, ring):
    q = torch.randn(8, 100, 128, generator=gen, device="cuda")
    k = torch.randn(4, 100, 128, generator=gen, device="cuda")
    v = torch.randn(4, 100, 128, generator=gen, device="cuda")
    qd, kc, vc, kvpos, pos = _dense_case(gen, torch.float32, ring)
    before = TB.dense_launches
    op, od = TB.bullet_attention(q, k, v, qd, kc, vc, kvpos, pos,
                                 decode_share=share, group=2)
    assert TB.dense_launches == before + 1
    assert torch.equal(op, TF.flash_attention(q, k, v, group=2))
    assert torch.equal(od, TD.decode_attention(qd, kc, vc, kvpos, pos))


def test_wrappers_reject_bad_inputs(gen):
    q = torch.randn(8, 32, 128, generator=gen, device="cuda")
    k = torch.randn(4, 32, 128, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        TF.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           k, k, group=2)
    with pytest.raises(TypeError):
        TF.flash_attention(q.half(), k.half(), k.half(), group=2)
    with pytest.raises(ValueError):
        TF.flash_attention(q, k, k, group=3)
    # no instance at head dim 32 (64, 128 and 256 are built)
    with pytest.raises(ValueError, match="head dim"):
        TF.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           k[..., :32].contiguous(), group=2)
    qd, kc, vc, kvpos, pos = _dense_case(gen, torch.float32, False)
    with pytest.raises(TypeError, match="int32"):
        TD.decode_attention(qd, kc, vc, kvpos.long(), pos)
    with pytest.raises(ValueError):
        TD.decode_attention(qd, kc, vc, kvpos[:, :-1].contiguous(), pos)


def _scaled_err(out, ref):
    ref = ref.float()
    return ((out.float() - ref).abs().max()
            / ref.abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 48, 3, 8, 4, 16), (1, 200, 4, 64, 128, 256),
    (2, 300, 3, 40, 16, 128), (1, 70, 2, 32, 16, 64)])
def test_ssd_kernel_matches_plain(gen, dtype, b, s, h, p, n, chunk):
    """Runtime Q (a chunk of S rows when S < chunk, a padded tail chunk),
    P not a multiple of the kernel's 32-column slice, N below 128."""
    x = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device="cuda"))
    A = -torch.exp(torch.randn(h, generator=gen, device="cuda"))
    B_ = torch.randn(b, s, n, generator=gen, device="cuda").to(dtype)
    C = torch.randn(b, s, n, generator=gen, device="cuda").to(dtype)
    xw, cum, bc, cc = ops.ssd_chunk_inputs(x, dt, A, B_, C, chunk=chunk)
    before = TS.launches
    y, st = TS.ssd_scan(xw, cum, bc, cc)
    assert TS.launches == before + 1
    ry, rst = TS.ssd_scan_plain(xw, cum, bc, cc)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert _scaled_err(y, ry) <= (1e-4 if dtype == torch.float32 else 1e-2)
    assert _scaled_err(st, rst) <= 1e-4


#: the bf16 SSD body against its mirror, over the mirror's scale: y within
#: one bf16 ulp of the scale's binade, the fp32 state within 1e-5 (the plain
#: version's limits are 1e-2 and 1e-4)
SSD_TC_Y_TOL = 2.0 ** -7
SSD_TC_STATE_TOL = 1e-5


@pytest.mark.parametrize("p_slice", [16, 32, 64])
@pytest.mark.parametrize("b,s,h,p,n,chunk,decay", [
    (2, 40, 3, 16, 32, 64, 1.0), (2, 45, 3, 16, 16, 16, 1.0),
    (1, 64, 2, 16, 16, 32, 40.0), (1, 128, 2, 32, 8, 64, 1.0),
    (2, 96, 2, 40, 16, 32, 1.0), (1, 48, 2, 4, 4, 16, 1.0),
    (1, 1000, 4, 64, 128, 256, 1.0), (4, 200, 4, 64, 128, 256, 1.0)])
def test_ssd_bf16_kernel_matches_its_mirror(gen, p_slice, b, s, h, p, n,
                                            chunk, decay):
    """The bf16 body at every P slice: one chunk (Q = S), a padded tail,
    strong decay (A scaled by 40), N < 128, P not a multiple of the slice,
    P = N = 4, and Mamba-2-2.7B's P, N and chunk; one count per call for
    its two CUDA launches."""
    x = torch.randn(b, s, h, p, generator=gen, device="cuda").bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device="cuda"))
    A = -decay * torch.exp(torch.randn(h, generator=gen, device="cuda"))
    B_ = torch.randn(b, s, n, generator=gen, device="cuda").bfloat16()
    C = torch.randn(b, s, n, generator=gen, device="cuda").bfloat16()
    xw, cum, bc, cc = ops.ssd_chunk_inputs(x, dt, A, B_, C, chunk=chunk)
    before = TS.launches
    y, st = TS.ssd_scan(xw, cum, bc, cc, p_slice=p_slice)
    assert TS.launches == before + 1
    my, mst = kref.ssd_scan_tc_ref(xw, cum, bc, cc)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    assert _scaled_err(y, my) <= SSD_TC_Y_TOL
    assert _scaled_err(st, mst) <= SSD_TC_STATE_TOL


def test_ssd_wrapper_rejects_a_p_slice_it_has_no_body_for(gen):
    xw = torch.randn(1, 1, 16, 2, 8, generator=gen, device="cuda").bfloat16()
    cum = torch.zeros(1, 1, 16, 2, device="cuda")
    bc = torch.randn(1, 1, 16, 16, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="P slice"):
        TS.ssd_scan(xw, cum, bc, bc, p_slice=8)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_hold(gen):
    xw = torch.randn(1, 1, 300, 2, 8, generator=gen, device="cuda")
    cum = torch.zeros(1, 1, 300, 2, device="cuda")
    bc = torch.randn(1, 1, 300, 16, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="chunk"):
        TS.ssd_scan(xw, cum, bc, bc)
    with pytest.raises(TypeError, match="float32"):
        TS.ssd_scan(xw[:, :, :200].contiguous(),
                    cum[:, :, :200].contiguous().double(),
                    bc[:, :, :200].contiguous(), bc[:, :, :200].contiguous())


# ---------------------------------------------------------------------------
# the RG-LRU scan, and the attention kernels at RecurrentGemma's head dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("b,s,w", [(1, 1, 1), (3, 37, 130), (2, 300, 257),
                                   (5, 16, 64)])
def test_rglru_kernel_matches_plain(gen, dtype, with_h0, b, s, w):
    """Ragged B, S (not a multiple of the 16-step unroll, or below it) and
    W (CTAs of 128 channels spanning two rows of B)."""
    a = torch.sigmoid(torch.randn(b, s, w, generator=gen,
                                  device="cuda")).to(dtype)
    bb = torch.randn(b, s, w, generator=gen, device="cuda").to(dtype)
    h0 = (torch.randn(b, w, generator=gen, device="cuda") if with_h0
          else None)
    before = TR.launches
    y, h = TR.rglru_scan(a, bb, h0)
    assert TR.launches == before + 1
    ry, rh = TR.rglru_scan_plain(a, bb, h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    assert torch.equal(y, ry) and torch.equal(h, rh)


def test_rglru_wrapper_rejects_what_the_kernel_does_not_take(gen):
    a = torch.rand(2, 8, 16, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        TR.rglru_scan(a, a[:, :4].contiguous())
    with pytest.raises(TypeError, match="float32"):
        TR.rglru_scan(a, a, torch.zeros(2, 16, device="cuda").double())
    with pytest.raises(ValueError):
        TR.rglru_scan(a, a, torch.zeros(2, 8, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window", [(100, 0), (300, 64), (300, 0)])
def test_flash_kernel_at_head_dim_256(gen, dtype, s, window):
    """RecurrentGemma's heads: 10 query heads on one kv head (G = 10),
    D = 256, causal, with and without a window shorter than S."""
    q = torch.randn(2 * 10, s, 256, generator=gen, device="cuda").to(dtype)
    k = torch.randn(2, s, 256, generator=gen, device="cuda").to(dtype)
    v = torch.randn(2, s, 256, generator=gen, device="cuda").to(dtype)
    before = TF.launches
    out = TF.flash_attention(q, k, v, window=window, group=10)
    ref = TF.flash_attention_plain(q, k, v, window=window, group=10)
    assert TF.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)
    if dtype == torch.bfloat16:
        assert row_ulps(out, ref) <= ULPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_at_head_dim_256_over_a_wrapped_ring(gen, dtype):
    """A 64-row ring that has wrapped (positions pos-63..pos in ring
    order), one that has not (holes of -1), G = 10, D = 256."""
    s = 64
    pos = torch.tensor([200, 30, 63], dtype=torch.int32)
    slots = torch.arange(s)[None]
    p = pos[:, None] - torch.remainder(pos[:, None] - slots, s)
    kvpos = torch.where(p >= 0, p, -1).to(torch.int32).cuda()
    q = torch.randn(3, 1, 10, 256, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(3, s, 1, 256, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(3, s, 1, 256, generator=gen, device="cuda").to(dtype)
    before = TD.launches
    out = TD.decode_attention(q, kc, vc, kvpos, pos.cuda())
    ref = TD.decode_attention_plain(q, kc, vc, kvpos, pos.cuda())
    assert TD.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)
    if dtype == torch.bfloat16:
        assert row_ulps(out, ref) <= ULPS


def test_paged_and_fused_kernels_refuse_head_dim_256(gen):
    """Only flash prefill and dense decode are built at D = 256."""
    qd = torch.randn(2, 1, 2, 256, generator=gen, device="cuda")
    kp = torch.randn(3, 16, 1, 256, generator=gen, device="cuda")
    bt = torch.zeros(2, 1, dtype=torch.int32, device="cuda")
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        TP.paged_decode_attention(qd, kp, kp, bt, pos)
    q = torch.randn(4, 16, 256, generator=gen, device="cuda")
    k = torch.randn(2, 16, 256, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        TB.bullet_attention_paged(q, k, k, qd, kp, kp, bt, pos, group=2)


# ---------------------------------------------------------------------------
# the bf16 bodies: flash on the tensor cores, dense decode split across CTAs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("s", [64, 127, 128, 129, 383])
def test_flash_tensor_core_body_at_tile_edges(gen, d, s):
    """S below, at and off a multiple of the 128-row query tile and the
    64-key K/V tile (a query tile whose second warpgroup has no row at
    S = 64), causal, G = 2."""
    q = torch.randn(4, s, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(2, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(2, s, d, generator=gen, device="cuda").bfloat16()
    out = TF.flash_attention(q, k, v, group=2)
    ref = TF.flash_attention_plain(q, k, v, group=2)
    assert_bf16_close(out, ref)


@pytest.mark.parametrize("window", [1, 17, 63])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tensor_core_window_shorter_than_a_tile(gen, window, causal):
    """Windows shorter than one 64-key tile: every tile crosses an edge
    of some row's window, and a row's first tiles are masked whole."""
    q = torch.randn(4, 300, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(2, 300, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(2, 300, 128, generator=gen, device="cuda").bfloat16()
    out = TF.flash_attention(q, k, v, causal=causal, window=window, group=2)
    ref = TF.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   group=2)
    assert_bf16_close(out, ref)


def test_flash_tensor_core_recurrentgemma_heads(gen):
    """G = 10 query heads on one kv head, D = 256, Bp = 4 rows, the
    window shorter than S: RecurrentGemma's launches at a reduced S."""
    q = torch.randn(40, 700, 256, generator=gen, device="cuda").bfloat16()
    k = torch.randn(4, 700, 256, generator=gen, device="cuda").bfloat16()
    v = torch.randn(4, 700, 256, generator=gen, device="cuda").bfloat16()
    out = TF.flash_attention(q, k, v, window=300, group=10)
    ref = TF.flash_attention_plain(q, k, v, window=300, group=10)
    assert_bf16_close(out, ref)


def _split_case(gen, d, s=200, kh=2, g=3):
    """tests/port/test_torch_split_decode.py's five slots: linear rows
    past pos, a wrapped ring, holes in the first 128 rows (the first
    pieces attend no row), no attended row (pos -1), one attended row."""
    j = torch.arange(s)
    pos = torch.tensor([150, 450, 199, -1, 0], dtype=torch.int32)
    kvpos = torch.stack([
        j, pos[1] - torch.remainder(pos[1] - j, s), torch.where(j < 128, -1, j),
        j, torch.where(j == 7, 0, torch.where(j % 3 == 0, -1, 300 + j))])
    q = torch.randn(5, kh, g, d, generator=gen, device="cuda").bfloat16()
    kc = torch.randn(5, s, kh, d, generator=gen, device="cuda").bfloat16()
    vc = torch.randn(5, s, kh, d, generator=gen, device="cuda").bfloat16()
    return q, kc, vc, kvpos.to(torch.int32).cuda(), pos.cuda()


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("n_split", [None, 1, 2, 3, 7])
def test_split_dense_decode_kernel(gen, monkeypatch, d, n_split):
    """The bf16 split kernel against its plain mirror at the same split
    and against the plain version on the slots with an attended row, each
    within TOL and ULPS per output row; the slot with none returns zeros.
    ``None`` keeps the wrapper's own split_count; 7 is more pieces than
    the 4 row tiles."""
    if n_split is not None:
        monkeypatch.setattr(TD, "split_count", lambda *a: n_split)
    q, kc, vc, kvpos, pos = _split_case(gen, d)
    n = TD.n_split(q, 200)
    before = TD.launches
    out = TD.decode_attention(q, kc, vc, kvpos, pos)
    assert TD.launches == before + 1
    act = torch.tensor([True, True, True, False, True], device="cuda")
    mirror = ref_split(q, kc, vc, kvpos, pos, n)
    assert_bf16_close(out[act], mirror[act])
    plain = TD.decode_attention_plain(q, kc, vc, kvpos, pos)
    assert_bf16_close(out[act], plain[act])
    assert bool((out[3] == 0).all())
    # run to run, whatever order the pieces finish in
    assert torch.equal(out, TD.decode_attention(q, kc, vc, kvpos, pos))


def ref_split(q, kc, vc, kvpos, pos, n):
    return kref.decode_attention_split_ref(q, kc, vc, kvpos, pos, n)


@pytest.mark.parametrize("n_split", [None, 1, 3, 7])
@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_bullet_kernel_bit_equal_to_standalone_bf16(gen, monkeypatch, share,
                                                    n_split):
    """The paged fused kernel's prefill items run the tensor-core body, its
    decode CTAs the split items of the standalone paged launch (the same
    split_count; None: its own, else forced; 7 is more pieces than the 4
    row tiles)."""
    if n_split is not None:
        monkeypatch.setattr(TD, "split_count", lambda *a: n_split)
    q = torch.randn(8, 300, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(4, 300, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(4, 300, 128, generator=gen, device="cuda").bfloat16()
    qd, kp, vp, bt, pos = _paged_split_case(gen, torch.bfloat16, 16)
    op, od = TB.bullet_attention_paged(q, k, v, qd, kp, vp, bt, pos,
                                       decode_share=share, group=2)
    assert torch.equal(op, TF.flash_attention(q, k, v, group=2))
    assert torch.equal(od, TP.paged_decode_attention(qd, kp, vp, bt, pos))


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_dense_bullet_kernel_bit_equal_to_standalone_bf16(gen, share, ring):
    """The dense fused kernel's decode CTAs run the split items of the
    standalone launch (the same split_count), its prefill items the
    tensor-core body."""
    q = torch.randn(8, 300, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(4, 300, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(4, 300, 128, generator=gen, device="cuda").bfloat16()
    qd, kc, vc, kvpos, pos = _dense_case(gen, torch.bfloat16, ring)
    op, od = TB.bullet_attention(q, k, v, qd, kc, vc, kvpos, pos,
                                 decode_share=share, group=2)
    assert torch.equal(op, TF.flash_attention(q, k, v, group=2))
    assert torch.equal(od, TD.decode_attention(qd, kc, vc, kvpos, pos))


def test_split_dense_decode_refuses_more_than_16_query_heads(gen):
    """The bf16 body takes a kv head's query heads as one 16-row operand."""
    q = torch.randn(1, 1, 17, 128, generator=gen, device="cuda").bfloat16()
    kc = torch.randn(1, 64, 1, 128, generator=gen, device="cuda").bfloat16()
    kvpos = torch.arange(64, dtype=torch.int32, device="cuda")[None]
    pos = torch.tensor([63], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="query heads"):
        TD.decode_attention(q, kc, kc, kvpos, pos)


def _paged_split_case(gen, dtype, ps, kh=2, g=3, d=128, rows=256,
                      contexts=(1, 64, 65, 150, 0)):
    """tests/port/test_torch_split_decode.py's paged slots: tables of 256
    rows (4 tiles of 64) over ``ps``-row pages, contexts 1, 64 (a tile's
    edge), 65, 150 and an inactive slot (or ``rows`` and ``contexts``
    given), pages shuffled; past each slot's live pages the table points
    at the trash page (the pool's last), which holds large garbage."""
    b, n_b = len(contexts), rows // ps
    need = [-(-c // ps) for c in contexts]
    n_pages = sum(need) + 3
    kp = torch.randn(n_pages + 1, ps, kh, d, generator=gen, device="cuda")
    vp = torch.randn(n_pages + 1, ps, kh, d, generator=gen, device="cuda")
    kp[n_pages] = 1e4
    vp[n_pages] = -1e4
    perm = torch.randperm(n_pages, generator=gen, device="cuda").cpu()
    bt = torch.full((b, n_b), n_pages, dtype=torch.int32)
    used = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[used:used + n]
        used += n
    pos = torch.tensor([c - 1 for c in contexts], dtype=torch.int32)
    q = torch.randn(b, kh, g, d, generator=gen, device="cuda")
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), bt.cuda(), pos.cuda())


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("n_split", [None, 1, 2, 3, 7])
def test_split_paged_decode_kernel(gen, monkeypatch, ps, n_split):
    """The bf16 paged kernel (the split body over the page pool) against
    its plain mirror at the same split and against the plain version on
    the active slots, each within TOL and ULPS per output row; the
    inactive slot returns zeros; two launches agree bit for bit whatever
    order the pieces finish in; and NaN in the trash page changes nothing,
    so it is never read. ``None`` keeps the wrapper's own split_count; 7 is
    more pieces than the 4 row tiles."""
    if n_split is not None:
        monkeypatch.setattr(TD, "split_count", lambda *a: n_split)
    q, kp, vp, bt, pos = _paged_split_case(gen, torch.bfloat16, ps)
    n = TD.n_split(q, bt.shape[1] * ps, paged=True)
    before = TP.launches
    out = TP.paged_decode_attention(q, kp, vp, bt, pos)
    assert TP.launches == before + 1
    act = pos >= 0
    mirror = kref.paged_decode_attention_split_ref(q, kp, vp, bt, pos, n)
    assert_bf16_close(out[act], mirror[act])
    plain = TP.paged_decode_attention_plain(q, kp, vp, bt, pos)
    assert_bf16_close(out[act], plain[act])
    assert bool((out[~act] == 0).all())
    assert torch.equal(out, TP.paged_decode_attention(q, kp, vp, bt, pos))
    kn, vn = kp.clone(), vp.clone()
    kn[-1] = float("nan")
    vn[-1] = float("nan")
    assert torch.equal(out, TP.paged_decode_attention(q, kn, vn, bt, pos))


def test_split_paged_decode_refuses_more_than_16_query_heads(gen):
    """The bf16 body takes a kv head's query heads as one 16-row operand,
    in the standalone and the fused paged kernel alike."""
    q = torch.randn(1, 1, 17, 128, generator=gen, device="cuda").bfloat16()
    kp = torch.randn(5, 16, 1, 128, generator=gen, device="cuda").bfloat16()
    bt = torch.arange(4, dtype=torch.int32, device="cuda")[None]
    pos = torch.tensor([63], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="query heads"):
        TP.paged_decode_attention(q, kp, kp, bt, pos)
    qp = torch.randn(4, 16, 128, generator=gen, device="cuda").bfloat16()
    kpp = torch.randn(2, 16, 128, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="query heads"):
        TB.bullet_attention_paged(qp, kpp, kpp, q, kp, kp, bt, pos, group=2)


# -- the fused launches' schedule: the SM partition by %smid, two queues --

def _many_slots(gen, dtype, paged, b=132, ctx=256, kh=8, g=2, ps=16):
    """A decode batch of ``b`` slots of ``ctx`` rows each on 8 kv heads:
    b·kh = 1056 (slot, kv head) pairs, in bf16 one piece each, in fp32
    ``ctx / PIECE_ROWS`` pieces each; at least four times the decode CTAs
    of a 131-SM share, so every decode CTA takes its first item from its
    own queue. Paged: each slot's pages in order; dense: linear
    positions."""
    q = torch.randn(b, kh, g, 128, generator=gen, device="cuda").to(dtype)
    pos = torch.full((b,), ctx - 1, dtype=torch.int32, device="cuda")
    if paged:
        n_b = ctx // ps
        kp = torch.randn(b * n_b + 1, ps, kh, 128, generator=gen,
                         device="cuda").to(dtype)
        vp = torch.randn(b * n_b + 1, ps, kh, 128, generator=gen,
                         device="cuda").to(dtype)
        bt = torch.arange(b * n_b, dtype=torch.int32,
                          device="cuda").reshape(b, n_b)
        return q, kp, vp, bt, pos
    kc = torch.randn(b, ctx, kh, 128, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(b, ctx, kh, 128, generator=gen, device="cuda").to(dtype)
    kvpos = torch.arange(ctx, dtype=torch.int32,
                         device="cuda")[None].expand(b, ctx).contiguous()
    return q, kc, vc, kvpos, pos


def _fused(gen, dtype, paged, share, record=True):
    q = torch.randn(16, 1000, 128, generator=gen, device="cuda").to(dtype)
    k = torch.randn(8, 1000, 128, generator=gen, device="cuda").to(dtype)
    v = torch.randn(8, 1000, 128, generator=gen, device="cuda").to(dtype)
    dec = _many_slots(gen, dtype, paged)
    fn = TB.bullet_attention_paged if paged else TB.bullet_attention
    return fn(q, k, v, *dec, decode_share=share, group=2, record=record)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("share", [0.0, 0.25, 0.5, 0.75, 1.0])
def test_fused_schedule_partitions_the_sms(gen, dtype, paged, share):
    """From the launch's record: every item ran exactly once, the prefill
    tickets in prefill_order's order; the SMs that took decode items from
    their own queue are n_dec_sm SMs of rank below n_dec_sm, disjoint from
    those that took prefill items from theirs."""
    _, _, sched = _fused(gen, dtype, paged, share)
    torch.cuda.synchronize()
    rec = sched.record.cpu()
    n_dec, code = sched.n_dec, int(dtype == torch.bfloat16)
    assert n_dec == 132 * 8 * (1 if code else 256 // PIECE_ROWS)
    assert bool((rec[:, 0] == 1).all()), "an item ran other than once"
    assert rec[:n_dec, 1].tolist() == list(range(n_dec))
    n_qt = -(-1000 // TB.FLASH_TILES[code][0])
    want = [h * n_qt + (n_qt - 1 - qt if code else qt)
            for h, qt in TB.prefill_order(16, 1000, True, 0, code)]
    assert rec[n_dec:, 1].tolist() == want
    rank_of = {}
    for smid, rank in rec[:, 2:4].tolist():
        assert rank_of.setdefault(smid, rank) == rank
    assert len(set(rank_of.values())) == len(rank_of)
    own = rec[:, 4] == 1
    dec_own = {int(s) for s in rec[:n_dec, 2][own[:n_dec]]}
    pre_own = {int(s) for s in rec[n_dec:, 2][own[n_dec:]]}
    assert len(dec_own) == sched.n_dec_sm == TB.decode_sms(
        share, sched.n_sm, True, True)
    assert all(rank_of[s] < sched.n_dec_sm for s in dec_own)
    assert all(rank_of[s] >= sched.n_dec_sm for s in pre_own)
    assert pre_own and not dec_own & pre_own


def test_fused_schedule_workspace_reads_zero_after_launches(gen):
    """The tickets, the SM table and the leaving count are zero again after
    launches on two streams (each stream has its own workspace), with and
    without a record; no memset between them."""
    side = torch.cuda.Stream()
    outs = [_fused(gen, torch.bfloat16, True, 0.5, record=False)]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs.append(_fused(gen, torch.bfloat16, False, 0.25))
        outs.append(_fused(gen, torch.float32, True, 1.0, record=False))
    outs.append(_fused(gen, torch.float32, False, 0.0))
    torch.cuda.synchronize()
    keys = {k for k in TB._SCHED if k[1] in (
        side.cuda_stream, torch.cuda.current_stream().cuda_stream)}
    assert len(keys) == 2
    for k in keys:
        assert not bool(TB._SCHED[k].any()), k


# ---------------------------------------------------------------------------
# head dim 64: Granite-3.0-2B (G = 4, paged and fused) and SeamlessM4T's
# encoder, cross-attention and decoder (G = 1)
# ---------------------------------------------------------------------------

def _close(out, ref, dtype):
    """TOL, and in bf16 ULPS per output row."""
    if dtype == torch.bfloat16:
        assert_bf16_close(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,sq,sk,g", [
    (True, 64, 64, 4), (True, 383, 383, 4), (False, 129, 129, 1),
    (False, 64, 1024, 1), (False, 8, 300, 4)],
    ids=["causal-64", "causal-383", "encoder", "cross", "cross-short"])
def test_flash_kernel_at_head_dim_64(gen, dtype, causal, sq, sk, g):
    """One 128-byte swizzle chunk a row: causal at Granite's G = 4 (one
    query tile, then tails past the 128-row and 64-key tiles), non-causal
    at Seamless's G = 1 over Sq = Sk (the encoder) and Sq != Sk (the
    cross-attention, a prompt over the encoder's rows)."""
    q = torch.randn(2 * g, sq, 64, generator=gen, device="cuda").to(dtype)
    k = torch.randn(2, sk, 64, generator=gen, device="cuda").to(dtype)
    v = torch.randn(2, sk, 64, generator=gen, device="cuda").to(dtype)
    before = TF.launches
    out = TF.flash_attention(q, k, v, causal=causal, group=g)
    assert TF.launches == before + 1
    _close(out, TF.flash_attention_plain(q, k, v, causal=causal, group=g),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [None, 1, 3])
def test_decode_kernels_at_head_dim_64(gen, monkeypatch, dtype, n_split):
    """Dense decode over the split case's slots and paged decode over the
    paged split case's (G = 4), and dense decode over a cross cache of
    300 rows all attended (G = 1); ``n_split`` forces the bf16 pieces."""
    if n_split is not None:
        monkeypatch.setattr(TD, "split_count", lambda *a: n_split)
    q, kc, vc, kvpos, pos = _split_case(gen, 64, g=4)
    q, kc, vc = q.to(dtype), kc.to(dtype), vc.to(dtype)
    act = torch.tensor([True, True, True, False, True], device="cuda")
    out = TD.decode_attention(q, kc, vc, kvpos, pos)
    _close(out[act], TD.decode_attention_plain(q, kc, vc, kvpos, pos)[act],
           dtype)
    assert bool((out[3] == 0).all())
    qd, kp, vp, bt, ppos = _paged_split_case(gen, dtype, 16, g=4, d=64)
    out = TP.paged_decode_attention(qd, kp, vp, bt, ppos)
    pact = ppos >= 0
    _close(out[pact], TP.paged_decode_attention_plain(
        qd, kp, vp, bt, ppos)[pact], dtype)
    qc = torch.randn(3, 4, 1, 64, generator=gen, device="cuda").to(dtype)
    kx = torch.randn(3, 300, 4, 64, generator=gen, device="cuda").to(dtype)
    vx = torch.randn(3, 300, 4, 64, generator=gen, device="cuda").to(dtype)
    every = torch.arange(300, dtype=torch.int32, device="cuda")[None].expand(
        3, 300).contiguous()
    last = torch.full((3,), 299, dtype=torch.int32, device="cuda")
    _close(TD.decode_attention(qc, kx, vx, every, last),
           TD.decode_attention_plain(qc, kx, vx, every, last), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_fused_kernels_at_head_dim_64_bit_equal_to_standalone(gen, dtype,
                                                              share):
    """Both fused kernels at D = 64 and G = 4 equal flash + their decode
    kernel launched apart, bit for bit."""
    q = torch.randn(16, 300, 64, generator=gen, device="cuda").to(dtype)
    k = torch.randn(4, 300, 64, generator=gen, device="cuda").to(dtype)
    v = torch.randn(4, 300, 64, generator=gen, device="cuda").to(dtype)
    fo = TF.flash_attention(q, k, v, group=4)
    qd, kp, vp, bt, pos = _paged_split_case(gen, dtype, 16, g=4, d=64)
    op, od = TB.bullet_attention_paged(q, k, v, qd, kp, vp, bt, pos,
                                       decode_share=share, group=4)
    assert torch.equal(op, fo)
    assert torch.equal(od, TP.paged_decode_attention(qd, kp, vp, bt, pos))
    qd, kc, vc, kvpos, pos = _dense_case(gen, dtype, False, g=4, d=64)
    op, od = TB.bullet_attention(q, k, v, qd, kc, vc, kvpos, pos,
                                 decode_share=share, group=4)
    assert torch.equal(op, fo)
    assert torch.equal(od, TD.decode_attention(qd, kc, vc, kvpos, pos))


# ---------------------------------------------------------------------------
# the chunked prefill: kernel 1 with a query offset, kernel 6 from a state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,g,sq,off,extra,window", [
    (128, 2, 100, 200, 0, 0), (128, 2, 130, 70, 37, 0),
    (64, 4, 64, 129, 5, 0), (256, 10, 70, 300, 0, 64),
    (128, 6, 129, 257, 11, 100), (128, 1, 1, 383, 0, 0)],
    ids=["tile", "ragged", "d64", "d256-window", "window", "one-row"])
def test_flash_kernel_with_a_query_offset(gen, dtype, d, g, sq, off, extra,
                                          window):
    """A chunk of ``sq`` query rows at positions ``off ..`` over ``off + sq
    + extra`` key rows; the rows past the chunk hold large finite values,
    which no query may attend (a kernel that attends them misses by far
    more than the tolerance). Offsets and chunks on and off the tiles, a
    window that ends before the cached context starts."""
    sk = off + sq + extra
    q = torch.randn(2 * g, sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(2, sk, d, generator=gen, device="cuda")
    v = torch.randn(2, sk, d, generator=gen, device="cuda")
    k[:, off + sq:] = 30.0
    v[:, off + sq:] = 1e3
    k, v = k.to(dtype), v.to(dtype)
    before = TF.launches
    out = TF.flash_attention(q, k, v, window=window, group=g, q_offset=off)
    assert TF.launches == before + 1
    _close(out, TF.flash_attention_plain(q, k, v, window=window, group=g,
                                         q_offset=off), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_chunk_equals_its_rows_of_the_whole_prompt(gen, dtype):
    """The prompt in chunks of 200 rows at their offsets over the keys so
    far gives the whole prompt's rows (within TOL, and in bf16 ULPS)."""
    s = 600
    q = torch.randn(4, s, 128, generator=gen, device="cuda").to(dtype)
    k = torch.randn(2, s, 128, generator=gen, device="cuda").to(dtype)
    v = torch.randn(2, s, 128, generator=gen, device="cuda").to(dtype)
    whole = TF.flash_attention(q, k, v, group=2)
    for off in range(0, s, 200):
        part = TF.flash_attention(q[:, off:off + 200].contiguous(),
                                  k[:, :off + 200].contiguous(),
                                  v[:, :off + 200].contiguous(), group=2,
                                  q_offset=off)
        _close(part, whole[:, off:off + 200], dtype)


def test_flash_wrapper_rejects_a_negative_offset(gen):
    q = torch.randn(2, 8, 128, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="q_offset"):
        TF.flash_attention(q, q, q, q_offset=-1)


def _ssd_case(gen, dtype, b, s, h, p, n, chunk):
    x = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device="cuda"))
    A = -torch.exp(torch.randn(h, generator=gen, device="cuda"))
    B_ = torch.randn(b, s, n, generator=gen, device="cuda").to(dtype)
    C = torch.randn(b, s, n, generator=gen, device="cuda").to(dtype)
    return x, dt, A, B_, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 48, 3, 8, 4, 16), (1, 200, 4, 64, 128, 256),
    (2, 300, 3, 40, 16, 128)])
def test_ssd_kernel_from_a_starting_state(gen, dtype, b, s, h, p, n, chunk):
    """From a random state0: against the plain version (SSD limits), and
    in bf16 against the mirror, whose entering state is rounded to bf16
    for chunk 0's inter term as the kernel's is."""
    x, dt, A, B_, C = _ssd_case(gen, dtype, b, s, h, p, n, chunk)
    xw, cum, bc, cc = ops.ssd_chunk_inputs(x, dt, A, B_, C, chunk=chunk)
    state0 = torch.randn(b, h, p, n, generator=gen, device="cuda")
    before = TS.launches
    y, st = TS.ssd_scan(xw, cum, bc, cc, state0)
    assert TS.launches == before + 1
    ry, rst = TS.ssd_scan_plain(xw, cum, bc, cc, state0)
    assert _scaled_err(y, ry) <= (1e-4 if dtype == torch.float32 else 1e-2)
    assert _scaled_err(st, rst) <= 1e-4
    if dtype == torch.bfloat16:
        my, mst = kref.ssd_scan_tc_ref(xw, cum, bc, cc, state0)
        assert _scaled_err(y, my) <= SSD_TC_Y_TOL
        assert _scaled_err(st, mst) <= SSD_TC_STATE_TOL


@pytest.mark.parametrize("s1", [1, 37, 200])
def test_ssd_scan_split_at_any_row_equals_the_whole_scan(gen, s1):
    """fp32: the scan of S rows equals the scan of the first s1 rows
    followed by the scan of the rest from its final state (each part
    padded to its own chunks), within 1e-4 of scale."""
    b, s, h, p, n, chunk = 2, 300, 3, 40, 16, 128
    x, dt, A, B_, C = _ssd_case(gen, torch.float32, b, s, h, p, n, chunk)
    D = torch.randn(h, generator=gen, device="cuda")
    y, st = ops.ssd_scan_op(x, dt, A, B_, C, D, chunk=chunk)
    y1, st1 = ops.ssd_scan_op(x[:, :s1], dt[:, :s1], A, B_[:, :s1],
                              C[:, :s1], D, chunk=chunk)
    y2, st2 = ops.ssd_scan_op(x[:, s1:], dt[:, s1:], A, B_[:, s1:],
                              C[:, s1:], D, chunk=chunk, state0=st1)
    assert _scaled_err(torch.cat([y1, y2], 1), y) <= 1e-4
    assert _scaled_err(st2, st) <= 1e-4


def test_ssd_wrapper_rejects_a_state_it_cannot_take(gen):
    xw = torch.randn(1, 1, 16, 2, 8, generator=gen, device="cuda")
    cum = torch.zeros(1, 1, 16, 2, device="cuda")
    bc = torch.randn(1, 1, 16, 4, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="state0"):
        TS.ssd_scan(xw, cum, bc, bc, torch.zeros(1, 2, 8, 5, device="cuda"))
    with pytest.raises(TypeError, match="float32"):
        TS.ssd_scan(xw, cum, bc, bc,
                    torch.zeros(1, 2, 8, 4, device="cuda").double())


# ---------------------------------------------------------------------------
# the fp32 bodies: register-tiled flash, one split decode body for both
# caches (pieces of PIECE_ROWS rows, merged in piece order)
# ---------------------------------------------------------------------------

#: the fp32 split decode against its mirror (the same pieces and merge,
#: the sums inside a piece in another order: a few fp32 ulps of the
#: outputs' scale, well under TOL)
MIRROR_TOL = 1e-5


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_split_paged_decode_same_at_every_table_width_fp32(gen, ps):
    """fp32: a slot's paged decode is bit-equal whatever the table's width
    (widened by trash-page columns to 2 and 4 times 2048 rows, which
    raises the launch's piece count) and whatever the other slots hold
    (each slot with the others inactive and the table cut to its own
    bucket)."""
    contexts = (1, 65, 300, 1000, 2000, 0)
    q, kp, vp, bt, pos = _paged_split_case(gen, torch.float32, ps,
                                           contexts=contexts, rows=2048)
    base = TP.paged_decode_attention(q, kp, vp, bt, pos)
    trash = kp.shape[0] - 1
    counts = {fp32_pieces(bt.shape[1] * ps)}
    for f in (2, 4):
        wide = torch.full((bt.shape[0], f * bt.shape[1]), trash,
                          dtype=torch.int32, device="cuda")
        wide[:, :bt.shape[1]] = bt
        counts.add(fp32_pieces(wide.shape[1] * ps))
        out = TP.paged_decode_attention(q, kp, vp, wide, pos)
        assert torch.equal(out, base), f
    assert len(counts) == 3, counts
    for i, c in enumerate(contexts):
        if not c:
            continue
        n_b = 1 << (-(-c // ps) - 1).bit_length()
        alone = torch.full_like(pos, -1)
        alone[i] = pos[i]
        own = TP.paged_decode_attention(q, kp, vp,
                                        bt[:, :n_b].contiguous(), alone)
        assert torch.equal(own[i], base[i]), i
    assert bool((base[-1] == 0).all())


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", ["split", "linear", "ring"])
def test_fp32_split_dense_decode_matches_its_mirror(gen, d, case):
    """The fp32 dense body against ``ref.decode_attention_fp32_split_ref``
    within MIRROR_TOL and the plain version within TOL on the slots with
    an attended row, zeros on the others, and bit for bit the same on a
    second launch: the split case's five slots over S = 200 (four pieces;
    a wrapped ring, holes, no attended row, one attended row), and the
    dense case's linear and scrambled-ring slots over S = 72."""
    if case == "split":
        q, kc, vc, kvpos, pos = _split_case(gen, d)
        q, kc, vc = q.float(), kc.float(), vc.float()
    else:
        q, kc, vc, kvpos, pos = _dense_case(gen, torch.float32,
                                            case == "ring", d=d)
    before = TD.launches
    out = TD.decode_attention(q, kc, vc, kvpos, pos)
    assert TD.launches == before + 1
    act = ((kvpos >= 0) & (kvpos <= pos[:, None])).any(dim=1)
    mirror = kref.decode_attention_fp32_split_ref(q, kc, vc, kvpos, pos)
    torch.testing.assert_close(out[act], mirror[act], atol=MIRROR_TOL,
                               rtol=0)
    plain = TD.decode_attention_plain(q, kc, vc, kvpos, pos)
    torch.testing.assert_close(out[act], plain[act], atol=TOL[torch.float32],
                               rtol=0)
    assert bool((out[~act] == 0).all())
    assert torch.equal(out, TD.decode_attention(q, kc, vc, kvpos, pos))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("ps", [8, 16, 32])
def test_fp32_split_paged_decode_matches_its_mirror(gen, d, ps):
    """The fp32 paged body against
    ``ref.paged_decode_attention_fp32_split_ref`` within MIRROR_TOL and the
    plain version within TOL on the active slots (contexts up to 1000: 16
    pieces), the inactive slot zeros, and NaN in the trash page changes
    nothing, so it is never read."""
    q, kp, vp, bt, pos = _paged_split_case(
        gen, torch.float32, ps, d=d, rows=1024,
        contexts=(1, 64, 65, 150, 1000, 0))
    out = TP.paged_decode_attention(q, kp, vp, bt, pos)
    act = pos >= 0
    mirror = kref.paged_decode_attention_fp32_split_ref(q, kp, vp, bt, pos)
    torch.testing.assert_close(out[act], mirror[act], atol=MIRROR_TOL,
                               rtol=0)
    plain = TP.paged_decode_attention_plain(q, kp, vp, bt, pos)
    torch.testing.assert_close(out[act], plain[act], atol=TOL[torch.float32],
                               rtol=0)
    assert bool((out[~act] == 0).all())
    kn, vn = kp.clone(), vp.clone()
    kn[-1] = float("nan")
    vn[-1] = float("nan")
    assert torch.equal(out, TP.paged_decode_attention(q, kn, vn, bt, pos))


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_fused_fp32_bit_equal_to_standalone_over_many_pieces(gen, share):
    """Both fused kernels in fp32 over slots of up to 1000 rows (16 pieces
    a slot): bit-equal to flash + the standalone decode launched apart,
    the paged and the dense cache (linear positions) alike."""
    q = torch.randn(8, 300, 128, generator=gen, device="cuda")
    k = torch.randn(4, 300, 128, generator=gen, device="cuda")
    v = torch.randn(4, 300, 128, generator=gen, device="cuda")
    fo = TF.flash_attention(q, k, v, group=2)
    qd, kp, vp, bt, pos = _paged_split_case(
        gen, torch.float32, 16, rows=1024, contexts=(1, 64, 65, 150, 1000, 0))
    op, od = TB.bullet_attention_paged(q, k, v, qd, kp, vp, bt, pos,
                                       decode_share=share, group=2)
    assert torch.equal(op, fo)
    assert torch.equal(od, TP.paged_decode_attention(qd, kp, vp, bt, pos))
    b = bt.shape[0]
    kc = kp[bt.long()].reshape(b, -1, *kp.shape[2:]).contiguous()
    vc = vp[bt.long()].reshape(b, -1, *vp.shape[2:]).contiguous()
    kvpos = torch.arange(kc.shape[1], dtype=torch.int32,
                         device="cuda")[None].expand(b, -1).contiguous()
    op, od = TB.bullet_attention(q, k, v, qd, kc, vc, kvpos, pos,
                                 decode_share=share, group=2)
    assert torch.equal(op, fo)
    dense = TD.decode_attention(qd, kc, vc, kvpos, pos)
    assert torch.equal(od, dense)
    act = pos >= 0
    assert torch.equal(dense[act], TP.paged_decode_attention(
        qd, kp, vp, bt, pos)[act])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 383])
def test_fp32_flash_at_tile_edges(gen, d, s):
    """S below, at and off a multiple of the 64-row query tile and the
    64-key K/V tile, causal, G = 2."""
    q = torch.randn(4, s, d, generator=gen, device="cuda")
    k = torch.randn(2, s, d, generator=gen, device="cuda")
    v = torch.randn(2, s, d, generator=gen, device="cuda")
    before = TF.launches
    out = TF.flash_attention(q, k, v, group=2)
    assert TF.launches == before + 1
    torch.testing.assert_close(out, TF.flash_attention_plain(q, k, v, group=2),
                               atol=TOL[torch.float32], rtol=0)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("window", [1, 17, 63])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_flash_window_shorter_than_a_tile(gen, d, window, causal):
    """Windows shorter than one 64-key tile: every tile crosses an edge
    of some row's window, and a row's first tiles are masked whole."""
    q = torch.randn(4, 300, d, generator=gen, device="cuda")
    k = torch.randn(2, 300, d, generator=gen, device="cuda")
    v = torch.randn(2, 300, d, generator=gen, device="cuda")
    out = TF.flash_attention(q, k, v, causal=causal, window=window, group=2)
    ref = TF.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   group=2)
    torch.testing.assert_close(out, ref, atol=TOL[torch.float32], rtol=0)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq,off,extra,window", [
    (64, 128, 0, 0), (100, 200, 7, 0), (1, 383, 0, 0), (129, 70, 37, 0),
    (70, 300, 0, 40)])
def test_fp32_flash_at_a_query_offset(gen, d, sq, off, extra, window):
    """A chunk of ``sq`` rows at positions ``off ..`` over ``off + sq +
    extra`` keys, the rows past the chunk at large finite values no query
    may attend; offsets on and off the tiles, a window that ends before
    the cached context starts. The chunk's rows also equal the whole
    prompt's bit for bit: key tiles start at multiples of 64 from key 0,
    and a tile masked whole for a row leaves it unchanged exactly."""
    sk = off + sq + extra
    q = torch.randn(4, sq, d, generator=gen, device="cuda")
    k = torch.randn(2, sk, d, generator=gen, device="cuda")
    v = torch.randn(2, sk, d, generator=gen, device="cuda")
    k[:, off + sq:] = 30.0
    v[:, off + sq:] = 1e3
    out = TF.flash_attention(q, k, v, window=window, group=2, q_offset=off)
    torch.testing.assert_close(out, TF.flash_attention_plain(
        q, k, v, window=window, group=2, q_offset=off),
        atol=TOL[torch.float32], rtol=0)
    qw = torch.randn(4, off + sq, d, generator=gen, device="cuda")
    qw[:, off:] = q
    whole = TF.flash_attention(qw, k[:, :off + sq].contiguous(),
                               v[:, :off + sq].contiguous(), window=window,
                               group=2)
    assert torch.equal(out, whole[:, off:])
