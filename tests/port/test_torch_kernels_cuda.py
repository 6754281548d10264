"""The CUDA kernels against their plain versions on the card (marked
``cuda``; they skip where no CUDA device is present). Run on a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/port

Tolerances: fp32 atol 1e-4 (kernel sums in another order), bf16 atol 2e-2
(the plain version rounds probabilities to bf16, the kernel keeps fp32).
The SSD scan is compared over its output's scale max(1, max|plain|): fp32
1e-4, bf16 y 1e-2 (y is rounded to bf16), the fp32 state 1e-4. The RG-LRU
scan runs the plain version's arithmetic in the same order: equal to it
bit for bit."""

import pytest
import torch

from repro_torch.kernels import bullet_attention as TB
from repro_torch.kernels import decode_attention as TD
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as TP
from repro_torch.kernels import rglru_scan as TR
from repro_torch.kernels import ssd_scan as TS

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(gen, dtype):
    q, kp, vp, bt, pos = _decode_case(gen, dtype)
    out = TP.paged_decode_attention(q, kp, vp, bt, pos)
    ref = TP.paged_decode_attention_plain(q, kp, vp, bt, pos)
    act = pos >= 0
    torch.testing.assert_close(out[act].float(), ref[act].float(),
                               atol=TOL[dtype], rtol=0)
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
    # a slot with no attended row returns zeros, as the TPU kernel does
    none = torch.full_like(kvpos, -1)
    assert bool((TD.decode_attention(q, kc, vc, none, pos) == 0).all())


def test_dense_decode_equals_paged_decode_bit_for_bit(gen):
    """With linear positions the dense kernel walks the same 16-row tiles
    as the paged kernel over 16-row pages."""
    q, kp, vp, bt, pos = _decode_case(gen, torch.float32)
    act = pos >= 0
    b, n_b = bt.shape
    kc = kp[bt.long()].reshape(b, -1, *kp.shape[2:]).contiguous()
    vc = vp[bt.long()].reshape(b, -1, *vp.shape[2:]).contiguous()
    kvpos = torch.arange(kc.shape[1], dtype=torch.int32,
                         device="cuda")[None].expand(b, -1).contiguous()
    dense = TD.decode_attention(q, kc, vc, kvpos, pos)
    paged = TP.paged_decode_attention(q, kp, vp, bt, pos)
    assert torch.equal(dense[act], paged[act])


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
    with pytest.raises(ValueError, match="head dim"):
        TF.flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                           k[..., :64].contiguous(), group=2)
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
