"""The CUDA kernels against their plain versions on the card (marked
``cuda``; they skip where no CUDA device is present). Run on a GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/port

Tolerances: fp32 atol 1e-4 (kernel sums in another order), bf16 atol 2e-2
(the plain version rounds probabilities to bf16, the kernel keeps fp32)."""

import pytest
import torch

from repro_torch.kernels import bullet_attention as TB
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import paged_decode_attention as TP

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
