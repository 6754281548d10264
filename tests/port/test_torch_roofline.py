"""The port's roofline counter (``repro_torch.launch.roofline``) and the
kernels' cost formulas (``repro_torch.kernels.cost``) on the CPU:
tests/test_roofline.py's five recipes through the counter with the same
expected numbers; every kernel wrapper's charge on meta tensors (exactly
the formulas' numbers, no nested op counted, empty outputs of the CPU
version's shapes and dtypes) and on CPU tensors (the plain version's ops
not counted, the decode kernels charging the rows their slots attend); the
temp peak of a known chain; and reduced Qwen3's prefill and decode step,
whose FLOPs outside the kernels equal the JAX ``analyze_hlo`` dot FLOPs of
the same jitted functions less the attention dots XLA's masked path
computes (tolerance 0: both count the same products)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.roofline import analyze_hlo
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import bullet_attention as BA
from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_decode_attention as PD
from repro_torch.kernels import rglru_scan as RK
from repro_torch.kernels import ssd_scan as SK
from repro_torch.launch.roofline import Counter, analyze, view_bytes
from repro_torch.models import transformer as T

META = "meta"


def _empty(*shape, dtype=torch.float32, device=META):
    return torch.empty(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# tests/test_roofline.py's recipes
# ---------------------------------------------------------------------------

def test_shape_bytes():
    assert view_bytes(_empty(32, 256)) == 32 * 256 * 4
    assert view_bytes(_empty(2, 4, 8, dtype=torch.bfloat16)) == 64 * 2
    assert view_bytes(_empty(dtype=torch.int32)) == 4
    assert (view_bytes(_empty(8)) + view_bytes(_empty(4, 4,
                                                      dtype=torch.bfloat16))
            == 32 + 32)
    assert view_bytes(_empty(16, dtype=torch.bool)) == 16
    # a broadcast dim is read once
    assert view_bytes(_empty(1, 16).expand(64, 16)) == 16 * 4


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_dot_flops_exact(device):
    rep = analyze(lambda a, b: a @ b, _empty(64, 128, device=device),
                  _empty(128, 32, device=device))
    assert rep.flops == 2 * 64 * 128 * 32
    assert rep.dots == 1


def test_scan_trip_count_multiplies():
    def step(w, x):
        c = x
        for _ in range(7):
            c = torch.tanh(c @ w)
        return c.sum()
    rep = analyze(step, _empty(64, 64), _empty(8, 64))
    assert rep.flops == pytest.approx(7 * 2 * 8 * 64 * 64, rel=0.01)
    assert rep.dots == 7


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_memory_traffic_sane_for_elementwise(device):
    rep = analyze(lambda a: (a * 2 + 1).sum(), _empty(1 << 20, device=device))
    nbytes = (1 << 20) * 4
    # must at least read the input once, and not explode
    assert nbytes * 0.9 <= rep.hbm_bytes <= nbytes * 6


def test_terms_and_dominant():
    rep = analyze(lambda a, b: a @ b, _empty(16, 16), _empty(16, 16))
    t = rep.terms()
    assert set(t) == {"compute_s", "memory_s", "collective_s"}
    assert all(v >= 0 for v in t.values())
    assert t["collective_s"] == 0.0
    assert rep.dominant() in t
    assert rep.to_json()["dominant"] == rep.dominant()
    assert rep.roofline_s() == max(t.values())
    # fp32 products at the CUDA cores' peak, bf16 at the tensor cores'
    bf = analyze(lambda a, b: a @ b, _empty(16, 16, dtype=torch.bfloat16),
                 _empty(16, 16, dtype=torch.bfloat16))
    assert t["compute_s"] == rep.flops / 67e12
    assert bf.terms()["compute_s"] == bf.flops / 989e12


# ---------------------------------------------------------------------------
# the cost formulas
# ---------------------------------------------------------------------------

def test_causal_pairs_is_the_sum_over_query_rows():
    for s, sk, window, off in itertools.product(
            (1, 7, 64, 100), (1, 64, 200), (0, 1, 16, 300), (0, 5, 150)):
        want = sum(min(off + i + 1, window or sk) for i in range(s))
        assert cost.causal_pairs(s, sk, window, off) == want, \
            (s, sk, window, off)


def test_bound_ms_is_the_larger_time():
    ms, by = cost.bound_ms(3.35e9, 1.0, torch.bfloat16)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = cost.bound_ms(1.0, 67e9, torch.float32)
    assert (ms, by) == (pytest.approx(1.0), "operations")


# ---------------------------------------------------------------------------
# the kernel charge
# ---------------------------------------------------------------------------

def _attn_inputs(device, dtype=torch.float32, seed=0):
    """Small attention operands: q (B·H, S, D) with H = 4 on K = 2, a
    16-row paged pool and a dense cache, decode slots at four positions
    (one inactive)."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g).to(dtype).to(device)
    b, h, kh, s, d, ps, n_b = 4, 4, 2, 24, 64, 8, 4
    pos = torch.tensor([0, 9, 31, -1], dtype=torch.int32).to(device)
    bt = torch.arange(b * n_b, dtype=torch.int32).reshape(b, n_b).to(device)
    kvpos = torch.arange(32, dtype=torch.int32).repeat(b, 1).to(device)
    return dict(
        q=rn(b * h, s, d), k=rn(b * kh, s, d), v=rn(b * kh, s, d),
        qd=rn(b, kh, h // kh, d), pages=rn(b * n_b + 1, ps, kh, d),
        vpages=rn(b * n_b + 1, ps, kh, d), bt=bt, pos=pos,
        kc=rn(b, 32, kh, d), vc=rn(b, 32, kh, d), kvpos=kvpos, group=h // kh)


def _scan_inputs(device, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g).to(device)
    b, nc, q, h, p, n = 1, 2, 16, 3, 4, 8
    return dict(xw=rn(b, nc, q, h, p), cum=-rn(b, nc, q, h).abs(),
                B=rn(b, nc, q, n), C=rn(b, nc, q, n), st=rn(b, h, p, n),
                a=torch.rand(2, 20, 16, generator=g).to(device),
                bb=rn(2, 20, 16), h0=rn(2, 16))


#: name -> (call on the inputs, the price the formulas give)
KERNELS = {
    "flash_attention": (
        lambda x: FA.flash_attention(x["q"], x["k"], x["v"], window=5,
                                     group=x["group"]),
        lambda x: cost.flash_price(x["q"], x["k"], True, 5, x["group"])),
    "flash_attention_bwd": (
        lambda x: FA.flash_attention_bwd(x["q"], x["k"], x["v"], x["q"],
                                         x["q"], group=x["group"]),
        lambda x: cost.flash_bwd_price(x["q"], x["k"], True, 0,
                                       x["group"])),
    "paged_decode_attention": (
        lambda x: PD.paged_decode_attention(x["qd"], x["pages"],
                                            x["vpages"], x["bt"], x["pos"]),
        lambda x: cost.paged_price(x["qd"], x["pos"], x["pages"], x["bt"])),
    "decode_attention": (
        lambda x: DA.decode_attention(x["qd"], x["kc"], x["vc"], x["kvpos"],
                                      x["pos"]),
        lambda x: cost.dense_price(x["qd"], x["kvpos"], x["pos"])),
    "bullet_attention_paged": (
        lambda x: BA.bullet_attention_paged(
            x["q"], x["k"], x["v"], x["qd"], x["pages"], x["vpages"],
            x["bt"], x["pos"], group=x["group"]),
        lambda x: cost.bullet_paged_price(x["q"], x["k"], True, 0,
                                          x["group"], x["qd"], x["pos"],
                                          x["pages"], x["bt"])),
    "bullet_attention": (
        lambda x: BA.bullet_attention(
            x["q"], x["k"], x["v"], x["qd"], x["kc"], x["vc"], x["kvpos"],
            x["pos"], group=x["group"]),
        lambda x: cost.bullet_price(x["q"], x["k"], True, 0, x["group"],
                                    x["qd"], x["kvpos"], x["pos"])),
    "ssd_scan": (
        lambda x: SK.ssd_scan(x["xw"], x["cum"], x["B"], x["C"], x["st"]),
        lambda x: cost.ssd_price(x["xw"], x["B"], x["st"])),
    "ssd_scan_bwd": (
        lambda x: SK.ssd_scan_bwd(x["xw"], x["cum"], x["B"], x["C"], None,
                                  x["xw"], x["st"]),
        lambda x: cost.ssd_bwd_price(x["xw"], x["B"], None)),
    "rglru_scan": (
        lambda x: RK.rglru_scan(x["a"], x["bb"], x["h0"]),
        lambda x: cost.rglru_price(x["a"], x["h0"])),
    "rglru_scan_bwd": (
        lambda x: RK.rglru_scan_bwd(x["a"], x["bb"], None, x["bb"], None),
        lambda x: cost.rglru_bwd_price(x["a"], None)),
}


def _inputs(device):
    return {**_attn_inputs(device), **_scan_inputs(device)}


def _outputs(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))
            if t is not None]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_charge_on_meta(name):
    """A meta call charges exactly the formulas' numbers, counts none of
    the wrapper's own ops, and returns empty outputs of the CPU version's
    shapes and dtypes."""
    call, price = KERNELS[name]
    x = {k: (v.to(META) if isinstance(v, torch.Tensor) else v)
         for k, v in _inputs("cpu").items()}
    with Counter() as c:
        out = call(x)
    n_bytes, n_ops, dtype = price(x)
    rep = c.report
    assert rep.kernels == {name: {"launches": 1, "operations": n_ops,
                                  "bytes": n_bytes}}
    assert rep.flops == n_ops and rep.hbm_bytes == n_bytes
    assert rep.dots == 0 and c.ops == {}
    assert rep.flops_by_dtype == {str(dtype).replace("torch.", ""): n_ops}
    ref = _outputs(call(_inputs("cpu")))
    got = _outputs(out)
    assert [(t.device.type, t.shape, t.dtype) for t in got] == \
        [(META, r.shape, r.dtype) for r in ref]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_charge_on_cpu_skips_the_plain_ops(name):
    call, price = KERNELS[name]
    x = _inputs("cpu")
    with Counter() as c:
        call(x)
    n_bytes, n_ops, _ = price(x)
    assert c.report.kernels[name]["operations"] == n_ops
    assert c.report.flops == n_ops and c.report.hbm_bytes == n_bytes
    assert c.report.dots == 0 and c.ops == {}


def test_decode_charges_attended_rows_on_cpu_and_every_row_on_meta():
    x = _attn_inputs("cpu")
    d = x["qd"].shape[-1] * x["qd"].shape[1] * x["qd"].shape[2]
    # paged: slots at positions 0, 9, 31 attend 1 + 10 + 32 rows; on meta
    # every slot attends its block table's 4 pages of 8 rows
    _, ops, _ = cost.paged_price(x["qd"], x["pos"], x["pages"], x["bt"])
    assert ops == 4 * d * 43
    xm = {k: (v.to(META) if isinstance(v, torch.Tensor) else v)
          for k, v in x.items()}
    _, ops, _ = cost.paged_price(xm["qd"], xm["pos"], xm["pages"], xm["bt"])
    assert ops == 4 * d * 4 * 32
    # dense: rows 0..pos of the linear cache
    _, ops, _ = cost.dense_price(x["qd"], x["kvpos"], x["pos"])
    assert ops == 4 * d * 43
    _, ops, _ = cost.dense_price(xm["qd"], xm["kvpos"], xm["pos"])
    assert ops == 4 * d * 4 * 32


def test_no_charge_without_a_counter():
    assert cost.COUNTER is None
    x = _attn_inputs("cpu")
    with Counter() as c:
        assert cost.COUNTER is c
    assert cost.COUNTER is None
    FA.flash_attention(x["q"], x["k"], x["v"], group=x["group"])
    assert c.report.kernels == {}


# ---------------------------------------------------------------------------
# the temp peak
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_temp_peak_of_a_known_chain(device):
    def chain(x):
        y = x * 2                      # +4000 bytes
        z = y * 3                      # +4000: 8000, the peak
        del y                          # 4000
        z.add_(1)                      # in place: nothing new
        v = z.view(10, 100)            # a view: nothing new
        return v.sum()                 # +4
    x = _empty(1000, device=device)
    with Counter() as c:
        out = chain(x)
    assert c.peak_bytes == 8000
    assert c.live_bytes == out.untyped_storage().nbytes() == 4


# ---------------------------------------------------------------------------
# a whole step against the JAX analyze_hlo
# ---------------------------------------------------------------------------

B, S = 2, 64


@pytest.fixture(scope="module")
def qwen3():
    jc = jax_config("qwen3-1.7b").reduced()
    tc = get_config("qwen3-1.7b").reduced()
    jp = JT.init_params(jc, jax.random.PRNGKey(0), jnp.float32)
    return jc, tc, jp, bridge.params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


def _attention_dots(tc, sq, sk):
    """QKᵀ and PV over every (query, key) pair of every layer, as XLA's
    masked path computes them."""
    return tc.n_layers * 2 * 2 * B * tc.n_heads * sq * sk * tc.head_dim


def test_prefill_flops_outside_kernels_equal_jax_dots(qwen3):
    jc, tc, jp, tp = qwen3
    cache = JT.init_cache(jc, B, S, jnp.float32)
    toks = jnp.zeros((B, S), jnp.int32)
    lens = jnp.full((B,), S, jnp.int32)
    co = jax.jit(lambda p, t, n, c: JT.prefill(p, t, n, c, jc)).lower(
        jp, toks, lens, cache).compile()
    want = analyze_hlo(co.as_text()).flops - _attention_dots(tc, S, S)
    tcache = T.init_cache(tc, B, S, torch.float32, device="cpu")
    with Counter() as c:
        T.prefill(tp, torch.zeros(B, S, dtype=torch.int32),
                  torch.full((B,), S, dtype=torch.int32), tcache, None, tc)
    rep = c.report
    assert rep.flops - rep.kernel_flops == want
    assert rep.kernels["flash_attention"]["launches"] == tc.n_layers


def test_decode_flops_outside_kernels_equal_jax_dots(qwen3):
    jc, tc, jp, tp = qwen3
    cache = JT.init_cache(jc, B, S, jnp.float32)
    pos = jnp.full((B,), S - 1, jnp.int32)
    co = jax.jit(lambda p, c, t, q: JT.decode_step(p, c, t, q, jc)).lower(
        jp, cache, jnp.zeros((B, 1), jnp.int32), pos).compile()
    want = analyze_hlo(co.as_text()).flops - _attention_dots(tc, 1, S)
    tcache = T.init_cache(tc, B, S, torch.float32, device="cpu")
    with Counter() as c:
        T.decode_step(tp, tcache, torch.zeros(B, 1, dtype=torch.int32),
                      torch.full((B,), S - 1, dtype=torch.int32), tc)
    rep = c.report
    assert rep.flops - rep.kernel_flops == want
    assert rep.kernels["decode_attention"]["launches"] == tc.n_layers
