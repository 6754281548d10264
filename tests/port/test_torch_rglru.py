"""The port's RG-LRU / RecurrentGemma path against the JAX package, on the
CPU in fp32 with the same seeded numpy inputs (params bridged through
numpy): the plain RG-LRU scan and ``rglru_scan_op`` against the Pallas
``rglru_scan_op`` (interpret mode) and the sequential oracle (atol 1e-5,
tests/test_kernels.py's tolerance), the RG-LRU block in prefill, prefill
from a state and decode (1e-5 of the output's scale), sliding-window
prefill and ring decode through many wraps, and reduced
``recurrentgemma-2b`` (its ``pattern_tail`` included) through ``prefill``
and ``decode_step`` (rtol 1e-4, atol 1e-4; greedy tokens equal).

Prefill batches are right-padded to their longest prompt. The port's
RG-LRU prefill returns each row's state at its own length, the JAX
package's the state after the padded tail (ROADMAP §3), so a mixed-length
batch is held against JAX runs that prefill one prompt at a time, and the
split is pinned."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.config import ServerConfig as JServerConfig
from repro.core.engine import BulletServer as JServer
from repro.kernels import ref as JR
from repro.kernels import rglru_scan_op as jax_rglru_scan_op
from repro.launch import serve as jax_serve
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import rglru as JG
from repro.serving.request import SLO as JSLO
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import SWA, BlockSpec
from repro_torch.core.config import ServerConfig
from repro_torch.core.engine import BulletServer
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import rglru_scan as TK
from repro_torch.launch import serve
from repro_torch.models import rglru as TG
from repro_torch.models import transformer as T
from repro_torch.serving.request import SLO

SCAN_ATOL = 1e-5
ATOL = 1e-4
ARCH = "recurrentgemma-2b"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


def _scaled_err(out, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(_np(out) - ref).max() / max(1.0, np.abs(ref).max()))


def _scan_inputs(b, s, w, seed=0, with_h0=False):
    """a in (0, 1) (a sigmoid, as the gates give it), b ~ N(0, 1), h0."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))
    bb = rng.standard_normal((b, s, w))
    h0 = rng.standard_normal((b, w)) if with_h0 else None
    cast = lambda x: None if x is None else x.astype(np.float32)  # noqa: E731
    return cast(a), cast(bb), cast(h0)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("b,s,w", [(2, 32, 16), (4, 17, 8), (1, 64, 128),
                                   (3, 20, 24)])
def test_plain_scan_and_op_match_jax(b, s, w, with_h0):
    a, bb, h0 = _scan_inputs(b, s, w, with_h0=with_h0)
    jh0 = None if h0 is None else jnp.asarray(h0)
    jy, jh = jax_rglru_scan_op(jnp.asarray(a), jnp.asarray(bb), jh0,
                               interpret=True)
    ry, rh = JR.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb), jh0)
    y, h = ops.rglru_scan_op(_t(a), _t(bb), None if h0 is None else _t(h0))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert tuple(h.shape) == (b, w)
    for ref_y, ref_h in ((jy, jh), (ry, rh)):
        np.testing.assert_allclose(_np(y), np.asarray(ref_y), atol=SCAN_ATOL)
        np.testing.assert_allclose(_np(h), np.asarray(ref_h), atol=SCAN_ATOL)
    # the port's copy of the sequential oracle
    oy, oh = TR.rglru_scan_ref(_t(a), _t(bb), None if h0 is None else _t(h0))
    np.testing.assert_allclose(_np(oy), np.asarray(ry), atol=SCAN_ATOL)
    np.testing.assert_allclose(_np(oh), np.asarray(rh), atol=SCAN_ATOL)


def test_plain_scan_keeps_the_state_fp32_under_bf16():
    """bf16 inputs: y in bf16, h_T the fp32 state (not y[:, -1] rounded)."""
    a, bb, h0 = _scan_inputs(2, 40, 8, seed=1, with_h0=True)
    y, h = TK.rglru_scan(_t(a).bfloat16(), _t(bb).bfloat16(), _t(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    ref_y, ref_h = TR.rglru_scan_ref(_t(a).bfloat16().float(),
                                     _t(bb).bfloat16().float(), _t(h0))
    np.testing.assert_allclose(_np(h), _np(ref_h), atol=SCAN_ATOL)
    torch.testing.assert_close(y, ref_y.bfloat16(), atol=0, rtol=0)
    assert not torch.equal(h, y[:, -1].float())


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 161),
                        [19.9, 20.0, 20.1, 25.0]]).astype(np.float32)
    np.testing.assert_allclose(_np(TG._softplus(_t(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the block and the model, reduced recurrentgemma-2b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """Reduced recurrentgemma-2b: pattern (R, R, L), tail (R, R), window
    64, D = 32, 4 query heads on 1 kv head, lru width 64."""
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _rglru_params(jparams, params, r=0):
    jp = jax.tree.map(lambda a: a[r], jparams["blocks"][0])
    return jp, T.params_at(params["blocks"][0], r)


def test_rglru_block_prefill_and_decode_match_jax(model):
    jcfg, cfg, jparams, params = model
    jp, tp = _rglru_params(jparams, params)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    jy, jst = JG.rglru_block(jnp.asarray(x), jp, jcfg)
    y, st = TG.rglru_block(_t(x), tp, cfg)
    assert _scaled_err(y, jy) <= 1e-5
    assert _scaled_err(st.conv, jst.conv) <= 1e-5
    assert _scaled_err(st.hidden, jst.hidden) <= 1e-5
    assert st.hidden.dtype == torch.float32
    for _ in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = JG.rglru_block(jnp.asarray(xt), jp, jcfg, state=jst,
                                 decode=True)
        y, st = TG.rglru_block(_t(xt), tp, cfg, state=st, decode=True)
        assert _scaled_err(y, jy) <= 1e-5
        assert _scaled_err(st.conv, jst.conv) <= 1e-5
        assert _scaled_err(st.hidden, jst.hidden) <= 1e-5


def test_rglru_block_prefill_from_a_state_matches_jax(model):
    """A prefill that continues a state: h0 and the conv window go in."""
    jcfg, cfg, jparams, params = model
    jp, tp = _rglru_params(jparams, params)
    rng = np.random.default_rng(7)
    w, kw = cfg.lru_width, cfg.rglru_conv_width
    conv = rng.standard_normal((2, kw - 1, w)).astype(np.float32)
    hid = rng.standard_normal((2, w)).astype(np.float32)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jy, jst = JG.rglru_block(jnp.asarray(x), jp, jcfg, state=JG.RGLRUState(
        jnp.asarray(conv), jnp.asarray(hid)))
    y, st = TG.rglru_block(_t(x), tp, cfg,
                           state=TG.RGLRUState(_t(conv), _t(hid)))
    assert _scaled_err(y, jy) <= 1e-5
    assert _scaled_err(st.conv, jst.conv) <= 1e-5
    assert _scaled_err(st.hidden, jst.hidden) <= 1e-5


def test_rglru_block_uses_the_tanh_gelu(model, monkeypatch):
    """The port's block is JAX's only with GELU's tanh approximation (what
    ``jax.nn.gelu`` defaults to): with the exact GELU in its place the
    block drifts far past the tolerance of the tests above."""
    jcfg, cfg, jparams, params = model
    jp, tp = _rglru_params(jparams, params)
    x = np.random.default_rng(8).standard_normal(
        (1, 12, cfg.d_model)).astype(np.float32) * 3
    jy, _ = JG.rglru_block(jnp.asarray(x), jp, jcfg)
    y, _ = TG.rglru_block(_t(x), tp, cfg)
    assert _scaled_err(y, jy) <= 1e-5
    gelu = torch.nn.functional.gelu
    monkeypatch.setattr(TG.F, "gelu", lambda t, approximate="none": gelu(t))
    exact, _ = TG.rglru_block(_t(x), tp, cfg)
    assert _scaled_err(exact, jy) > 1e-4


def test_rglru_block_lengths_give_each_row_its_own_state(model):
    """A padded batch with ``lengths``: every row's output up to its length
    and its conv/hidden state equal the JAX block run on that row alone,
    cut to its length (lengths below the conv width included)."""
    jcfg, cfg, jparams, params = model
    jp, tp = _rglru_params(jparams, params, r=0)
    lens = [2, 19, 9, 24]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((len(lens), max(lens), cfg.d_model)) \
        .astype(np.float32)
    y, st = TG.rglru_block(_t(x), tp, cfg,
                           lengths=torch.tensor(lens, dtype=torch.int32))
    for i, n in enumerate(lens):
        jy, jst = JG.rglru_block(jnp.asarray(x[i:i + 1, :n]), jp, jcfg)
        assert _scaled_err(y[i:i + 1, :n], jy) <= 1e-5
        assert _scaled_err(st.conv[i:i + 1], jst.conv) <= 1e-5
        assert _scaled_err(st.hidden[i:i + 1], jst.hidden) <= 1e-5


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks, np.asarray(lens, np.int32)


def _run_port(cfg, params, toks, lens, max_len, n_dec):
    """Prefill the padded batch on a dense cache, then ``n_dec`` greedy
    decode steps. Returns (logits per step, tokens per step, cache)."""
    cache = T.init_cache(cfg, len(lens), max_len, torch.float32, "cpu")
    logits, _ = T.prefill(params, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache, None, cfg)
    outs, toks_out = [_np(logits)], []
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.from_numpy(lens).to(torch.int32)
    for _ in range(n_dec):
        toks_out.append(tok.numpy().copy())
        logits, _ = T.decode_step(params, cache, tok[:, None], pos, cfg)
        outs.append(_np(logits))
        tok, pos = logits.argmax(-1).to(torch.int32), pos + 1
    return outs, toks_out, cache


def _run_jax(jcfg, jparams, toks, lens, max_len, n_dec, solo: bool):
    """The JAX models-level path: the padded batch as one prefill call, or
    (``solo``) each prompt prefilled alone and the caches stacked into
    slots; then ``n_dec`` greedy decode steps on the batch."""
    if solo:
        rows, lg = [], []
        for i, n in enumerate(lens):
            l_i, c = jax_prefill(jparams, jnp.asarray(toks[i:i + 1, :n]),
                                 jnp.asarray([n]),
                                 jax_init_cache(jcfg, 1, max_len,
                                                jnp.float32), jcfg)
            lg.append(np.asarray(l_i))
            rows.append(c)
        # the tail entries have no repeat axis: batch is axis 0 there
        cache = {"blocks": jax.tree.map(
            lambda *r: jnp.concatenate(r, axis=1),
            *[c["blocks"] for c in rows]),
            "tail": jax.tree.map(lambda *r: jnp.concatenate(r, axis=0),
                                 *[c["tail"] for c in rows])}
        logits = np.concatenate(lg)
    else:
        logits, cache = jax_prefill(
            jparams, jnp.asarray(toks), jnp.asarray(lens),
            jax_init_cache(jcfg, len(lens), max_len, jnp.float32), jcfg)
        logits = np.asarray(logits)
    outs, toks_out = [logits], []
    tok = logits.argmax(-1).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    for _ in range(n_dec):
        toks_out.append(tok.copy())
        jl, cache = jax_decode_step(jparams, cache, jnp.asarray(tok)[:, None],
                                    jnp.asarray(pos), jcfg)
        jl = np.asarray(jl)
        outs.append(jl)
        tok, pos = jl.argmax(-1).astype(np.int32), pos + 1
    return outs, toks_out, cache


def _assert_streams_equal(port, jax_run):
    (pl, pt, _), (jl, jt, _) = port, jax_run
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=ATOL, atol=ATOL)
    assert [t.tolist() for t in pt] == [t.tolist() for t in jt]


@pytest.fixture(scope="module")
def swa_model():
    """A one-layer sliding-window model of reduced recurrentgemma-2b's
    sizes (window 64): the SWA block alone, its ring exercised in
    isolation."""
    kw = dict(pattern=(BlockSpec(mixer=SWA, ff="mlp"),), pattern_tail=(),
              n_layers=1)
    jcfg = jax_config(ARCH).reduced(**kw)
    cfg = get_config(ARCH).reduced(**kw)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(2), jnp.float32)
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


def test_swa_prefill_and_ring_decode_through_many_wraps(swa_model):
    """A 150-token prompt gathered into the 64-row ring (it has wrapped
    twice), then 80 decode steps that wrap it once more and on: logits
    and the ring's rows against the JAX package at every step."""
    jcfg, cfg, jparams, params = swa_model
    toks, lens = _prompts(cfg, [150], seed=3)
    port = _run_port(cfg, params, toks, lens, 400, 80)
    ref = _run_jax(jcfg, jparams, toks, lens, 400, 80, solo=False)
    _assert_streams_equal(port, ref)
    kc = port[2]["blocks"][0]["k"]
    assert kc.shape[2] == cfg.sliding_window
    np.testing.assert_allclose(_np(kc), np.asarray(ref[2]["blocks"][0]["k"]),
                               atol=ATOL)


@pytest.mark.parametrize("lens", [[150], [150, 150, 150]],
                         ids=["B=1", "B=3"])
def test_model_prefill_and_decode_match_jax(model, lens):
    """Reduced recurrentgemma-2b, (R, R, L) + tail (R, R): prefill of
    ~150-token prompts (past the 64-token window) and 12 greedy decode
    steps, logits and tokens against JAX prefill / decode_step, and every
    cache entry (pattern and tail) after the run."""
    jcfg, cfg, jparams, params = model
    toks, lens_np = _prompts(cfg, lens, seed=len(lens))
    port = _run_port(cfg, params, toks, lens_np, 200, 12)
    ref = _run_jax(jcfg, jparams, toks, lens_np, 200, 12, solo=False)
    _assert_streams_equal(port, ref)
    for part in ("blocks", "tail"):
        for jb, tb in zip(ref[2][part], port[2][part]):
            assert sorted(jb) == sorted(tb)
            for key in jb:
                assert tuple(tb[key].shape) == jb[key].shape
                np.testing.assert_allclose(_np(tb[key]), np.asarray(jb[key]),
                                           rtol=ATOL, atol=ATOL)


def test_reference_split_is_pinned(model):
    """A mixed-length batch (prompts of 150, 70 and 9 tokens): the port
    equals the JAX runs that prefill each prompt alone, logits and greedy
    tokens; the JAX padded batch hands decode the RG-LRU state after the
    padding (ROADMAP §3), so its first decode step's logits for the
    shorter rows differ from those runs, while the prefill logits, read at
    each row's last real token, agree."""
    jcfg, cfg, jparams, params = model
    toks, lens = _prompts(cfg, [150, 70, 9], seed=9)
    port = _run_port(cfg, params, toks, lens, 200, 6)
    solo = _run_jax(jcfg, jparams, toks, lens, 200, 6, solo=True)
    _assert_streams_equal(port, solo)
    padded = _run_jax(jcfg, jparams, toks, lens, 200, 1, solo=False)
    np.testing.assert_allclose(padded[0][0], solo[0][0], rtol=ATOL,
                               atol=ATOL)
    np.testing.assert_allclose(padded[0][1][0], solo[0][1][0], rtol=ATOL,
                               atol=ATOL)
    for row in (1, 2):
        assert np.abs(padded[0][1][row] - solo[0][1][row]).max() > 1e-2


def test_bridge_keeps_the_port_dtypes_per_leaf(model):
    """Under bf16 the bridge keeps lambda and the hidden state fp32, in the
    stacked blocks and the tail alike, leaf for leaf as the port's
    init_params and init_cache give them."""
    jcfg, cfg, jparams, _ = model
    bf = torch.bfloat16
    bridged = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu", dtype=bf)
    ours = T.init_params(cfg, seed=0, dtype=bf, device="cpu")
    dt = lambda tree: jax.tree.map(lambda t: t.dtype, tree)   # noqa: E731
    shp = lambda tree: jax.tree.map(lambda t: tuple(t.shape), tree)  # noqa
    assert dt(bridged) == dt(ours) and shp(bridged) == shp(ours)
    assert len(ours["tail_blocks"]) == 2
    for blk in (ours["blocks"][0], ours["tail_blocks"][1]):
        assert blk["lambda"].dtype == torch.float32
        assert blk["w_a"].dtype == bf
    jcache = jax_init_cache(jcfg, 2, 80, jnp.bfloat16)
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu",
                           dtype=bf)
    tcache = T.init_cache(cfg, 2, 80, bf, "cpu")
    assert dt(cache) == dt(tcache) and shp(cache) == shp(tcache)
    assert cache["tail"][0]["hidden"].dtype == torch.float32
    assert cache["blocks"][0]["conv"].dtype == bf
    # the SWA ring holds min(window, max_len) rows
    assert tcache["blocks"][2]["k"].shape[2] == cfg.sliding_window


def test_init_lambda_is_the_lru_init(model):
    _, cfg, _, _ = model
    p = T.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    lam = p["blocks"][0]["lambda"]
    lim = float(np.log(0.9 / 0.1))
    assert tuple(lam.shape) == (cfg.n_pattern_repeats, cfg.lru_width)
    assert bool((lam.abs() <= lim + 1e-6).all()) and lam.std() > 0.3


def test_bullet_server_refuses_pattern_tail_as_jax_does(model):
    jcfg, cfg, jparams, params = model
    with pytest.raises(NotImplementedError, match="pattern_tail"):
        JServer(jcfg, jparams, config=JServerConfig(slo=JSLO(3.0, 150.0)))
    with pytest.raises(NotImplementedError, match="pattern_tail"):
        BulletServer(cfg, params, config=ServerConfig(slo=SLO(3.0, 150.0)),
                     device="cpu")


@pytest.mark.parametrize("mode", ["host", "replay"])
def test_serve_refuses_recurrentgemma_as_jax_does(monkeypatch, mode):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--mode", mode,
                                     "--requests", "2"])
    with pytest.raises(NotImplementedError, match="pattern_tail"):
        jax_serve.main()
    with pytest.raises(NotImplementedError, match="pattern_tail"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--mode", mode,
                    "--requests", "2"])
