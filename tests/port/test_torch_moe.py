"""The port's mixture-of-experts layer (``models/moe.py``) and the two MoE
models against the JAX package on the CPU, fp32, the JAX params bridged
through numpy: ``moe_ffn`` and ``route_topk`` in ``tests/test_models.py``'s
no-drop (factor 8) and tight-capacity (factor 0.25) recipes and at the
configs' own factor 1.25, k in {1, 2}, with and without a shared expert;
the padding contract (with ``valid`` the port equals JAX on the valid
tokens compacted into one row, and the JAX function on the padded batch
drops otherwise, ROADMAP §3); reduced ``mixtral-8x22b`` (past its window)
and ``llama4-maverick-400b-a17b`` through ``prefill`` + ``decode_step``
and ``forward``; ``tests/test_smoke_archs.py``'s decode-matches-forward
recipe on the port; the registry, ``init_params``, ``param_count``, the
sliced draw of large leaves and the bridge's expert leaves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.engine import BulletServer
from repro_torch.core.config import ServerConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving.request import SLO

MOE_ARCHS = ["mixtral-8x22b", "llama4-maverick-400b-a17b"]
#: logits (sums over the model width) within this of their scale
LOGIT_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=1e-5):
    """allclose within ``tol`` of ``want``'s scale (at least 1)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# --- the layer -----------------------------------------------------------

def _layer(setting: str, k: int, shared: bool, seed: int = 0):
    """numpy (x, params, factor) of one recipe: tests/test_models.py's
    no-drop and tight-capacity ones, and random routing at factor 1.25."""
    rng = np.random.default_rng(seed)
    d, e, f = (16, 4, 32) if setting == "tight" else (32, 4, 64)
    params = {"w_in": rng.normal(size=(e, d, 2 * f)) * 0.1,
              "w_out": rng.normal(size=(e, f, d)) * 0.1}
    if setting == "tight":
        # biased router: positive inputs x positive col-0 weights ->
        # expert 0; the other three tie, so k = 2 also checks tie order
        router = np.zeros((d, e))
        router[:, 0] = 1.0
        x = np.abs(rng.normal(size=(4, 32, d))) + 0.5
    else:
        router = rng.normal(size=(d, e)) * 0.1
        x = rng.normal(size=(2, 16, d) if setting == "no_drop"
                       else (3, 40, d))
    params["router"] = router
    if shared:
        params["shared_wi"] = rng.normal(size=(d, 2 * f)) * 0.1
        params["shared_wo"] = rng.normal(size=(f, d)) * 0.1
    factor = {"no_drop": 8.0, "tight": 0.25, "own": 1.25}[setting]
    params = {n: a.astype(np.float32) for n, a in params.items()}
    return x.astype(np.float32), params, factor


def _jax_moe(x, params, k, factor):
    y, m = JM.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, params),
                      n_experts=params["router"].shape[1], k=k,
                      capacity_factor=factor)
    return np.asarray(y), m


def _port_moe(x, params, k, factor, valid=None):
    return M.moe_ffn(_t(x), {n: _t(a) for n, a in params.items()},
                     n_experts=params["router"].shape[1], k=k,
                     capacity_factor=factor,
                     valid=None if valid is None else _t(valid))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("setting", ["no_drop", "tight", "own"])
def test_moe_ffn_matches_jax(setting, k, shared):
    x, params, factor = _layer(setting, k, shared)
    jy, jm = _jax_moe(x, params, k, factor)
    y, m = _port_moe(x, params, k, factor)
    _close(y.numpy(), jy)
    assert float(m.dropped_fraction) == pytest.approx(
        float(jm.dropped_fraction), abs=1e-7)
    assert float(m.load_balance_loss) == pytest.approx(
        float(jm.load_balance_loss), rel=1e-6)
    if setting == "no_drop":
        assert float(m.dropped_fraction) == 0.0
        assert float(m.load_balance_loss) >= 0.9
    if setting == "tight":
        assert float(jm.dropped_fraction) > 0.3
        assert float(m.dropped_fraction) > 0.3
        assert float(m.load_balance_loss) > 2.0


@pytest.mark.parametrize("k", [1, 2])
def test_route_topk_matches_jax_ties_included(k):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    logits[:16] = 0.0                      # every expert ties
    logits[16:32, 2:6] = 1.5               # four experts tie on top
    jw, jidx, jprobs = JM.route_topk(jnp.asarray(logits), k)
    w, idx, probs = M.route_topk(_t(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w.numpy(), jw, 1e-6)
    _close(probs.numpy(), jprobs, 1e-6)
    np.testing.assert_array_equal(idx[:16].numpy(),
                                  np.tile(np.arange(k), (16, 1)))


# --- the padding contract ------------------------------------------------

LENGTHS = (40, 23, 9)


def _padded(setting, k, shared):
    """A (3, 40) batch of 40, 23 and 9 tokens whose router leans to expert
    0, so that the capacity binds."""
    x, params, factor = _layer(setting, k, shared, seed=5)
    x = np.abs(x) + 0.5
    params["router"][:, 0] += 0.05
    b, s, _ = x.shape
    valid = np.arange(s)[None, :] < np.asarray(LENGTHS[:b])[:, None]
    return x, params, factor, valid


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_valid_rows_equal_jax_on_the_compacted_tokens(k, shared):
    """With ``valid``, the valid rows equal the JAX moe_ffn on the valid
    tokens as one (1, n_valid, D) row, drops and the load-balance loss
    included; the padded rows get the shared expert alone (zeros
    without)."""
    x, params, factor, valid = _padded("own", k, shared)
    compact = x[valid][None]                      # (1, n_valid, D)
    jy, jm = _jax_moe(compact, params, k, factor)
    y, m = _port_moe(x, params, k, factor, valid)
    _close(y.numpy()[valid], jy[0])
    assert float(m.dropped_fraction) == pytest.approx(
        float(jm.dropped_fraction), abs=1e-7)
    assert float(jm.dropped_fraction) > 0.0
    assert float(m.load_balance_loss) == pytest.approx(
        float(jm.load_balance_loss), rel=1e-6)
    pad = x[~valid]
    if shared:
        h = pad @ params["shared_wi"]
        g, u = np.split(h, 2, axis=-1)
        want = (g / (1 + np.exp(-g)) * u) @ params["shared_wo"]
    else:
        want = np.zeros_like(pad)
    _close(y.numpy()[~valid], want)


def test_valid_none_is_all_valid():
    x, params, factor, valid = _padded("own", 2, True)
    y0, m0 = _port_moe(x, params, 2, factor)
    y1, m1 = _port_moe(x, params, 2, factor, np.ones_like(valid))
    _close(y1.numpy(), y0.numpy(), 1e-6)
    assert float(m1.dropped_fraction) == float(m0.dropped_fraction)


def test_padding_reference_split_is_pinned():
    """ROADMAP §3 'MoE capacity and padding': the JAX moe_ffn on the padded
    batch counts the padding in the capacity (buffer of 3 x 40 rows at
    factor 1.25) and in the ranks, so its valid rows' drops and outputs
    differ from its own result on the compacted tokens, which the port
    gives for the padded batch."""
    x, params, factor, valid = _padded("own", 1, False)
    n_valid = int(valid.sum())
    assert (M._capacity(x.shape[0] * x.shape[1], 4, 1, factor)
            != M._capacity(n_valid, 4, 1, factor))
    jy_pad, _ = _jax_moe(x, params, 1, factor)
    jy_compact, _ = _jax_moe(x[valid][None], params, 1, factor)
    assert not np.allclose(jy_pad[valid], jy_compact[0], atol=1e-3)
    y, _ = _port_moe(x, params, 1, factor, valid)
    _close(y.numpy()[valid], jy_compact[0])


def test_capacity_table_is_the_jax_expression():
    """The limit a mask gives, computed on the device from the count of
    valid rows, is JAX's Python ``_capacity`` at every count."""
    for n_tokens, e, k, f in [(64, 4, 1, 1.25), (1000, 16, 2, 1.0),
                              (300, 128, 1, 1.25), (97, 8, 2, 0.25),
                              (500, 6, 2, 1.1), (4096, 128, 1, 0.3)]:
        n = torch.arange(n_tokens + 1)
        got = [int(M.capacity_on_device(c, e, k, f)) for c in n]
        assert got == [JM._capacity(i, e, k, f) for i in range(n_tokens + 1)]


class _Calls(list):
    """A ``stats`` argument that keeps each MoE call's metrics in order."""
    add = list.append


def test_moe_stats_sums_and_log():
    x, params, factor = _layer("tight", 1, False)
    stats, calls = M.MoEStats("cpu"), _Calls()
    _, m1 = _port_moe(x, params, 1, factor)
    _, m2 = _port_moe(x, params, 1, 8.0)
    for m in (m1, m2):
        stats.add(m)
        calls.add(m)
    got = stats.read()
    assert got["calls"] == 2 and got["dropping_calls"] == 1
    assert got["mean_dropped_fraction"] == pytest.approx(
        float(m1.dropped_fraction) / 2, rel=1e-6)
    assert got["load_balance_loss"] == pytest.approx(
        float(m1.load_balance_loss) + float(m2.load_balance_loss), rel=1e-6)
    assert [float(m.dropped_fraction) for m in calls] == \
        [float(m1.dropped_fraction), float(m2.dropped_fraction)]


# --- the models ----------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    name = request.param
    jcfg = jax_config(name).reduced()
    cfg = get_config(name).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_prefill_and_decode_match_jax(model):
    """Two prompts of 80 tokens (past the reduced Mixtral's 64-token
    window, whose ring then wraps) and 8 greedy decode steps on the dense
    slot cache: logits within 1e-4 of their scale, tokens equal, every
    prefill MoE call's dropped fraction equal to the JAX per-call one."""
    jcfg, cfg, jparams, params = model
    b, s, n_dec, max_len = 2, 80, 8, 96
    toks = _tokens(cfg, b, s)
    lens = np.full((b,), s, np.int32)
    jlg, jcache = JT.prefill(jparams, jnp.asarray(toks), jnp.asarray(lens),
                             jax_init_cache(jcfg, b, max_len, jnp.float32),
                             jcfg)
    stats = _Calls()
    cache = T.init_cache(cfg, b, max_len, torch.float32, "cpu")
    lg, cache = T.prefill(params, _t(toks), _t(lens), cache, None, cfg,
                          stats=stats)
    _close(lg.numpy(), jlg, LOGIT_TOL)
    # the JAX drops of each layer: its own moe_ffn on the same inputs
    x = jnp.asarray(np.asarray(JT.embed_tokens(jparams, jnp.asarray(toks),
                                               jcfg, None)))
    assert len(stats) == sum(blk.ff == "moe" for blk in cfg.pattern) \
        * cfg.n_pattern_repeats
    want = _jax_prefill_drops(jparams, jcfg, x)
    assert [float(m.dropped_fraction) for m in stats] == \
        pytest.approx(want, abs=1e-7)
    jtok = jnp.argmax(jlg, -1)[:, None].astype(jnp.int32)
    tok = lg.argmax(-1)[:, None].to(torch.int32)
    for t in range(n_dec):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = np.full((b,), s + t, np.int32)
        jlg, jcache = JT.decode_step(jparams, jcache, jtok, jnp.asarray(pos),
                                     jcfg)
        lg, cache = T.decode_step(params, cache, tok, _t(pos), cfg)
        _close(lg.numpy(), jlg, LOGIT_TOL)
        jtok = jnp.argmax(jlg, -1)[:, None].astype(jnp.int32)
        tok = lg.argmax(-1)[:, None].to(torch.int32)


def _jax_prefill_drops(jparams, jcfg, x):
    """The dropped fraction of every MoE call of a JAX prefill over the
    embedded prompts ``x``, in layer order."""
    positions = jnp.arange(x.shape[1])[None, :]
    drops = []
    for r in range(jcfg.n_pattern_repeats):
        for j, blk in enumerate(jcfg.pattern):
            p = jax.tree.map(lambda a: a[r], jparams["blocks"][j])
            if blk.ff == "moe":
                from repro.models import layers as JL
                h0 = JL.rms_norm(x, p["ln1"], jcfg.rmsnorm_eps)
                y = _jax_mixer(h0, p, blk, jcfg, positions)
                xm = x + y
                h = JL.rms_norm(xm, p["ln2"], jcfg.rmsnorm_eps)
                _, m = JM.moe_ffn(h, p, n_experts=jcfg.n_experts,
                                  k=jcfg.n_experts_per_token,
                                  capacity_factor=jcfg.moe_capacity_factor)
                drops.append(float(m.dropped_fraction))
            x, _, _ = JT._apply_block_full(x, p, blk, jcfg, None, positions,
                                           None)
    return drops


def _jax_mixer(h, p, blk, jcfg, positions):
    from repro.models import attention as JA
    q, k, v = JT._project_qkv(h, p, jcfg, positions, None)
    window = jcfg.sliding_window if blk.mixer == "swa" else 0
    o = JA.attention_prefill(q, k, v, causal=True, window=window)
    return o.reshape(*o.shape[:2], -1) @ p["wo"]


def test_forward_matches_jax(model):
    jcfg, cfg, jparams, params = model
    toks = _tokens(cfg, 2, 70, seed=1)
    jlogits, jaux = JT.forward(jparams, jnp.asarray(toks), jcfg)
    logits, aux = T.forward(params, _t(toks), cfg)
    _close(logits.numpy(), jlogits, LOGIT_TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(aux) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS + ["qwen1.5-4b",
                                              "codeqwen1.5-7b"])
def test_decode_matches_forward(arch):
    """tests/test_smoke_archs.py's recipe on the port: prefill 10 tokens,
    decode 6 more one by one; every step's logits equal the teacher-forcing
    forward's (no drops: factor 8)."""
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    b, s, s0 = 2, 16, 10
    toks = _t(_tokens(cfg, b, s, seed=2))
    full, _ = T.forward(params, toks, cfg)
    cache = T.init_cache(cfg, b, s + 2, torch.float32, "cpu")
    lg, cache = T.prefill(params, toks[:, :s0], torch.full((b,), s0), cache,
                          None, cfg)
    scale = max(float(full.abs().max()), 1.0)
    errs = [float((lg - full[:, s0 - 1]).abs().max())]
    for t in range(s0, s):
        lg, cache = T.decode_step(params, cache, toks[:, t:t + 1],
                                  torch.full((b,), t, dtype=torch.int32),
                                  cfg)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 2e-3 * scale, (arch, errs)


# --- registry, init, bridge ----------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS + ["qwen1.5-4b",
                                              "codeqwen1.5-7b"])
def test_init_params_has_the_jax_tree_and_count(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    ours = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    jparams = jax.eval_shape(
        lambda: jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))

    def shapes(tree):
        return jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(jax.tree.map(np.asarray, ours)) == shapes(jparams)
    assert T.param_count(ours) == JT.param_count(jparams)


def test_full_width_moe_leaves():
    """The published widths: Llama-4 Maverick's expert leaves (128
    experts of 5120 x 2·8192) and Mixtral's (8 of 6144 x 2·16384), their
    init scale 1/sqrt(expert count) as in the JAX package."""
    l4 = T._block_defs(get_config("llama4-maverick-400b-a17b"),
                       get_config("llama4-maverick-400b-a17b").pattern[1])
    assert l4["w_in"][0] == (128, 5120, 16384)
    assert l4["w_out"][0] == (128, 8192, 5120)
    assert l4["shared_wi"][0] == (5120, 16384)
    mx = get_config("mixtral-8x22b")
    assert T._block_defs(mx, mx.pattern[0])["w_in"][0] == (8, 6144, 32768)
    assert not T.supports_paged_cache(mx)
    assert T.supports_paged_cache(get_config("llama4-maverick-400b-a17b"))


def test_large_leaves_are_drawn_a_slice_at_a_time(monkeypatch):
    """A leaf over DRAW_LIMIT elements is drawn one leading slice at a time
    (same distribution, no whole-leaf fp32 temporary); a leaf under it
    keeps the bits of one whole draw."""
    gen = torch.Generator().manual_seed(0)
    whole = (torch.randn((4, 6), generator=gen) * 0.5).to(torch.bfloat16)
    gen.manual_seed(0)
    assert torch.equal(L.dense_init(gen, (4, 6), torch.bfloat16,
                                    fan_in=4), whole)
    monkeypatch.setattr(L, "DRAW_LIMIT", 1000)
    drawn = []
    real = torch.randn

    def spy(shape, *a, **kw):
        drawn.append(tuple(shape))
        return real(shape, *a, **kw)
    monkeypatch.setattr(torch, "randn", spy)
    gen.manual_seed(0)
    w = L.dense_init(gen, (3, 8, 40, 10), torch.float32)
    assert w.shape == (3, 8, 40, 10) and w.dtype == torch.float32
    assert drawn == [(40, 10)] * 24
    assert abs(float(w.std()) - 1 / np.sqrt(3)) < 0.02
    assert len({float(w[i, j, 0, 0]) for i in range(3)
                for j in range(8)}) == 24


def test_bridge_carries_the_expert_leaves():
    cfg = jax_config("llama4-maverick-400b-a17b").reduced()
    jparams = jax.tree.map(np.asarray, jax_init_params(
        cfg, jax.random.PRNGKey(1), jnp.float32))
    params = params_from_jax(jparams, device="cpu")
    for jb, tb in zip(jparams["blocks"], params["blocks"]):
        assert sorted(jb) == sorted(tb)
        for name, a in jb.items():
            assert tb[name].dtype == torch.float32
            np.testing.assert_array_equal(tb[name].numpy(), a)
    moe = params["blocks"][1]
    r, e = cfg.n_pattern_repeats, cfg.n_experts
    assert moe["w_in"].shape == (r, e, cfg.d_model, 2 * cfg.d_ff)
    assert moe["w_out"].shape == (r, e, cfg.d_ff, cfg.d_model)
    assert moe["router"].shape == (r, cfg.d_model, e)
    back = params_from_jax(jax.tree.map(lambda t: t.numpy(), params),
                           device="cpu", dtype=torch.bfloat16)
    assert back["blocks"][1]["w_in"].dtype == torch.bfloat16
    assert back["blocks"][1]["w_in"].shape == moe["w_in"].shape


@pytest.mark.parametrize("arch", ["granite-3-2b", "internvl2-76b",
                                  "seamless-m4t-large-v2"])
def test_unported_archs_raise_naming_the_roadmap_item(arch):
    """The three configs that waited for ROADMAP item 'the other
    architectures' (head dim 64, the encoder and cross-attention, the
    frontend projector) are registered now: each equals the JAX config
    field for field (``test_torch_package._as_port``'s recipe)."""
    from dataclasses import asdict
    from repro_torch.configs import list_configs
    from repro_torch.configs.base import BlockSpec, ModelConfig
    d = asdict(jax_config(arch))
    d["pattern"] = tuple(BlockSpec(**b) for b in d["pattern"])
    d["pattern_tail"] = tuple(BlockSpec(**b) for b in d["pattern_tail"])
    assert get_config(arch) == ModelConfig(**d)
    assert arch in list_configs()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_server_accepts_the_moe_archs(arch):
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), max_slots=2, max_len=32), device="cpu")
    assert server.paged == T.supports_paged_cache(cfg)
    assert server.moe_stats is not None
