"""Port transformer vs the JAX package's ``models/transformer.py`` on the
reduced Qwen3-1.7B (qk_norm, tied embeddings) and Llama-3.1-8B (untied)
configs, with the JAX params bridged through numpy; fp32 on CPU, atol
1e-4 (logits are sums over the model width)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import transformer as JT
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

ATOL = 1e-4
ARCHS = ["qwen3-1.7b", "llama3.1-8b"]
PS = 8


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    name = request.param
    jcfg = jax_config(name).reduced(n_layers=2)
    cfg = get_config(name).reduced(n_layers=2)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def test_bridge_keeps_tree_and_shapes(model):
    jcfg, cfg, jparams, params = model
    assert sorted(params) == sorted(jparams)
    assert len(params["blocks"]) == len(jparams["blocks"])
    for jb, tb in zip(jparams["blocks"], params["blocks"]):
        assert sorted(jb) == sorted(tb)
        for name in jb:
            assert tuple(tb[name].shape) == jb[name].shape
            assert tb[name].shape[0] == cfg.n_pattern_repeats
    ours = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert sorted(ours) == sorted(params)
    assert ours["embed"].shape[0] == cfg.vocab_padded
    for ob, tb in zip(ours["blocks"], params["blocks"]):
        assert {n: tuple(t.shape) for n, t in ob.items()} == \
            {n: tuple(t.shape) for n, t in tb.items()}


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks, np.asarray(lens, np.int32)


def test_prefill_matches_jax(model):
    jcfg, cfg, jparams, params = model
    toks, lens = _prompts(cfg, [13, 21])
    s = toks.shape[1]
    jlogits, jcache = JT.prefill(jparams, jnp.asarray(toks), jnp.asarray(lens),
                                 jax_init_cache(jcfg, 2, 32, jnp.float32),
                                 jcfg)
    n_b = -(-s // PS)
    page_map = np.arange(2 * n_b, dtype=np.int32).reshape(2, n_b)
    cache = T.init_paged_cache(cfg, 2 * n_b, PS, torch.float32, "cpu")
    logits, _ = T.prefill(params, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache,
                          torch.from_numpy(page_map), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    # the pages hold what the JAX dense cache holds, position for position
    for j, entry in enumerate(cache["blocks"]):
        for key in ("k", "v"):
            pages = entry[key].numpy()                 # (R, P+1, ps, K, D)
            dense = np.asarray(jcache["blocks"][j][key])   # (R, B, S, K, D)
            for b, n in enumerate(lens):
                got = pages[:, page_map[b]].reshape(
                    pages.shape[0], -1, *pages.shape[3:])[:, :n]
                np.testing.assert_allclose(got, dense[:, b, :n], atol=ATOL)


def _paged_state(cfg, seed=1):
    """A random page pool and a decode batch over it: slots at contexts
    5, 16 (page edge), 23, one inactive slot; tables bucketed to 4 columns
    with the trash page past each slot's live pages."""
    rng = np.random.default_rng(seed)
    n_pages = 10
    shape = (cfg.n_pattern_repeats, n_pages + 1, PS, cfg.n_kv_heads,
             cfg.head_dim)
    pool = {"blocks": tuple(
        {"k": rng.normal(size=shape).astype(np.float32),
         "v": rng.normal(size=shape).astype(np.float32)}
        for _ in cfg.pattern)}
    pos = np.array([5, 16, 23, -1], np.int32)
    bt = np.full((4, 4), n_pages, np.int32)
    bt[0, :1] = [3]
    bt[1, :3] = [0, 7, 9]
    bt[2, :3] = [1, 2, 5]
    tokens = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    return pool, pos, bt, tokens


def test_decode_step_paged_matches_jax(model):
    jcfg, cfg, jparams, params = model
    pool, pos, bt, tokens = _paged_state(cfg)
    jlogits, jcache = JT.decode_step(
        jparams, jax.tree.map(jnp.asarray, pool), jnp.asarray(tokens),
        jnp.asarray(pos), jcfg, block_tables=jnp.asarray(bt))
    cache = cache_from_jax(pool, device="cpu")
    logits, cache = T.decode_step(params, cache, torch.from_numpy(tokens),
                                  torch.from_numpy(pos), cfg,
                                  block_tables=torch.from_numpy(bt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    trash = pool["blocks"][0]["k"].shape[1] - 1
    for j, entry in enumerate(cache["blocks"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                entry[key].numpy()[:, :trash],
                np.asarray(jcache["blocks"][j][key])[:, :trash], atol=ATOL)


@pytest.mark.parametrize("rep", [0, 1])
def test_fused_group_decode_equals_serial(model, rep):
    """The fused cycle is op-for-op the serial prefill group followed by
    decode_step: equal activations, pools and active slots' logits (an
    inactive slot reads the trash page, whose garbage depends on the write
    order); and allclose to the JAX fused cycle."""
    jcfg, cfg, jparams, params = model
    pool, pos, bt, tokens = _paged_state(cfg, seed=2)
    rng = np.random.default_rng(3)
    x_p = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    page_map = np.array([[4, 6], [8, 10]], np.int32)    # 10 = trash
    positions = np.arange(11)[None, :]
    args = dict(rep=rep, decode_share=0.25)

    f_cache = cache_from_jax(pool, device="cpu")
    fx, flogits = T.fused_group_decode(
        params, f_cache, torch.from_numpy(x_p), torch.from_numpy(positions),
        torch.from_numpy(page_map), torch.from_numpy(tokens),
        torch.from_numpy(pos), cfg, block_tables=torch.from_numpy(bt),
        **args)

    s_cache = cache_from_jax(pool, device="cpu")
    sx, entries = T.prefill_group(params, torch.from_numpy(x_p),
                                  torch.from_numpy(positions), rep, cfg)
    for j, entry in enumerate(entries):
        T.scatter_prefill_pages(s_cache["blocks"][j]["k"], entry["k"],
                                torch.from_numpy(page_map), rep)
        T.scatter_prefill_pages(s_cache["blocks"][j]["v"], entry["v"],
                                torch.from_numpy(page_map), rep)
    slogits, _ = T.decode_step(params, s_cache, torch.from_numpy(tokens),
                               torch.from_numpy(pos), cfg,
                               block_tables=torch.from_numpy(bt))
    assert torch.equal(fx, sx)
    act = torch.from_numpy(pos >= 0)
    assert torch.equal(flogits[act], slogits[act])
    trash = pool["blocks"][0]["k"].shape[1] - 1
    for fe, se in zip(f_cache["blocks"], s_cache["blocks"]):
        for key in ("k", "v"):
            assert torch.equal(fe[key][:, :trash], se[key][:, :trash])

    jx, jlogits, _ = JT.fused_group_decode(
        jparams, jax.tree.map(jnp.asarray, pool), jnp.asarray(x_p),
        jnp.asarray(positions), jnp.asarray(page_map), jnp.asarray(tokens),
        jnp.asarray(pos), jcfg, block_tables=jnp.asarray(bt), **args)
    np.testing.assert_allclose(fx.numpy(), np.asarray(jx), atol=ATOL)
    np.testing.assert_allclose(flogits.numpy(), np.asarray(jlogits),
                               atol=ATOL)


def test_lm_logits_masks_padded_vocab():
    cfg = get_config("llama3.1-8b").reduced(n_layers=1, vocab_size=500)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    logits = T.lm_logits(params, torch.ones(1, 1, cfg.d_model), cfg)
    assert logits.shape[-1] == cfg.vocab_padded == 512
    assert bool((logits[..., 500:] == -1e30).all())
