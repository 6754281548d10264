"""The port's encoder-decoder and frontend paths against the JAX package,
on the CPU in fp32 with the same seeded numpy inputs (params bridged
through numpy): reduced ``seamless-m4t-large-v2`` (the bidirectional
encoder over stub frames, each decoder block's cross-attention, the cross
cache) and reduced ``internvl2-76b`` (its stub patches projected and
prepended to the prompt), both at head dim 64, the head dim the card's
D = 64 kernels serve. ``encode``, the cross K/V, ``prefill`` with a
frontend (logits and every cache leaf, ``cross`` included),
``decode_step`` over the cross cache and ``forward`` with a frontend,
each against the JAX function within rtol/atol ``ATOL`` = 1e-4 (the
RecurrentGemma model tests' tolerance: the port's plain attention runs the
JAX package's XLA math in another summation order), greedy tokens equal;
and the JAX ``test_decode_matches_forward`` (``tests/test_smoke_archs.py``)
run on the port for Granite, Seamless and InternVL2, with its own
tolerance (2e-3 of the logits' scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import encode as jax_encode
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.transformer import \
    _cross_kv_from_encoder as jax_cross_kv
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

ATOL = 1e-4
SEAMLESS, INTERNVL, GRANITE = ("seamless-m4t-large-v2", "internvl2-76b",
                               "granite-3-2b")
#: the prompts (tokens) of the prefill and decode tests, one padded batch
LENS = (11, 6)


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _model(arch):
    jcfg = jax_config(arch).reduced(head_dim=64)
    cfg = get_config(arch).reduced(head_dim=64)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def seamless():
    return _model(SEAMLESS)


@pytest.fixture(scope="module")
def internvl():
    return _model(INTERNVL)


def _frontend(cfg, b, seed=0):
    """Seeded stub frames (encoder-decoder: ``encoder_seq_len`` of them)
    or patches (``frontend_embed_len``), or None without a frontend."""
    n = cfg.encoder_seq_len if cfg.n_encoder_layers else cfg.frontend_embed_len
    if not n:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, n, cfg.frontend_embed_dim)).astype(
        np.float32)


def _prepended(cfg) -> int:
    """Rows the frontend adds in front of the prompt: a decoder-only VLM's
    patches (an encoder-decoder model encodes its frames apart)."""
    return 0 if cfg.n_encoder_layers else cfg.frontend_embed_len


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks, np.asarray(lens, np.int32) + _prepended(cfg)


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=ATOL, atol=ATOL)


def _assert_cache_equal(cache, jcache):
    """Every leaf of the port's dense cache against the JAX one, the cross
    cache included."""
    assert sorted(cache) == sorted(jcache)
    for jb, tb in zip(jcache["blocks"], cache["blocks"]):
        assert sorted(jb) == sorted(tb)
        for key in jb:
            assert tuple(tb[key].shape) == jb[key].shape
            _close(tb[key], jb[key])
    if "cross" in jcache:
        for key in ("k", "v"):
            assert tuple(cache["cross"][key].shape) == \
                jcache["cross"][key].shape
            _close(cache["cross"][key], jcache["cross"][key])


def test_encode_matches_jax(seamless):
    """The encoder over 16 stub frames (reduced encoder_seq_len): frontend
    projection, RoPE'd bidirectional attention, gated MLP, encoder_norm."""
    jcfg, cfg, jparams, params = seamless
    fe = _frontend(cfg, 2)
    got = T.encode(params, _t(fe), cfg)
    want = jax_encode(jparams, jnp.asarray(fe), jcfg, None)
    assert tuple(got.shape) == want.shape == (2, cfg.encoder_seq_len,
                                              cfg.d_model)
    _close(got, want)


def test_cross_kv_matches_jax(seamless):
    """Each repeat's cross K/V from one encoder output (the JAX one, so
    the projection alone is compared)."""
    jcfg, cfg, jparams, params = seamless
    enc = np.asarray(jax_encode(jparams, jnp.asarray(_frontend(cfg, 2)),
                                jcfg, None))
    for r in range(cfg.n_pattern_repeats):
        jp = jax.tree.map(lambda a, r=r: a[r], jparams["blocks"][0])
        jk, jv = jax_cross_kv(jp, jnp.asarray(enc), jcfg)
        k, v = T._cross_kv_from_encoder(T.params_at(params["blocks"][0], r),
                                        _t(enc), cfg)
        assert tuple(k.shape) == jk.shape == (2, cfg.encoder_seq_len,
                                              cfg.n_kv_heads, cfg.head_dim)
        _close(k, jk)
        _close(v, jv)


def _run_port(cfg, params, toks, lens, fe, max_len, n_dec):
    cache = T.init_cache(cfg, len(lens), max_len, torch.float32, "cpu")
    logits, _ = T.prefill(params, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache, None, cfg,
                          frontend=None if fe is None else _t(fe))
    outs, toks_out = [_np(logits)], []
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.from_numpy(lens).to(torch.int32)
    for _ in range(n_dec):
        toks_out.append(tok.numpy().copy())
        logits, _ = T.decode_step(params, cache, tok[:, None], pos, cfg)
        outs.append(_np(logits))
        tok, pos = logits.argmax(-1).to(torch.int32), pos + 1
    return outs, toks_out, cache


def _run_jax(jcfg, jparams, toks, lens, fe, max_len, n_dec):
    logits, cache = jax_prefill(
        jparams, jnp.asarray(toks), jnp.asarray(lens),
        jax_init_cache(jcfg, len(lens), max_len, jnp.float32), jcfg,
        frontend=None if fe is None else jnp.asarray(fe))
    outs, toks_out = [np.asarray(logits)], []
    tok = outs[0].argmax(-1).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    for _ in range(n_dec):
        toks_out.append(tok.copy())
        jl, cache = jax_decode_step(jparams, cache, jnp.asarray(tok)[:, None],
                                    jnp.asarray(pos), jcfg)
        jl = np.asarray(jl)
        outs.append(jl)
        tok, pos = jl.argmax(-1).astype(np.int32), pos + 1
    return outs, toks_out, cache


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_prefill_with_frontend_matches_jax(arch, request):
    """One padded batch of prompts of LENS tokens (InternVL2: each behind
    its 8 projected patches, ``lengths`` counting them): the last real
    token's logits and every cache leaf, the cross cache included."""
    jcfg, cfg, jparams, params = request.getfixturevalue(
        "seamless" if arch == SEAMLESS else "internvl")
    toks, lens = _prompts(cfg, LENS)
    fe = _frontend(cfg, len(LENS))
    max_len = int(lens.max()) + 8
    port = _run_port(cfg, params, toks, lens, fe, max_len, 0)
    ref = _run_jax(jcfg, jparams, toks, lens, fe, max_len, 0)
    _close(torch.from_numpy(port[0][0]), ref[0][0])
    _assert_cache_equal(port[2], ref[2])
    assert ("cross" in port[2]) == (arch == SEAMLESS)


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_decode_step_matches_jax(arch, request):
    """Prefill of the padded batch, then 6 greedy decode steps (Seamless:
    every block cross-attending the cross cache): logits each step, the
    greedy tokens, and every cache leaf after the run."""
    jcfg, cfg, jparams, params = request.getfixturevalue(
        "seamless" if arch == SEAMLESS else "internvl")
    toks, lens = _prompts(cfg, LENS, seed=2)
    fe = _frontend(cfg, len(LENS), seed=3)
    max_len = int(lens.max()) + 8
    port = _run_port(cfg, params, toks, lens, fe, max_len, 6)
    ref = _run_jax(jcfg, jparams, toks, lens, fe, max_len, 6)
    for a, b in zip(port[0], ref[0]):
        np.testing.assert_allclose(a, b, rtol=ATOL, atol=ATOL)
    assert [t.tolist() for t in port[1]] == [t.tolist() for t in ref[1]]
    _assert_cache_equal(port[2], ref[2])


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_forward_with_frontend_matches_jax(arch, request):
    """Teacher forcing over 16 tokens with the frontend encoded (Seamless)
    or prepended (InternVL2: logits over its 8 rows too)."""
    jcfg, cfg, jparams, params = request.getfixturevalue(
        "seamless" if arch == SEAMLESS else "internvl")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    fe = _frontend(cfg, 2, seed=5)
    got, aux = T.forward(params, torch.from_numpy(toks), cfg,
                         frontend=_t(fe))
    want, jaux = jax_forward(jparams, jnp.asarray(toks), jcfg,
                             frontend=jnp.asarray(fe))
    assert tuple(got.shape) == want.shape == (2, 16 + _prepended(cfg),
                                              cfg.vocab_padded)
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0


def test_encoder_decoder_needs_its_frames(seamless):
    _, cfg, _, params = seamless
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="frontend frames"):
        T.forward(params, toks, cfg)


#: tests/test_smoke_archs.py's sizes: batch, sequence, prompt
B, S, S0 = 2, 16, 10


@pytest.mark.parametrize("arch", [GRANITE, SEAMLESS, INTERNVL])
def test_decode_matches_forward(arch):
    """The JAX ``test_decode_matches_forward`` on the port: prefill of S0
    tokens and decode of the rest reproduce teacher forcing's logits
    within 2e-3 of their scale (that test's tolerance), the frontend
    encoded or prepended as the JAX test builds it."""
    _, cfg, _, params = _model(arch)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    fe = _frontend(cfg, B, seed=8)
    fe = None if fe is None else _t(fe)
    full, _ = T.forward(params, tokens, cfg, frontend=fe)
    fe_len = _prepended(cfg) if fe is not None else 0
    cache = T.init_cache(cfg, B, S + fe_len + 2, torch.float32, "cpu")
    lengths = torch.full((B,), S0 + fe_len, dtype=torch.int32)
    lg, _ = T.prefill(params, tokens[:, :S0], lengths, cache, None, cfg,
                      frontend=fe)
    scale = max(float(full.abs().max()), 1.0)
    errs = [float((lg - full[:, fe_len + S0 - 1]).abs().max())]
    for t in range(S0, S):
        lg, _ = T.decode_step(params, cache, tokens[:, t:t + 1],
                              torch.full((B,), t + fe_len,
                                         dtype=torch.int32), cfg)
        errs.append(float((lg - full[:, fe_len + t]).abs().max()))
    assert max(errs) < 2e-3 * scale, (arch, errs)
