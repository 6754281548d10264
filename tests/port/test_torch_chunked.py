"""The port's chunked prefill and long-context prefill against the JAX
package, on the CPU in fp32 with the same seeded numpy inputs (params
bridged through numpy): the plain attention with a query offset
(``flash_ref_attention(q_offset=)``, the plain version of kernel 1's
offset), the SSD scan from a starting state (``ssd_chunked(state0=)``
and the plain chunk scans, the plain versions of kernel 6's), the recipe
of ``tests/test_chunked_real.py`` (five arches, chunks of 4, 8 and 12) run
through the port's ``prefill_chunk`` beside the JAX one, and
``prefill(long_context=True)`` with ``decode_step(long_context=True)``
over the long-context ring beside the JAX ones.

Tolerances: the plain attention and scans 1e-5 (the same math in another
summation order; the SSD scans over chunks of another length 2e-4, as
``test_torch_ssm.py``), the models rtol/atol ``ATOL`` = 1e-4 (the
RecurrentGemma and encoder-decoder model tests' tolerance), greedy tokens
equal. The bf16 mirror of kernel 6 is held to its plain version from a
state within the smoke's bf16 limits over the output's scale."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import prefill_chunk as jax_prefill_chunk
from repro.models import ssm as JS
from repro.models.attention import flash_ref_attention as jax_flash_ref
from repro.kernels import ref as JR
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.graphs import GraphedDecode
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import ssd_scan as TK
from repro_torch.models import prefill_chunk
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as T

ATOL = 1e-4
PLAIN_ATOL = 1e-5
SCAN_ATOL = 2e-4
#: the JAX recipe's arches and chunks (tests/test_chunked_real.py)
ARCHS = ("qwen3-1.7b", "mamba2-2.7b", "recurrentgemma-2b", "mixtral-8x22b",
         "internvl2-76b")
CHUNKS = (4, 8, 12)
B, S = 2, 24
#: greedy decode steps after the prefill, each held against JAX's
N_DEC = 3


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_tree_close(tree, jtree, atol=ATOL):
    got, want = _leaves(tree), _leaves(jtree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=ATOL, atol=atol)


def _model(arch, **overrides):
    """(jcfg, cfg, jparams, params): the JAX recipe's reduced config (no
    frontend; a MoE config at capacity factor 8, so no token drops), its
    JAX params and the port's, bridged through numpy."""
    kw = dict(frontend_embed_len=0, frontend_embed_dim=0, **overrides)
    jcfg, cfg = jax_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    if cfg.n_experts:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=8.0)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def models():
    """The recipe's five models, built once for the module."""
    return {arch: _model(arch) for arch in ARCHS}


# ---------------------------------------------------------------------------
# (i) the plain attention with a query offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("offset,extra", [(0, 0), (5, 3), (37, 0)])
def test_flash_ref_attention_offset_matches_jax(g, window, offset, extra):
    """A chunk of 13 queries at positions ``offset ..`` over ``offset + 13
    + extra`` keys (the rows past the chunk masked by causality), over
    several key blocks (block 16) and one."""
    rng = np.random.default_rng(offset * 10 + window + g)
    sq, kh, d = 13, 2, 16
    sk = offset + sq + extra
    q = rng.standard_normal((2, sq, kh * g, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, kh, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, kh, d)).astype(np.float32)
    for bs in (16, 1024):
        want = jax_flash_ref(*map(jnp.asarray, (q, k, v)), window=window,
                             q_offset=offset, block_size=bs)
        got = TR.flash_ref_attention(*map(_t, (q, k, v)), window=window,
                                     q_offset=offset, block_size=bs)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=PLAIN_ATOL)


@pytest.mark.parametrize("window", [0, 9])
def test_kernel_layout_offset_matches_the_model_layout(window):
    """Kernel 1's plain version (its layout, through ``ops``) at an offset
    equals the model-layout attention it serves."""
    rng = np.random.default_rng(window)
    q = _t(rng.standard_normal((2, 11, 4, 16)))
    k = _t(rng.standard_normal((2, 30, 2, 16)))
    v = _t(rng.standard_normal((2, 30, 2, 16)))
    got = ops.flash_attention_op(q, k, v, window=window, q_offset=19)
    want = TR.flash_ref_attention(q, k, v, window=window, q_offset=19)
    np.testing.assert_allclose(_np(got), _np(want), atol=PLAIN_ATOL)


# ---------------------------------------------------------------------------
# (ii) the SSD scan from a starting state
# ---------------------------------------------------------------------------

def _scan_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B_ = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    state0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B_, C, D, state0


@pytest.mark.parametrize("s,chunk", [(48, 16), (45, 16), (10, 16)])
def test_ssd_chunked_from_a_state_matches_jax(s, chunk):
    """Whole chunks, a padded tail (dt = 0 steps carry the state) and one
    short chunk, each from a random state."""
    x, dt, A, B_, C, D, st0 = _scan_inputs(2, s, 3, 8, 4, seed=s)
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C, D)),
                            chunk=chunk, state0=jnp.asarray(st0))
    y, st = TS.ssd_chunked(*map(_t, (x, dt, A, B_, C, D)), chunk=chunk,
                           state0=_t(st0))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=SCAN_ATOL)
    np.testing.assert_allclose(_np(st), np.asarray(js), atol=SCAN_ATOL)


def _chunk_layout(x, dt, A, B_, C, chunk):
    """The kernel layout of a sequence that is a whole number of chunks,
    and the global cumulative log decay of the sequential oracle."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    nc = s // chunk
    xw = x * dt[..., None]
    da = dt * A
    cum = np.cumsum(da.reshape(b, nc, chunk, h), axis=2)
    return ((xw.reshape(b, nc, chunk, h, p), cum,
             B_.reshape(b, nc, chunk, n), C.reshape(b, nc, chunk, n)),
            (xw, np.cumsum(da, axis=1), B_, C))


def test_plain_chunk_scan_from_a_state_matches_the_oracles():
    """``ssd_scan_plain(state0)`` (kernel 6's plain version) against the
    port's sequential oracle ``ssd_scan_ref(state0=)`` and the JAX one,
    from the same state."""
    x, dt, A, B_, C, _, st0 = _scan_inputs(2, 48, 3, 8, 4, seed=11)
    chunked, seq = _chunk_layout(x, dt, A, B_, C, 16)
    y, st = TK.ssd_scan_plain(*map(_t, chunked), _t(st0))
    ry, rst = TR.ssd_scan_ref(*map(_t, seq), state0=_t(st0))
    jy, jst = JR.ssd_scan_ref(*map(jnp.asarray, seq), jnp.asarray(st0))
    for want_y, want_s in ((_np(ry), _np(rst)),
                           (np.asarray(jy), np.asarray(jst))):
        np.testing.assert_allclose(_np(y).reshape(want_y.shape), want_y,
                                   atol=PLAIN_ATOL * 10)
        np.testing.assert_allclose(_np(st), want_s, atol=PLAIN_ATOL * 10)


def test_bf16_mirror_from_a_state_matches_the_plain_scan():
    """The bf16 body's mirror ``ssd_scan_tc_ref(state0)`` (the entering
    state rounded to bf16 for chunk 0's inter term) against the plain scan
    from the same state, on bf16 inputs: y within 1e-2 and the fp32 state
    within 1e-4 of the scale max(1, max|plain|), the smoke's limits."""
    x, dt, A, B_, C, _, st0 = _scan_inputs(2, 64, 3, 16, 8, seed=12)
    chunked, _ = _chunk_layout(x, dt, A, B_, C, 32)
    xw, cum, bc, cc = (_t(a) for a in chunked)
    xw, bc, cc = xw.bfloat16(), bc.bfloat16(), cc.bfloat16()
    y, st = TR.ssd_scan_tc_ref(xw, cum, bc, cc, _t(st0))
    py, pst = TK.ssd_scan_plain(xw, cum, bc, cc, _t(st0))
    zy, _ = TR.ssd_scan_tc_ref(xw, cum, bc, cc)

    def err(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp(min=1.0)).item()
    assert err(y, py) <= 1e-2 and err(st, pst) <= 1e-4
    assert err(zy, py) > 1e-1         # the state moved the outputs


# ---------------------------------------------------------------------------
# (iii) the recipe of tests/test_chunked_real.py, on both packages
# ---------------------------------------------------------------------------

#: the JAX functions compiled once per config and shape: ``ctx_start``
#: traced (its every use, the positions, the cache write and the
#: attention's ``q_offset``, takes a traced value), so the chunks of a
#: run share one program where eager calls would build one per offset
_jax_chunk = jax.jit(jax_prefill_chunk, static_argnums=(4,))
_jax_decode = jax.jit(jax_decode_step, static_argnums=(4,))

@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax(models, arch, chunk):
    """S = 24 prompt tokens in chunks through the dense cache: every
    chunk's last logits and, after the last, every cache leaf equal the
    JAX ``prefill_chunk``'s; then N_DEC greedy decode steps from both
    caches (logits equal, tokens equal)."""
    jcfg, cfg, jparams, params = models[arch]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jcache = jax_init_cache(jcfg, B, S + 4, jnp.float32)
    cache = T.init_cache(cfg, B, S + 4, torch.float32, "cpu")
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        jl, jcache = _jax_chunk(jparams, jnp.asarray(toks[:, sl]),
                                jnp.int32(i * chunk), jcache, jcfg)
        lg, cache = prefill_chunk(params, torch.from_numpy(toks[:, sl]),
                                  i * chunk, cache, cfg)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), rtol=ATOL,
                                   atol=ATOL)
    _assert_tree_close(cache, jcache)
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for i in range(N_DEC):
        pos = np.full((B,), S + i, np.int32)
        jl, jcache = _jax_decode(jparams, jcache, jnp.asarray(nxt),
                                 jnp.asarray(pos), jcfg)
        lg, cache = T.decode_step(params, cache, torch.from_numpy(nxt),
                                  torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), rtol=ATOL,
                                   atol=ATOL)
        tok = _np(lg).argmax(-1)
        assert (tok == np.asarray(jl).argmax(-1)).all()
        nxt = tok.astype(np.int32)[:, None]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_prefill_chunk_equals_the_unchunked_prefill(models, arch):
    """The JAX recipe's own gate on the port: the last chunk's logits
    against ``forward``'s at position S-1 and the first decode step's
    from the chunked cache against the unchunked ``prefill``'s, within
    2e-3 of the logits' scale."""
    _, cfg, _, params = models[arch]
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32))
    full, _ = T.forward(params, toks, cfg)
    cache = T.init_cache(cfg, B, S + 4, torch.float32, "cpu")
    for i in range(0, S, 8):
        lg, cache = prefill_chunk(params, toks[:, i:i + 8], i, cache, cfg)
    scale = max(full.abs().max().item(), 1.0)
    assert (lg - full[:, S - 1]).abs().max().item() < 2e-3 * scale
    cache_u = T.init_cache(cfg, B, S + 4, torch.float32, "cpu")
    T.prefill(params, toks, torch.full((B,), S), cache_u, None, cfg)
    nxt = torch.ones(B, 1, dtype=torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    d1, _ = T.decode_step(params, cache, nxt, pos, cfg)
    d2, _ = T.decode_step(params, cache_u, nxt, pos, cfg)
    assert (d1 - d2).abs().max().item() < 2e-3 * scale


# ---------------------------------------------------------------------------
# (iv) encoder-decoder configs are refused
# ---------------------------------------------------------------------------

def test_prefill_chunk_refuses_an_encoder_decoder():
    """Both packages refuse it: JAX with an assertion, the port with a
    ValueError."""
    jcfg = jax_config("seamless-m4t-large-v2").reduced()
    cfg = get_config("seamless-m4t-large-v2").reduced()
    jparams = jax.eval_shape(lambda k: jax_init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    with pytest.raises(AssertionError):
        jax_prefill_chunk(jparams, jnp.zeros((1, 4), jnp.int32), 0,
                          jax_init_cache(jcfg, 1, 8, abstract=True), jcfg)
    params = T.init_params(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        prefill_chunk(params, torch.zeros(1, 4, dtype=torch.int32), 0,
                      T.init_cache(cfg, 1, 8, torch.float32, "cpu"), cfg)


# ---------------------------------------------------------------------------
# (v) the long-context prefill and decode over its ring
# ---------------------------------------------------------------------------

#: prompts of one padded batch, past the reduced long-context window of 64
LC_LENS = (100, 70)
LC_DEC = 4


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-3-2b"])
def test_long_context_prefill_and_decode_match_jax(arch):
    """``prefill(long_context=True)`` of a padded batch (window = min(64,
    S)): logits and every ring leaf equal JAX's; then LC_DEC greedy
    ``decode_step(long_context=True)`` steps over the ring (the port's
    through ``GraphedDecode``, which runs eagerly on the CPU): logits,
    ring leaves and tokens equal."""
    jcfg, cfg, jparams, params = _model(arch)
    assert cfg.long_context_window == 64
    rng = np.random.default_rng(4)
    toks = np.zeros((len(LC_LENS), max(LC_LENS)), np.int32)
    for i, n in enumerate(LC_LENS):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    lens = np.asarray(LC_LENS, np.int32)
    max_len = max(LC_LENS) + LC_DEC
    jcache = jax_init_cache(jcfg, len(lens), max_len, jnp.float32,
                            long_context=True)
    cache = T.init_cache(cfg, len(lens), max_len, torch.float32, "cpu",
                         long_context=True)
    assert cache["blocks"][0]["k"].shape[2] == 64
    jl, jcache = jax_prefill(jparams, jnp.asarray(toks), jnp.asarray(lens),
                             jcache, jcfg, long_context=True)
    lg, cache = T.prefill(params, torch.from_numpy(toks),
                          torch.from_numpy(lens), cache, None, cfg,
                          long_context=True)
    np.testing.assert_allclose(_np(lg), np.asarray(jl), rtol=ATOL,
                               atol=ATOL)
    _assert_tree_close(cache, jcache)
    dec = GraphedDecode(params, cache, cfg, long_context=True)
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for i in range(LC_DEC):
        pos = lens + i
        jl, jcache = jax_decode_step(jparams, jcache, jnp.asarray(nxt),
                                     jnp.asarray(pos), jcfg,
                                     long_context=True)
        lg = dec(torch.from_numpy(nxt), torch.from_numpy(pos))
        np.testing.assert_allclose(_np(lg), np.asarray(jl), rtol=ATOL,
                                   atol=ATOL)
        tok = _np(lg).argmax(-1)
        assert (tok == np.asarray(jl).argmax(-1)).all()
        nxt = tok.astype(np.int32)[:, None]
    _assert_tree_close(cache, jcache)


def test_long_context_window_reaches_only_full_attention(models):
    """With the prompt inside the window the long-context prefill is the
    plain one (window = S attends every earlier key): the same logits."""
    _, cfg, _, params = models["qwen3-1.7b"]
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 40), dtype=np.int32))
    lens = torch.tensor([40, 25])
    outs = []
    for lc in (False, True):
        cache = T.init_cache(cfg, 2, 48, torch.float32, "cpu",
                             long_context=lc)
        outs.append(T.prefill(params, toks, lens, cache, None, cfg,
                              long_context=lc)[0])
    np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), atol=PLAIN_ATOL)


# ---------------------------------------------------------------------------
# (vi) what the port refuses, and the split it pins
# ---------------------------------------------------------------------------

def test_prefill_chunk_past_an_attention_leaf_raises(models):
    """A chunk that ends past an attention leaf's rows (a cache shorter
    than the prompt, or the long-context ring) raises ValueError, where
    the JAX ``dynamic_update_slice`` clamps the write silently and returns
    logits (ROADMAP §3: the split pinned here)."""
    jcfg, cfg, jparams, params = models["qwen3-1.7b"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 8),
                                             dtype=np.int32)
    jl, _ = jax_prefill_chunk(jparams, jnp.asarray(toks), 12,
                              jax_init_cache(jcfg, 1, 16, jnp.float32), jcfg)
    assert np.isfinite(np.asarray(jl)).all()
    with pytest.raises(ValueError, match="past"):
        prefill_chunk(params, torch.from_numpy(toks), 12,
                      T.init_cache(cfg, 1, 16, torch.float32, "cpu"), cfg)
    ring = T.init_cache(cfg, 1, 200, torch.float32, "cpu", long_context=True)
    with pytest.raises(ValueError, match="ring"):
        prefill_chunk(params, torch.from_numpy(toks), 60, ring, cfg)


def test_long_context_prefill_refuses_pages(models):
    """The JAX package has no paged long-context prefill; the port's
    ``prefill`` raises ValueError for ``long_context`` with a page map."""
    _, cfg, _, params = models["qwen3-1.7b"]
    pool = T.init_paged_cache(cfg, 8, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="long-context"):
        T.prefill(params, torch.zeros(1, 16, dtype=torch.int32),
                  torch.tensor([16]), pool,
                  torch.zeros(1, 1, dtype=torch.int32), cfg,
                  long_context=True)
