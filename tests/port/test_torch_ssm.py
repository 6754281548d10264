"""The port's Mamba-2 path against the JAX package, on the CPU in fp32 with
the same seeded numpy inputs (params bridged through numpy): the plain SSD
chunk scan and ``ssd_scan_op`` against the Pallas ``ssd_scan`` (interpret
mode) and ``ssd_chunked`` (atol 2e-4, tests/test_kernels.py's tolerance:
the chunked sums run in another order), the sequential oracle, the causal
conv, the SSD block, the model's dense cache and decode on reduced
``mamba2-2.7b`` (atol 1e-4), and ``BulletServer`` greedy streams.

Prefill batches are right-padded to their longest prompt. The port's SSD
prefill returns each row's state at its own length, the JAX package's the
state after the padded tail (ROADMAP §3), so the port is held against JAX
runs that prefill one prompt at a time, and the split is pinned."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.config import ServerConfig as JServerConfig
from repro.core.engine import BulletServer as JServer
from repro.kernels import ref as JR
from repro.kernels import ssd_scan_op as jax_ssd_scan_op
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import ssm as JS
from repro.models.layers import causal_conv1d as jax_causal_conv1d
from repro.serving.request import Request as JRequest
from repro.serving.request import SLO as JSLO
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, MOE, BlockSpec
from repro_torch.core.config import CacheConfig, ServerConfig
from repro_torch.core.engine import BulletServer
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import ssd_scan as TK
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.launch import serve
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as T
from repro_torch.models.layers import causal_conv1d
from repro_torch.resilience import (FaultInjector, FaultPlan, FaultSpec,
                                    SLOGuard)
from repro_torch.serving.request import SLO, Phase, Request

SCAN_ATOL = 2e-4
ATOL = 1e-4
ARCH = "mamba2-2.7b"


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


def _scan_inputs(b, s, h, p, n, seed=0):
    """ssd_chunked's inputs: x, dt (softplus'd), A (negative), B, C, D."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B_ = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B_, C, D


SCAN_SHAPES = [(2, 48, 3, 8, 4, 16), (1, 64, 2, 16, 8, 32),
               (2, 32, 4, 4, 16, 8)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SCAN_SHAPES)
def test_plain_scan_and_op_match_jax(b, s, h, p, n, chunk):
    x, dt, A, B_, C, D = _scan_inputs(b, s, h, p, n)
    jy, js = jax_ssd_scan_op(*map(jnp.asarray, (x, dt, A, B_, C, D)),
                             chunk=chunk, interpret=True)
    ry, rs = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C, D)),
                            chunk=chunk)
    y, st = ops.ssd_scan_op(*map(_t, (x, dt, A, B_, C, D)), chunk=chunk)
    assert st.dtype == torch.float32 and tuple(st.shape) == (b, h, p, n)
    for ref_y, ref_s in ((jy, js), (ry, rs)):
        np.testing.assert_allclose(_np(y), np.asarray(ref_y), atol=SCAN_ATOL)
        np.testing.assert_allclose(_np(st), np.asarray(ref_s),
                                   atol=SCAN_ATOL)
    # the plain chunk scan on the kernel layout against the Pallas kernel
    q = min(chunk, s)
    nc = s // q
    xw = (x * dt[..., None]).reshape(b, nc, q, h, p)
    cum = np.cumsum((dt * A).reshape(b, nc, q, h), axis=2)
    Bc, Cc = B_.reshape(b, nc, q, n), C.reshape(b, nc, q, n)
    ky = jax_ssd_scan(*map(jnp.asarray, (xw, cum, Bc, Cc)), interpret=True)
    py, ps = TK.ssd_scan(*map(_t, (xw, cum, Bc, Cc)))
    np.testing.assert_allclose(_np(py), np.asarray(ky), atol=SCAN_ATOL)
    np.testing.assert_allclose(_np(ps), np.asarray(rs), atol=SCAN_ATOL)


def test_scan_op_pads_a_tail_chunk_with_zero_steps():
    """S not a multiple of the chunk: the padded dt = 0 steps leave the
    state as it stood at the last real row."""
    x, dt, A, B_, C, D = _scan_inputs(2, 45, 3, 8, 4, seed=3)
    ry, rs = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C, D)),
                            chunk=16)
    y, st = ops.ssd_scan_op(*map(_t, (x, dt, A, B_, C, D)), chunk=16)
    np.testing.assert_allclose(_np(y), np.asarray(ry), atol=SCAN_ATOL)
    np.testing.assert_allclose(_np(st), np.asarray(rs), atol=SCAN_ATOL)


def test_scan_op_from_a_starting_state_matches_jax():
    """From a starting state (the kernel's ``state0``) the op matches the
    JAX ``ssd_chunked(state0=)``, a padded tail chunk included."""
    x, dt, A, B_, C, D = _scan_inputs(1, 21, 2, 4, 4)
    state0 = np.random.default_rng(7).standard_normal(
        (1, 2, 4, 4)).astype(np.float32)
    ry, rs = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C, D)),
                            chunk=16, state0=jnp.asarray(state0))
    y, st = ops.ssd_scan_op(*map(_t, (x, dt, A, B_, C, D)), chunk=16,
                            state0=_t(state0))
    np.testing.assert_allclose(_np(y), np.asarray(ry), atol=SCAN_ATOL)
    np.testing.assert_allclose(_np(st), np.asarray(rs), atol=SCAN_ATOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_sequential_oracle_matches_jax(with_state):
    b, s, h, p, n = 2, 24, 3, 8, 4
    x, dt, A, B_, C, _ = _scan_inputs(b, s, h, p, n, seed=1)
    xw = x * dt[..., None]
    cum = np.cumsum(dt * A, axis=1)
    st0 = (np.random.default_rng(2).standard_normal((b, h, p, n))
           .astype(np.float32) if with_state else None)
    jy, js = JR.ssd_scan_ref(*map(jnp.asarray, (xw, cum, B_, C)),
                             None if st0 is None else jnp.asarray(st0))
    y, st = TR.ssd_scan_ref(*map(_t, (xw, cum, B_, C)),
                            None if st0 is None else _t(st0))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(_np(st), np.asarray(js), atol=ATOL)
    # the chunked plain scan agrees with the oracle (no starting state)
    if st0 is None:
        cy, cs = ops.ssd_scan_op(*map(_t, (x, dt, A, B_, C)),
                                 torch.zeros(h), chunk=8)
        np.testing.assert_allclose(_np(cy), _np(y), atol=SCAN_ATOL)
        np.testing.assert_allclose(_np(cs), _np(st), atol=SCAN_ATOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = (rng.standard_normal((2, 3, 6)).astype(np.float32)
          if with_state else None)
    jy, jst = jax_causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    y, new = causal_conv1d(_t(x), _t(w), None if st is None else _t(st))
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(_np(new), np.asarray(jst), atol=0)


# ---------------------------------------------------------------------------
# the block and the model, reduced mamba2-2.7b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    # two pattern repeats -> two layer groups per prefill
    jcfg = jax_config(ARCH).reduced(n_layers=2)
    cfg = get_config(ARCH).reduced(n_layers=2)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _block_params(jparams, params, r=0):
    jp = jax.tree.map(lambda a: a[r], jparams["blocks"][0])
    return jp, T.params_at(params["blocks"][0], r)


def test_ssd_block_prefill_and_decode_match_jax(model):
    jcfg, cfg, jparams, params = model
    jp, tp = _block_params(jparams, params)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    jy, jst = JS.ssd_block(jnp.asarray(x), jp, jcfg)
    y, st = TS.ssd_block(_t(x), tp, cfg)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(_np(st.conv), np.asarray(jst.conv), atol=ATOL)
    np.testing.assert_allclose(_np(st.ssm), np.asarray(jst.ssm), atol=ATOL)
    # three decode steps from that state
    for i in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = JS.ssd_block(jnp.asarray(xt), jp, jcfg, state=jst,
                               decode=True)
        y, st = TS.ssd_block(_t(xt), tp, cfg, state=st, decode=True)
        np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(_np(st.ssm), np.asarray(jst.ssm),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(st.conv), np.asarray(jst.conv),
                                   atol=ATOL)


def test_ssd_block_lengths_give_each_row_its_own_state(model):
    """A padded batch with ``lengths``: every row's output up to its length
    and its conv/ssm state equal the JAX block run on that row alone, cut
    to its length (lengths below the conv width included)."""
    jcfg, cfg, jparams, params = model
    jp, tp = _block_params(jparams, params, r=1)
    lens = [2, 19, 9, 24]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((len(lens), max(lens), cfg.d_model)) \
        .astype(np.float32)
    y, st = TS.ssd_block(_t(x), tp, cfg,
                         lengths=torch.tensor(lens, dtype=torch.int32))
    for i, n in enumerate(lens):
        jy, jst = JS.ssd_block(jnp.asarray(x[i:i + 1, :n]), jp, jcfg)
        np.testing.assert_allclose(_np(y[i:i + 1, :n]), np.asarray(jy),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(st.conv[i:i + 1]),
                                   np.asarray(jst.conv), atol=ATOL)
        np.testing.assert_allclose(_np(st.ssm[i:i + 1]),
                                   np.asarray(jst.ssm), atol=ATOL)


def test_ssd_block_prefill_from_a_state_matches_jax(model):
    """The block continues the conv and the scan from a state, as the JAX
    block does: the second half of a sequence from the first half's
    state."""
    jcfg, cfg, jparams, params = model
    jp, tp = _block_params(jparams, params)
    x = np.random.default_rng(8).standard_normal(
        (2, 22, cfg.d_model)).astype(np.float32)
    _, jst = JS.ssd_block(jnp.asarray(x[:, :9]), jp, jcfg)
    _, st = TS.ssd_block(_t(x[:, :9]), tp, cfg)
    jy, jst = JS.ssd_block(jnp.asarray(x[:, 9:]), jp, jcfg, state=jst)
    y, st = TS.ssd_block(_t(x[:, 9:]), tp, cfg, state=st)
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(_np(st.conv), np.asarray(jst.conv), atol=ATOL)
    np.testing.assert_allclose(_np(st.ssm), np.asarray(jst.ssm), atol=ATOL)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return toks, np.asarray(lens, np.int32)


def test_dense_cache_prefill_and_decode_match_jax(model):
    """init_cache, the dense prefill of a padded batch (prefill_group and
    _prefill_cache_entry, as the engine's dense prefill runs them) and
    decode_step, against the JAX prefill of each prompt alone and the JAX
    decode_step."""
    jcfg, cfg, jparams, params = model
    lens = [5, 13, 9]
    toks, lens_np = _prompts(cfg, lens)
    max_len = 24
    jcache = jax_init_cache(jcfg, len(lens), max_len, jnp.float32)
    cache = T.init_cache(cfg, len(lens), max_len, torch.float32, "cpu")
    for jb, tb in zip(jcache["blocks"], cache["blocks"]):
        assert sorted(jb) == sorted(tb) == ["conv", "ssm"]
        for key in jb:
            assert tuple(tb[key].shape) == jb[key].shape
            assert tb[key].dtype == torch.float32
    # JAX: one prompt at a time, stacked into slots
    rows, jlogits = [], []
    for i, n in enumerate(lens):
        lg, c = jax_prefill(jparams, jnp.asarray(toks[i:i + 1, :n]),
                            jnp.asarray([n]),
                            jax_init_cache(jcfg, 1, max_len, jnp.float32),
                            jcfg)
        jlogits.append(np.asarray(lg))
        rows.append(c)
    jcache = jax.tree.map(lambda *r: jnp.concatenate(r, axis=1), *rows)
    # port: the padded batch, each entry at its row's length
    logits, _ = T.prefill(params, torch.from_numpy(toks),
                          torch.from_numpy(lens_np), cache, None, cfg)
    np.testing.assert_allclose(_np(logits), np.concatenate(jlogits),
                               atol=ATOL)
    for jb, tb in zip(jcache["blocks"], cache["blocks"]):
        for key in jb:
            np.testing.assert_allclose(_np(tb[key]), np.asarray(jb[key]),
                                       atol=ATOL)
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.from_numpy(lens_np)
    for _ in range(3):
        jl, jcache = jax_decode_step(jparams, jcache,
                                     jnp.asarray(tok.numpy())[:, None],
                                     jnp.asarray(pos.numpy()), jcfg)
        lg, cache = T.decode_step(params, cache, tok[:, None], pos, cfg)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), atol=ATOL)
        tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
    for jb, tb in zip(jcache["blocks"], cache["blocks"]):
        for key in jb:
            np.testing.assert_allclose(_np(tb[key]), np.asarray(jb[key]),
                                       atol=ATOL)


def test_bridge_keeps_the_port_dtypes_per_leaf(model):
    """Under bf16 the bridge keeps A_log and the ssm state fp32, leaf for
    leaf as the port's init_params and init_cache give them."""
    jcfg, cfg, jparams, _ = model
    bf = torch.bfloat16
    bridged = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu", dtype=bf)
    ours = T.init_params(cfg, seed=0, dtype=bf, device="cpu")
    dt = lambda tree: jax.tree.map(lambda t: t.dtype, tree)   # noqa: E731
    assert dt(bridged) == dt(ours)
    assert ours["blocks"][0]["A_log"].dtype == torch.float32
    assert ours["blocks"][0]["in_proj"].dtype == bf
    jcache = jax_init_cache(jcfg, 2, 16, jnp.bfloat16)
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu",
                           dtype=bf)
    assert dt(cache) == dt(T.init_cache(cfg, 2, 16, bf, "cpu"))
    assert cache["blocks"][0]["ssm"].dtype == torch.float32
    assert cache["blocks"][0]["conv"].dtype == bf


def test_init_ones_and_lru(model):
    """The port's "ones" (D) and "lru" (A_log) inits: the JAX package's
    values and distribution (logit of U(0.1, 0.9))."""
    _, cfg, _, _ = model
    p = T.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    blk = p["blocks"][0]
    assert torch.equal(blk["D"], torch.ones_like(blk["D"]))
    a = blk["A_log"]
    lim = float(np.log(0.9 / 0.1))
    assert tuple(a.shape) == (cfg.n_pattern_repeats, cfg.ssm_n_heads)
    assert bool((a.abs() <= lim + 1e-6).all()) and a.std() > 0.3
    with pytest.raises(ValueError):
        T._init_one(torch.Generator(), (2,), "unknown", torch.float32)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

#: the mixed-length requests of the engine tests: prompt lengths, outputs
ENGINE_LENS = (5, 13, 9, 17, 3, 11)


def _config(mpb, **kw):
    return dict(slo=SLO(3.0, 150.0), max_slots=4, max_len=48,
                max_prefill_batch=mpb, **kw)


def _submit(server, cfg, req_cls, lens=ENGINE_LENS, out_len=6, seed=0):
    rng = np.random.default_rng(seed)
    for rid, n in enumerate(lens):
        server.submit(req_cls(rid=rid, arrival=0.0, prompt_len=n,
                              output_len=out_len),
                      rng.integers(0, cfg.vocab_size, n))


def _drive(server, now=0.0, max_cycles=500):
    for _ in range(max_cycles):
        if server.idle:
            break
        server.step(now)
        server.check_invariants()
        now += 1e-3
    assert server.idle
    return dict(server.outputs)


def _port(model, mpb, **kw):
    _, cfg, _, params = model
    return BulletServer(cfg, params, config=ServerConfig(**_config(mpb, **kw)),
                        device="cpu")


def _jax(model, mpb):
    jcfg, _, jparams, _ = model
    js = JServer(jcfg, jparams, config=JServerConfig(
        **{**_config(mpb), "slo": JSLO(3.0, 150.0)}))
    return js


@pytest.fixture(scope="module")
def jax_streams(model):
    """The JAX engine's streams, one prompt per prefill batch (the only
    composition under which its SSD state is each request's own)."""
    js = _jax(model, 1)
    _submit(js, model[1], JRequest)
    return _drive(js)


def test_engine_resolves_dense_serial_for_mamba(model):
    ts = _port(model, 1)
    assert not ts.paged and not ts.fused
    assert not T.supports_paged_cache(model[1])
    with pytest.raises(ValueError, match="paged"):
        _port(model, 1, cache=CacheConfig(paged=True))
    with pytest.raises(ValueError, match="paged"):
        ts.set_cache_mode(True, 0.0)


def test_engine_still_refuses_moe():
    """The engine refused MoE stacks until the MoE slice: now it builds
    over one and init_params gives its expert leaves. The encoder and
    cross-attention came with a later slice: init_params gives their
    leaves, and the engine refuses the cross-attention config, as the
    JAX package's route to it is the models-level one."""
    cfg = get_config("qwen3-1.7b").reduced(
        pattern=(BlockSpec(mixer=ATTN, ff=MOE),), n_experts=4,
        n_experts_per_token=2)
    params = T.init_params(cfg, dtype=torch.float32, device="cpu")
    assert params["blocks"][0]["w_in"].shape == (
        cfg.n_pattern_repeats, 4, cfg.d_model, 2 * cfg.d_ff)
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0)), device="cpu")
    assert server.moe_stats is not None
    enc = dataclasses.replace(cfg, n_encoder_layers=1, cross_attention=True,
                              encoder_seq_len=8, frontend_embed_len=8,
                              frontend_embed_dim=16)
    p_enc = T.init_params(enc, dtype=torch.float32, device="cpu")
    assert p_enc["encoder"]["wq"].shape[0] == 1
    assert {"ln_cross", "cwq", "cwk", "cwv", "cwo"} <= set(p_enc["blocks"][0])
    with pytest.raises(NotImplementedError, match="cross-attention"):
        BulletServer(enc, p_enc, config=ServerConfig(slo=SLO(3.0, 150.0)),
                     device="cpu")


def test_engine_streams_match_jax(model, jax_streams):
    ts = _port(model, 1)
    _submit(ts, model[1], Request)
    out = _drive(ts)
    assert out == jax_streams
    assert all(len(v) == 6 for v in out.values())
    assert ts.pool.available_blocks == ts.pool.n_blocks


@pytest.mark.parametrize("mpb", [2, 4])
def test_engine_streams_do_not_depend_on_the_batch(model, jax_streams, mpb):
    ts = _port(model, mpb)
    _submit(ts, model[1], Request)
    assert _drive(ts) == jax_streams
    assert ts.stats.prefill_cycles < len(ENGINE_LENS) * 2


def test_engine_streams_survive_a_preemption(model, jax_streams):
    """tests/port/test_torch_engine.py's recipe on the dense SSD cache: an
    older request's admission evicts a younger decode slot, which resumes
    by re-prefilling over its generated prefix; every stream equals the
    unpreempted one."""
    _, cfg, _, _ = model
    ts = _port(model, 4)
    ts.pool = PagedKVPool(48, block_size=16)      # 3 blocks: pressure
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (8, 30)]
    young = Request(rid=0, arrival=1.0, prompt_len=8, output_len=12)
    ts.submit(young, prompts[0])
    now = 1.0
    while young.phase != Phase.DECODE or young.generated < 4:
        ts.step(now)
        now += 1e-3
    old = Request(rid=1, arrival=0.0, prompt_len=30, output_len=4)
    ts.submit(old, prompts[1])
    while old.phase == Phase.QUEUED:
        ts.step(now)
        ts.check_invariants()
        now += 1e-3
    assert ts.stats.preempted == 1 and young.phase == Phase.QUEUED
    out = _drive(ts, now)
    # the same two requests on an unpressured server
    ref = _port(model, 4)
    for r, p in zip((Request(rid=0, arrival=1.0, prompt_len=8,
                             output_len=12),
                     Request(rid=1, arrival=0.0, prompt_len=30,
                             output_len=4)), prompts):
        ref.submit(r, p)
    assert out == _drive(ref)
    assert len(out[0]) == 12 and len(out[1]) == 4


def test_guard_leaves_a_dense_serial_server_alone(model, jax_streams):
    """The guard's fused and paged rungs skip a server that is natively
    serial and dense: failed prefill and decode dispatches are absorbed
    (the cycle's work is redone) with no transition, and streams hold."""
    plan = FaultPlan(seed=0, specs=[
        FaultSpec("dispatch", start=2, end=30, target="prefill", count=2),
        FaultSpec("dispatch", start=2, end=30, target="decode", count=2)])
    guard = SLOGuard()
    ts = _port(model, 4, faults=FaultInjector(plan), guard=guard)
    _submit(ts, model[1], Request)
    assert _drive(ts) == jax_streams
    assert ts.stats.dispatch_failures == 4
    assert guard.transitions == [] and not ts.paged and not ts.fused


def test_reference_split_is_pinned(model):
    """The JAX engine's padded prefill batch hands decode the SSD state after
    the padded tail: on the probe below, request 0's stream under
    ``max_prefill_batch=4`` differs from its stream under 1 after the first
    token (which reads the last real position). The port gives the
    ``max_prefill_batch=1`` streams under both."""
    jcfg, cfg, jparams, params = model
    probe = jax_config(ARCH).reduced()             # one layer, as found
    pparams = jax_init_params(probe, jax.random.PRNGKey(0), jnp.float32)
    outs, touts = {}, {}
    for mpb in (1, 4):
        js = JServer(probe, pparams, config=JServerConfig(
            **{**_config(mpb), "slo": JSLO(3.0, 150.0)}))
        _submit(js, probe, JRequest, lens=(5, 13, 9))
        outs[mpb] = _drive(js)
        ts = BulletServer(get_config(ARCH).reduced(),
                          params_from_jax(jax.tree.map(np.asarray, pparams),
                                          device="cpu"),
                          config=ServerConfig(**_config(mpb)), device="cpu")
        _submit(ts, cfg, Request, lens=(5, 13, 9))
        touts[mpb] = _drive(ts)
    assert outs[1][0] == [487, 487, 75, 427, 142, 167]
    assert outs[4][0][0] == outs[1][0][0]
    assert outs[4][0] != outs[1][0]
    assert touts[1] == touts[4] == outs[1]


@pytest.mark.parametrize("mode", ["host", "replay"])
def test_serve_mamba_on_cpu(capsys, mode):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--mode", mode,
                       "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "KV pool clean: True" in out
    assert "fused_cycles=0" in out
