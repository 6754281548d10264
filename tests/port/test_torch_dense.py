"""The port's dense slot-cache path vs the JAX package, on the CPU in fp32:
the dense decode and dense fused attention ops (plain versions) against
the Pallas kernels in interpret mode; ``init_cache``, ``_prefill_cache_entry``
and the dense ``decode_step`` against ``models/transformer.py`` (linear and
ring caches); and ``BulletServer(paged=False)`` greedy streams against the
JAX engine's, serial and through a preemption."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.config import CacheConfig as JCacheConfig
from repro.core.config import ControlConfig as JControlConfig
from repro.core.config import ServerConfig as JServerConfig
from repro.core.engine import BulletServer as JServer
from repro.core.estimator import HardwareSpec as JHardwareSpec
from repro.core.estimator import PerfEstimator as JPerfEstimator
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.kernels import bullet_attention_op as jax_bullet_op
from repro.kernels import decode_attention_op as jax_decode_op
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kvcache.paged import PagedKVPool as JPool
from repro.models import init_params as jax_init_params
from repro.models import transformer as JT
from repro.serving.request import Phase as JPhase
from repro.serving.request import Request as JRequest
from repro.serving.request import SLO as JSLO
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import engine as E
from repro_torch.core.config import (CacheConfig, ControlConfig, ExecConfig,
                                    ServerConfig)
from repro_torch.core.engine import BulletServer
from repro_torch.core.estimator import HardwareSpec, PerfEstimator
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.kernels import decode_attention as TD
from repro_torch.kernels import ops
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.models import transformer as T
from repro_torch.serving.request import SLO, Phase, Request

ATOL = 2e-5
HW = dict(name="h100-sxm", n_chips=1, peak_flops=989e12, hbm_bw=3.35e12,
          ici_bw=450e9, units_per_chip=8, grid_slots=8)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _kv_positions(kind, b, s):
    """Linear rows, or tests/test_kernels.py's scrambled ring with holes."""
    base = np.broadcast_to(np.arange(s)[None], (b, s))
    if kind == "linear":
        return np.ascontiguousarray(base).astype(np.int32)
    return np.where(base % 5 == 0, -1, (base * 13) % 80).astype(np.int32)


def _decode_inputs(seed, b, kh, g, s, d=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 1, kh * g, d)).astype(np.float32),
            rng.normal(size=(b, s, kh, d)).astype(np.float32),
            rng.normal(size=(b, s, kh, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# (i) kernel plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,s,pos", [
    ("linear", 64, (40, 63)),
    ("ring", 64, (40, 70)),
    ("linear", 72, (50, 71)),          # a tail past the last full 16 rows
])
def test_decode_op_matches_pallas(kind, s, pos):
    b, kh, g = 2, 2, 2
    q, kc, vc = _decode_inputs(s + len(kind), b, kh, g, s)
    kvpos = _kv_positions(kind, b, s)
    pos = np.asarray(pos, np.int32)
    got = ops.decode_attention_op(_t(q), _t(kc), _t(vc), _t(kvpos),
                                  _t(pos)).numpy()
    want = jax_decode_op(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(kvpos), jnp.asarray(pos),
                         interpret=True)
    np.testing.assert_allclose(got, _np(want), atol=ATOL)
    if s % 32:
        # the Pallas kernel padding its tail block (block_s=32) agrees too
        tail = jax_decode(jnp.asarray(q[:, 0].reshape(b, kh, g, -1)),
                          jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(kvpos), jnp.asarray(pos), block_s=32,
                          interpret=True)
        np.testing.assert_allclose(got[:, 0].reshape(b, kh, g, -1),
                                   _np(tail), atol=ATOL)
    # the wrapper on the kernel layout is the same plain version
    lay = TD.decode_attention(_t(q[:, 0].reshape(b, kh, g, -1)), _t(kc),
                              _t(vc), _t(kvpos), _t(pos))
    np.testing.assert_allclose(lay.numpy(), got[:, 0].reshape(b, kh, g, -1))


@pytest.mark.parametrize("share", [0.0, 0.25, 0.5, 0.75, 1.0])
@pytest.mark.parametrize("kind", ["linear", "ring"])
def test_bullet_op_matches_pallas(share, kind):
    """tests/test_kernels.py's shares: the dense fused op equals the Pallas
    bullet kernel, and flash + dense decode run apart."""
    bp, sp, h, kh, d = 2, 32, 4, 2, 32
    bd, sk = 2, 72
    rng = np.random.default_rng(7)
    qp, kp, vp = (rng.normal(size=(bp, sp, n, d)).astype(np.float32)
                  for n in (h, kh, kh))
    qd, kd, vd = _decode_inputs(8, bd, kh, h // kh, sk, d)
    kvpos = _kv_positions(kind, bd, sk)
    pos = np.asarray([40, 71], np.int32)
    op, od = ops.bullet_attention_op(_t(qp), _t(kp), _t(vp), _t(qd), _t(kd),
                                     _t(vd), _t(kvpos), _t(pos),
                                     decode_share=share)
    jp, jd = jax_bullet_op(*(jnp.asarray(a) for a in
                             (qp, kp, vp, qd, kd, vd, kvpos, pos)),
                           decode_share=share, interpret=True)
    np.testing.assert_allclose(op.numpy(), _np(jp), atol=ATOL)
    np.testing.assert_allclose(od.numpy(), _np(jd), atol=ATOL)
    np.testing.assert_array_equal(
        od.numpy(), ops.decode_attention_op(_t(qd), _t(kd), _t(vd),
                                            _t(kvpos), _t(pos)).numpy())
    np.testing.assert_array_equal(
        op.numpy(), ops.flash_attention_op(_t(qp), _t(kp), _t(vp)).numpy())


# ---------------------------------------------------------------------------
# (ii) the dense cache in the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("qwen3-1.7b").reduced(n_layers=2)
    cfg = get_config("qwen3-1.7b").reduced(n_layers=2)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


def test_dense_prefill_and_decode_match_jax(model):
    jcfg, cfg, jparams, params = model
    b, s, max_len = 2, 11, 24
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.asarray([s, 7], np.int32)
    jcache = JT.init_cache(jcfg, b, max_len, jnp.float32)
    jlogits, jcache = JT.prefill(jparams, jnp.asarray(toks),
                                 jnp.asarray(lens), jcache, jcfg)
    cache = T.init_cache(cfg, b, max_len, torch.float32, "cpu")
    assert [tuple(e["k"].shape) for e in cache["blocks"]] == \
        [tuple(e["k"].shape) for e in jcache["blocks"]]
    x = T.embed_tokens(params, _t(toks), cfg)
    positions = torch.arange(s)[None]
    for rep in range(cfg.n_pattern_repeats):
        x = E._prefill_group(params, x, positions, cache, _t(lens), cfg=cfg,
                             rep=rep)
    _close(T.last_token_logits(params, x, _t(lens), cfg), jlogits)
    for je, te in zip(jcache["blocks"], cache["blocks"]):
        _close(te["k"], je["k"])
        _close(te["v"], je["v"])
    pos = lens.copy()
    tok = np.asarray(jnp.argmax(jlogits, -1), np.int32)[:, None]
    for _ in range(3):
        jl, jcache = JT.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg)
        tl, _ = T.decode_step(params, cache, _t(tok), _t(pos), cfg)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        pos = pos + 1
    for je, te in zip(jcache["blocks"], cache["blocks"]):
        _close(te["k"], je["k"])
        _close(te["v"], je["v"])


def test_ring_cache_matches_jax(model):
    """The long-context ring: ``_prefill_cache_entry`` gathers the latest
    window and decode wraps around it (positions from ``_kv_positions``)."""
    jcfg, cfg, jparams, params = model
    b, s, max_len = 2, 80, 96
    w = cfg.long_context_window
    assert w < s
    blk = cfg.pattern[0]
    rng = np.random.default_rng(1)
    lens = np.asarray([s, 70], np.int32)
    jtpl = JT.init_cache(jcfg, b, max_len, jnp.float32, long_context=True)
    ttpl = T.init_cache(cfg, b, max_len, torch.float32, "cpu",
                        long_context=True)
    assert ttpl["blocks"][0]["k"].shape[2] == w
    jcache, tcache = [], []
    for j in range(len(cfg.pattern)):
        reps_j, reps_t = [], []
        for r in range(cfg.n_pattern_repeats):
            kv = {key: rng.normal(size=(b, s, cfg.n_kv_heads, cfg.head_dim))
                  .astype(np.float32) for key in ("k", "v")}
            je = JT._prefill_cache_entry(
                {k: jnp.asarray(v) for k, v in kv.items()}, blk, jcfg,
                jnp.asarray(lens), {k: jtpl["blocks"][j][k][r]
                                    for k in ("k", "v")}, True)
            te = T._prefill_cache_entry(
                {k: _t(v) for k, v in kv.items()}, blk, cfg, _t(lens),
                {k: ttpl["blocks"][j][k][r] for k in ("k", "v")}, True)
            _close(te["k"], je["k"])
            _close(te["v"], je["v"])
            reps_j.append(je)
        jcache.append({k: jnp.stack([e[k] for e in reps_j])
                       for k in ("k", "v")})
    jcache = {"blocks": tuple(jcache)}
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    pos = lens.copy()
    tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = JT.decode_step(jparams, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg,
                                    long_context=True)
        tl, _ = T.decode_step(params, tcache, _t(tok), _t(pos), cfg,
                              long_context=True)
        _close(tl, jl)
        np.testing.assert_array_equal(
            T._kv_positions(_t(pos), w, True).numpy(),
            np.asarray(JT._kv_positions(jnp.asarray(pos), w, True)))
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        pos = pos + 1
    for je, te in zip(jcache["blocks"], tcache["blocks"]):
        _close(te["k"], je["k"])


# ---------------------------------------------------------------------------
# (iii) the dense engine
# ---------------------------------------------------------------------------

def _servers(model, **kw):
    jcfg, cfg, jparams, params = model
    base = dict(max_slots=4, max_len=48, max_prefill_batch=2)
    base.update(kw)
    js = JServer(jcfg, jparams, config=JServerConfig(
        slo=JSLO(3.0, 150.0), est=JPerfEstimator(JHardwareSpec(**HW)),
        cache=JCacheConfig(paged=False),
        control=JControlConfig(
            sched=JSchedulerConfig(max_decode_pause_cycles=0)), **base))
    ts = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=PerfEstimator(HardwareSpec(**HW)),
        cache=CacheConfig(paged=False),
        control=ControlConfig(sched=SchedulerConfig(max_decode_pause_cycles=0)),
        **base), device="cpu")
    return js, ts


def _drive(server, now=0.0, max_cycles=400):
    for _ in range(max_cycles):
        if server.idle:
            break
        server.step(now)
        server.check_invariants()
        now += 1e-3
    assert server.idle


def test_dense_engine_streams_match_jax(model):
    js, ts = _servers(model)
    assert not ts.paged and not ts.fused
    cfg = model[1]
    assert tuple(ts.cache["blocks"][0]["k"].shape) == (
        cfg.n_pattern_repeats, 4, 48, cfg.n_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(0)
    for rid in range(6):
        plen = int(rng.integers(4, 16))
        prompt = rng.integers(0, model[1].vocab_size, plen)
        js.submit(JRequest(rid=rid, arrival=0.0, prompt_len=plen,
                           output_len=8), prompt)
        ts.submit(Request(rid=rid, arrival=0.0, prompt_len=plen,
                          output_len=8), prompt)
    _drive(js)
    _drive(ts)
    assert ts.outputs == js.outputs
    assert all(len(v) == 8 for v in ts.outputs.values())
    assert vars(ts.stats)["decode_iterations"] == js.stats.decode_iterations
    assert ts.pool.available_blocks == ts.pool.n_blocks
    with pytest.raises(ValueError, match="paged"):
        ts.set_fused(True)


def test_dense_engine_preempt_resume_matches_jax(model):
    """tests/test_paged_cache.py's KV-pressure recipe on the dense cache:
    the evicted request re-prefills its generated prefix into its row."""
    js, ts = _servers(model, max_slots=2, max_len=40, max_prefill_batch=1)
    outs = []
    for server, pool_cls, req_cls, phase in (
            (js, JPool, JRequest, JPhase), (ts, PagedKVPool, Request, Phase)):
        server.pool = pool_cls(48, block_size=16)
        rng = np.random.default_rng(1)
        young = req_cls(rid=0, arrival=1.0, prompt_len=8, output_len=12)
        server.submit(young, rng.integers(0, model[1].vocab_size, 8))
        now = 1.0
        while young.phase != phase.DECODE:
            server.step(now)
            now += 1e-3
        for _ in range(3):
            server.step(now)
            now += 1e-3
        old = req_cls(rid=1, arrival=0.0, prompt_len=30, output_len=4)
        server.submit(old, rng.integers(0, model[1].vocab_size, 30))
        while old.phase == phase.QUEUED:
            server.step(now)
            server.check_invariants()
            now += 1e-3
        assert server.stats.preempted == 1
        _drive(server, now)
        outs.append(dict(server.outputs))
    assert outs[1] == outs[0]
    assert len(outs[1][0]) == 12 and len(outs[1][1]) == 4


def test_fused_needs_the_paged_cache(model):
    with pytest.raises(ValueError, match="paged"):
        BulletServer(model[1], model[3], config=ServerConfig(
            slo=SLO(3.0, 150.0), cache=CacheConfig(paged=False),
            execution=ExecConfig(fused=True)), device="cpu")
