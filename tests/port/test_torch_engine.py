"""Port ``BulletServer`` vs the JAX package's, on the CPU in fp32 with the
JAX params bridged: greedy token streams identical in serial, fused and
preempt→resume runs, ``check_invariants`` holding after every cycle, and
the sequence of CycleObservations identical when both engines get the
same HardwareSpec fields. Both engines run on a virtual clock (cycle i at
i ms), so their scheduling decisions are deterministic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core.config import CacheConfig as JCacheConfig
from repro.core.config import ControlConfig as JControlConfig
from repro.core.config import ExecConfig as JExecConfig
from repro.core.config import ServerConfig as JServerConfig
from repro.core.engine import BulletServer as JServer
from repro.core.estimator import HardwareSpec as JHardwareSpec
from repro.core.estimator import PerfEstimator as JPerfEstimator
from repro.kvcache.paged import PagedKVPool as JPool
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.models import init_params as jax_init_params
from repro.serving.request import Phase as JPhase
from repro.serving.request import Request as JRequest
from repro.serving.request import SLO as JSLO
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.config import (CacheConfig, ControlConfig, ExecConfig,
                                    ServerConfig)
from repro_torch.core.engine import BulletServer
from repro_torch.core.estimator import HardwareSpec, PerfEstimator
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.serving.frontend import OnlineFrontend, VirtualClock
from repro_torch.serving.request import SLO, Phase, Request

#: a small partition table keeps the JAX engine's per-decode_share
#: recompiles few; both engines get exactly these fields
HW = dict(name="h100-sxm", n_chips=1, peak_flops=989e12, hbm_bw=3.35e12,
          ici_bw=450e9, units_per_chip=8, grid_slots=8)


def _model():
    # 2 pattern repeats -> 2 layer-group launches per prefill, so decode
    # iterations (and fused cycles) interleave with in-flight prefills
    jcfg = jax_config("qwen3-1.7b").reduced(n_layers=2)
    cfg = get_config("qwen3-1.7b").reduced(n_layers=2)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def model():
    return _model()


def _servers(model, **kw):
    """A JAX and a port server with the same settings: tests/test_fused.py's
    (one prompt per prefill batch, no §3.3.3 decode pause, so later
    admissions' layer groups co-run with earlier requests' decode)."""
    jcfg, cfg, jparams, params = model
    fused = kw.pop("fused", None)
    base = dict(max_slots=4, max_len=48, max_prefill_batch=1)
    base.update(kw)
    js = JServer(jcfg, jparams, config=JServerConfig(
        slo=JSLO(3.0, 150.0), est=JPerfEstimator(JHardwareSpec(**HW)),
        cache=JCacheConfig(paged=True), execution=JExecConfig(fused=fused),
        control=JControlConfig(
            sched=JSchedulerConfig(max_decode_pause_cycles=0)), **base))
    ts = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=PerfEstimator(HardwareSpec(**HW)),
        execution=ExecConfig(fused=fused),
        control=ControlConfig(sched=SchedulerConfig(max_decode_pause_cycles=0)),
        **base), device="cpu")
    return js, ts


def _submit(js, ts, cfg, n=6, seed=0, out_len=8, arrival=0.0):
    rng = np.random.default_rng(seed)
    for rid in range(n):
        plen = int(rng.integers(4, 16))
        prompt = rng.integers(0, cfg.vocab_size, plen)
        js.submit(JRequest(rid=rid, arrival=arrival, prompt_len=plen,
                           output_len=out_len), prompt)
        ts.submit(Request(rid=rid, arrival=arrival, prompt_len=plen,
                          output_len=out_len), prompt)


def _drive(server, now=0.0, max_cycles=400):
    """Step until idle on the virtual clock, auditing every cycle; returns
    the per-cycle (CycleObservation, fused?) trace."""
    trace = []
    for _ in range(max_cycles):
        if server.idle:
            break
        server.step(now)
        server.check_invariants()
        trace.append((server.last_cycle_observation(), server.last_fused))
        now += 1e-3
    assert server.idle
    return trace


@pytest.mark.parametrize("fused", [False, True])
def test_token_streams_and_observations_match_jax(model, fused):
    js, ts = _servers(model, fused=fused)
    _submit(js, ts, model[1])
    jtrace = _drive(js)
    ttrace = _drive(ts)
    assert ts.outputs == js.outputs
    assert all(len(v) == 8 for v in ts.outputs.values())
    assert ttrace == jtrace
    assert ts.stats.fused_cycles == js.stats.fused_cycles
    if fused:
        assert ts.stats.fused_cycles > 0
    assert ts.pool.available_blocks == ts.pool.n_blocks


def _preemption_scenario(server, cfg, pool_cls, req_cls, phase):
    """tests/test_paged_cache.py's recipe: force a KV-pressure eviction
    mid-decode, then drain."""
    server.pool = pool_cls(48, block_size=16)       # 3 blocks: pressure
    rng = np.random.default_rng(1)
    young = req_cls(rid=0, arrival=1.0, prompt_len=8, output_len=12)
    server.submit(young, rng.integers(0, cfg.vocab_size, 8))
    now = 1.0
    while young.phase != phase.DECODE:
        server.step(now)
        server.check_invariants()
        now += 1e-3
    for _ in range(3):
        server.step(now)
        server.check_invariants()
        now += 1e-3
    old = req_cls(rid=1, arrival=0.0, prompt_len=30, output_len=4)
    server.submit(old, rng.integers(0, cfg.vocab_size, 30))
    while old.phase == phase.QUEUED:
        server.step(now)
        server.check_invariants()
        now += 1e-3
    assert server.stats.preempted == 1
    assert young.phase == phase.QUEUED
    _drive(server, now)
    return young, old


@pytest.mark.parametrize("fused", [False, True])
def test_preempt_resume_matches_jax(model, fused):
    js, ts = _servers(model, fused=fused, max_slots=2, max_len=40,
                      max_prefill_batch=1)
    cfg = model[1]
    jy, jo = _preemption_scenario(js, cfg, JPool, JRequest, JPhase)
    ty, to = _preemption_scenario(ts, cfg, PagedKVPool, Request, Phase)
    assert ty.phase == to.phase == Phase.FINISHED
    assert len(ts.outputs[0]) == 12 and len(ts.outputs[1]) == 4
    assert ts.outputs == js.outputs
    assert ts.pool.free_blocks == ts.pool.n_blocks


def test_fused_engine_matches_serial_engine(model):
    jcfg, cfg, _, params = model
    outs = {}
    for fused in (False, True):
        _, ts = _servers(model, fused=fused)
        rng = np.random.default_rng(0)
        for rid in range(6):
            plen = int(rng.integers(4, 16))
            ts.submit(Request(rid=rid, arrival=0.0, prompt_len=plen,
                              output_len=8),
                      rng.integers(0, cfg.vocab_size, plen))
        _drive(ts)
        outs[fused] = dict(ts.outputs)
        assert ts.stats.fused_cycles > 0 if fused else True
    assert outs[True] == outs[False]


def test_fused_cycle_runs_a_prebuilt_executable(model):
    _, ts = _servers(model)
    assert ts.fused and ts.scheduler.sc.fused
    shares = {round(p.decode_share, 6) for p in ts.rm.tile_entries}
    assert len(shares) == HW["units_per_chip"] // 2 + 1
    rng = np.random.default_rng(3)
    for rid in range(4):
        ts.submit(Request(rid=rid, arrival=0.0, prompt_len=9, output_len=6),
                  rng.integers(0, 500, 9))
    seen = set()
    now = 0.0
    while not ts.idle:
        ts.step(now)
        if ts.last_fused:
            seen.add(ts.last_fused_exec)
            assert ts.rm.executable().config_id == ts.last_fused_exec
        now += 1e-3
    assert seen


def test_cancel_and_set_fused(model):
    _, ts = _servers(model)
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, arrival=0.0, prompt_len=6, output_len=8)
            for i in range(3)]
    for r in reqs:
        ts.submit(r, rng.integers(0, 500, 6))
    now = 0.0
    while reqs[0].phase != Phase.DECODE:
        ts.step(now)
        now += 1e-3
    ts.cancel_request(reqs[0], now)
    assert reqs[0].phase == Phase.CANCELLED
    ts.check_invariants()
    ts.set_fused(False)
    assert not ts.scheduler.sc.fused
    _drive(ts, now)
    assert ts.stats.cancelled == 1
    assert ts.pool.available_blocks == ts.pool.n_blocks


def test_record_cycle_actual_logs_prediction(model):
    _, ts = _servers(model)
    rng = np.random.default_rng(5)
    ts.submit(Request(rid=0, arrival=0.0, prompt_len=7, output_len=3),
              rng.integers(0, 500, 7))
    ts.step(0.0)
    ts.record_cycle_actual(1e-3)
    kind, pred, actual = ts.pred_actual[-1]
    assert kind == "serial" and pred > 0 and actual == 1e-3


def test_later_slices_raise_not_implemented(model):
    """Chip granularity is the one later slice left in the config; the
    shared-prefix and tenancy fields build a server, and the frontend's
    multi-turn entry point runs."""
    from repro_torch.serving.tenancy import TenancyController
    with pytest.raises(NotImplementedError, match="chip"):
        ExecConfig(partition="chip")
    with pytest.raises(NotImplementedError, match="chip"):
        ExecConfig(devices=("cuda:0", "cuda:1"))
    _, cfg, _, params = model
    ten = TenancyController()
    ts = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), cache=CacheConfig(share_prefix=True),
        tenancy=ten), device="cpu")
    assert ts.share_prefix and ts.pool.share_prefix and ts.tenancy is ten
    fe = OnlineFrontend(ts, VirtualClock())
    fe.submit_interactions([], model[1].vocab_size)
    assert fe.run().n_requests == 0
