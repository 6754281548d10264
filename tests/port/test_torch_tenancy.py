"""The tenant layer in the port (docs/MULTITENANCY.md):
``repro_torch.serving.tenancy`` (a copy of the JAX module, imports
rewritten), its engine hooks (``core/engine.py``: ``attach`` and the
credit tier at construction, ``track`` on submit, the credit-biased
preemption victim, ``on_finish``, ``on_cancel``) and the frontend's tenant
gate and multi-turn ``submit_interactions`` (``serving/frontend.py``).

On the CPU, fp32, the JAX params bridged, both estimators given the JAX
package's default HardwareSpec fields (the recipes' own pricing): the
copy against the original on seeded gate, credit and tier sequences and
on the trace generators; ``tests/test_tenancy.py``'s engine recipes (a
flood-plus-nice trace tenancy-off, under a permissive controller and
under the full stack; the preemption victim) and ``tests/test_system.py``'s
interaction replay (serial and fused) on the torch engine, with the JAX
engine's streams, admission order, metrics and tenant counters; and the
launcher's multi-tenant replay with sharing and its argument checks."""

import dataclasses
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import config as JC
from repro.core.engine import BulletServer as JServer
from repro.core.estimator import HardwareSpec as JHardwareSpec
from repro.core.estimator import PerfEstimator as JPerfEstimator
from repro.kvcache.paged import PagedKVPool as JPool
from repro.obs import Observability as JObservability
from repro.serving import frontend as JF
from repro.serving import request as JR
from repro.serving import tenancy as JT
from repro_torch.core import config as TC
from repro_torch.core.engine import BulletServer
from repro_torch.core.estimator import HardwareSpec, PerfEstimator
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.obs import Observability
from repro_torch.serving import frontend as TF
from repro_torch.serving import request as TR
from repro_torch.serving import tenancy as TT

#: the JAX package's default HardwareSpec, as its tenancy recipes price
HW = dataclasses.asdict(JHardwareSpec())


def _side(port: bool):
    """(server, config, frontend, request, tenancy, pool, obs, estimator,
    device kwargs) of one package."""
    if port:
        return SimpleNamespace(Server=BulletServer, C=TC, F=TF, R=TR, T=TT,
                               Pool=PagedKVPool, Obs=Observability,
                               est=lambda: PerfEstimator(HardwareSpec(**HW)),
                               kw=dict(device="cpu"))
    return SimpleNamespace(Server=JServer, C=JC, F=JF, R=JR, T=JT, Pool=JPool,
                           Obs=JObservability,
                           est=lambda: JPerfEstimator(JHardwareSpec(**HW)),
                           kw={})


def _stats(ten):
    return {a: dataclasses.astuple(s) for a, s in sorted(ten.stats.items())}


# ---------------------------------------------------------------------------
# the copy against the original
# ---------------------------------------------------------------------------

def _storm(port: bool, seed: int):
    """A seeded sequence of gate / finish / cancel / track calls and KV
    pressure flips; returns every verdict, credit and tier on the way and
    the controller's end state."""
    s = _side(port)
    rng = np.random.default_rng(seed)
    pool = s.Pool(64, block_size=4)
    ten = s.T.TenancyController(
        s.T.make_apps(4, rate_limit=int(rng.integers(1, 4))),
        s.T.TenancyConfig(rate_limit=2, window_s=0.5, max_defers=2,
                          ewma=0.3, tiers=4))
    ten.attach(SimpleNamespace(pool=pool))
    slo = s.R.SLO(3.0, 150.0)
    out, now = [], 0.0
    for rid in range(300):
        now += float(rng.exponential(0.05))
        op = rng.choice(["gate", "gate", "finish", "cancel", "pressure"])
        app = int(rng.integers(0, 5))          # app 4 is no registered App
        req = s.R.Request(rid=rid, arrival=now, prompt_len=8, output_len=4,
                          app_id=app, turn_index=int(rng.integers(0, 3)))
        if op == "gate":
            ten.track(req)
            out.append(ten.gate(req, now, int(rng.integers(0, 4))))
        elif op == "finish":
            req.phase = s.R.Phase.FINISHED
            req.first_token_time = now + float(rng.exponential(0.05))
            req.finish_time = req.first_token_time + 0.001
            req.generated = 4
            ten.on_finish(req, slo)
        elif op == "cancel":
            ten.on_cancel(req, "deadline")
        elif pool.table(0) is None:
            pool.allocate(0, 60)               # past kv_pressure
        else:
            pool.free(0)
        out.append((ten.tier(int(rng.integers(0, rid + 1))),
                    [ten.credit(a) for a in range(5)]))
    return out, _stats(ten), ten.throttle_log, ten.per_tenant_goodput()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tenancy_copy_matches_jax(seed):
    got, want = _storm(True, seed), _storm(False, seed)
    assert got == want
    verdicts = {v for v in got[0] if isinstance(v, str)}
    assert verdicts == {"admit", "defer", "throttle"}


def test_tenant_generators_copy_matches_jax():
    def rows(trace):
        return [(s.session_id, s.arrival, s.user_id, s.app_id,
                 [dataclasses.astuple(t) for t in s.turns]) for s in trace]
    assert TT.zipf_shares(5, 0.8).tolist() == JT.zipf_shares(5, 0.8).tolist()
    assert [dataclasses.astuple(a) for a in TT.make_apps(4, rate_limit=3)] \
        == [dataclasses.astuple(a) for a in JT.make_apps(4, rate_limit=3)]
    for skew in (None, {0: 20.0}):
        assert rows(TT.generate_tenant_interactions(
            TT.make_apps(4), 40, 32.0, turns=3, seed=5, rate_skew=skew)) == \
            rows(JT.generate_tenant_interactions(
                JT.make_apps(4), 40, 32.0, turns=3, seed=5, rate_skew=skew))
    assert rows(TT.generate_fleet_interactions(200, 50.0, seed=2)) == \
        rows(JT.generate_fleet_interactions(200, 50.0, seed=2))
    assert TT.jain_index([3, 1, 0, 2]) == JT.jain_index([3, 1, 0, 2])
    reqs = {}
    for port, s in ((True, _side(True)), (False, _side(False))):
        rs = []
        for rid, (phase, why) in enumerate([("FINISHED", None),
                                            ("CANCELLED", "throttled"),
                                            ("CANCELLED", "shed"),
                                            ("FINISHED", None)]):
            r = s.R.Request(rid=rid, arrival=0.0, prompt_len=8, output_len=4,
                            app_id=rid % 2)
            r.phase, r.cancel_reason = s.R.Phase[phase], why
            r.first_token_time, r.finish_time = 0.5 * rid, 0.5 * rid + 0.01
            r.generated = 4
            rs.append(r)
        reqs[port] = {a: dataclasses.astuple(st) for a, st in
                      s.T.per_tenant_outcomes(rs, s.R.SLO(3.0, 150.0)).items()}
    assert reqs[True] == reqs[False]


# ---------------------------------------------------------------------------
# tests/test_tenancy.py's engine recipes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    import test_torch_engine
    return test_torch_engine._model()


def _trace(T):
    """One flooding tenant + two nice ones (tests/test_tenancy.py)."""
    apps = T.make_apps(3)
    flood = T.generate_tenant_interactions(
        [apps[0]], 10, rate_s=2000.0, turns=2, new_tokens=6,
        output_tokens=16, seed=5)
    nice = T.generate_tenant_interactions(
        apps[1:], 4, rate_s=100.0, zipf_a=0.0, turns=3, new_tokens=6,
        output_tokens=16, seed=6)
    return flood + [replace(s, session_id=s.session_id + 10) for s in nice]


def _replay(model, port: bool, tenancy: str):
    s = _side(port)
    jcfg, cfg, jparams, params = model
    ten = {"off": None,
           "neutral": lambda: s.T.TenancyController(
               s.T.make_apps(3), s.T.TenancyConfig(
                   credit=False, rate_limit=0, kv_pressure=1.01)),
           "full": lambda: s.T.TenancyController(
               s.T.make_apps(3), s.T.TenancyConfig(credit=True,
                                                   rate_limit=2))}[tenancy]
    ten = ten() if ten is not None else None
    srv = s.Server(cfg if port else jcfg, params if port else jparams,
                   config=s.C.ServerConfig(
                       slo=s.R.WORKLOAD_SLOS["sharegpt"], est=s.est(),
                       max_slots=2, max_len=96,
                       cache=s.C.CacheConfig(paged=True, page_size=4),
                       obs=s.Obs(), tenancy=ten), **s.kw)
    fe = s.F.OnlineFrontend(srv, s.F.VirtualClock(),
                            on_cycle=lambda v, now: v.check_invariants())
    fe.submit_interactions(_trace(s.T), cfg.vocab_size, seed=5)
    m = fe.run()
    assert not fe.truncated
    streams = {r.rid: list(srv.outputs[r.rid]) for r in fe.requests
               if r.phase.name == "FINISHED"}
    return SimpleNamespace(fe=fe, srv=srv, m=m, streams=streams, ten=ten,
                           T=s.T, R=s.R)


@pytest.fixture(scope="module")
def replays(model):
    return {(port, t): _replay(model, port, t)
            for port in (True, False) for t in ("off", "neutral", "full")}


def _summary(run):
    tenant = [ln for ln in run.srv.obs.registry.render().splitlines()
              if ln.startswith("bullet_tenant_")]
    return (run.streams, dataclasses.astuple(run.m), run.fe.admitted_order,
            run.fe.throttled, [(r.rid, r.session_id, r.turn_index,
                                r.phase.name, r.cancel_reason)
                               for r in run.fe.requests],
            _stats(run.ten) if run.ten is not None else None, tenant)


@pytest.mark.parametrize("tenancy", ["off", "neutral", "full"])
def test_tenant_replay_matches_jax(replays, tenancy):
    got = _summary(replays[True, tenancy])
    assert got == _summary(replays[False, tenancy])
    assert got[0] and any(r[2] > 0 for r in got[4])   # follow-up turns


def test_permissive_controller_is_byte_identical(replays):
    off, neutral = replays[True, "off"], replays[True, "neutral"]
    assert neutral.streams == off.streams
    assert neutral.fe.admitted_order == off.fe.admitted_order
    assert neutral.m == off.m
    assert not neutral.fe.throttled and not neutral.ten.throttle_log
    assert sum(s.admitted for s in neutral.ten.stats.values()) \
        == len(off.fe.admitted_order)


def test_full_stack_throttles_only_opening_turns(replays):
    full = replays[True, "full"]
    assert full.fe.throttled
    full.ten.check_oit()
    by_rid = {r.rid: r for r in full.fe.requests}
    for rid in full.fe.throttled:
        assert by_rid[rid].phase.name == "CANCELLED"
        assert by_rid[rid].cancel_reason == "throttled"
        assert by_rid[rid].turn_index == 0
    assert any(r.turn_index > 0 for r in full.fe.requests
               if r.phase.name == "FINISHED")
    assert sum(s.throttled for s in full.ten.stats.values()) == len(
        full.fe.throttled)


def test_full_stack_improves_fairness(replays):
    T, slo = TT, TR.WORKLOAD_SLOS["sharegpt"]
    per = {t: T.per_tenant_outcomes(replays[True, t].fe.requests, slo)
           for t in ("off", "full")}
    jain = {t: T.jain_index([p[a].goodput if a in p else 0
                             for a in range(3)]) for t, p in per.items()}
    assert jain["full"] > jain["off"]

    def nice(p):
        return sum(s.goodput for a, s in p.items() if a != 0)
    assert nice(per["full"]) > nice(per["off"])
    assert replays[True, "full"].m.goodput >= replays[True, "off"].m.goodput


@pytest.mark.parametrize("credit", [False, True])
def test_preempt_victim_choice(model, credit):
    """FIFO evicts the globally youngest decode; with credit scoring the
    youngest within the lowest-credit tenant goes first."""
    _, cfg, _, params = model
    ten = TT.TenancyController(TT.make_apps(2), TT.TenancyConfig(credit=credit))
    srv = BulletServer(cfg, params, config=TC.ServerConfig(
        slo=TR.WORKLOAD_SLOS["sharegpt"], max_slots=2, max_len=48,
        cache=TC.CacheConfig(paged=True, page_size=4), tenancy=ten),
        device="cpu")
    assert (srv.scheduler.priority is not None) == credit
    reqs = []
    for rid, arrival, app, slot in ((1, 1.0, 0, 0), (2, 2.0, 1, 1)):
        r = TR.Request(rid=rid, arrival=arrival, prompt_len=8, output_len=4,
                       app_id=app)
        r.phase, r._slot = TR.Phase.DECODE, slot
        srv.pool.allocate(rid, 12)
        srv.slot_req[slot] = r
        srv.active[slot] = True
        reqs.append(r)
    ten._credit[0] = TT._CreditState(viol_ewma=1.0, tail_ewma=1.0)
    incoming = TR.Request(rid=9, arrival=0.5, prompt_len=8, output_len=4,
                          app_id=1)
    assert srv._preempt_for(incoming, now=3.0)
    victim, survivor = reqs if credit else reqs[::-1]
    assert victim.phase == TR.Phase.QUEUED and victim in srv.pending
    assert survivor.phase == TR.Phase.DECODE


# ---------------------------------------------------------------------------
# tests/test_system.py's interaction replay, serial and fused
# ---------------------------------------------------------------------------

def _replay_mode(model, port: bool, fused: bool):
    s = _side(port)
    jcfg, cfg, jparams, params = model
    srv = s.Server(cfg if port else jcfg, params if port else jparams,
                   config=s.C.ServerConfig(
                       slo=s.R.SLO(3.0, 150.0), est=s.est(), max_slots=4,
                       max_len=64,
                       cache=s.C.CacheConfig(paged=True, page_size=4),
                       execution=s.C.ExecConfig(fused=fused)), **s.kw)
    fe = s.F.OnlineFrontend(srv, s.F.VirtualClock(),
                            on_cycle=lambda v, now: v.pool.check_invariants())
    fe.submit_interactions(s.T.generate_tenant_interactions(
        s.T.make_apps(2), 5, rate_s=200.0, turns=2, new_tokens=8,
        output_tokens=5, seed=11), cfg.vocab_size, seed=11)
    fe.run()
    assert not fe.truncated
    done = [r for r in fe.requests if r.phase.name == "FINISHED"]
    assert len(done) == len(fe.requests)     # nothing cancelled this trace
    return {r.rid: list(srv.outputs[r.rid]) for r in done}


def test_interaction_replay_matches_jax(model):
    golden = _replay_mode(model, False, fused=False)
    assert golden and all(golden.values())
    assert _replay_mode(model, True, fused=False) == golden
    assert _replay_mode(model, True, fused=True) == golden


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_tenant_replay_on_cpu(capsys):
    """``launch/serve.py --mode replay --share-prefix --tenants 4 --credit``
    replays multi-turn sessions with reuse and reports each tenant; the
    JAX launcher's argument checks hold."""
    from repro_torch.launch import serve
    assert serve.main(["--mode", "replay", "--device", "cpu",
                       "--share-prefix", "--tenants", "4", "--credit",
                       "--requests", "6", "--rate-limit", "3"]) == 0
    out = capsys.readouterr().out
    assert "-> 6 sessions" in out and "KV pool clean: True" in out
    stats = dict(kv.split("=") for kv in next(
        ln for ln in out.splitlines() if ln.startswith("stats:")).split()[1:])
    assert int(stats["reused_prefill_tokens"]) > 0
    assert int(stats["prefix_hits"]) > 0
    assert sum(ln.strip().startswith("tenant app")
               for ln in out.splitlines()) >= 1
    for argv in (["--mode", "replay", "--credit"],
                 ["--mode", "host", "--tenants", "2"]):
        with pytest.raises(SystemExit):
            serve.main(argv + ["--device", "cpu"])
