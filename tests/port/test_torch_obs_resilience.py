"""The port's copies of ``obs/`` and ``resilience/`` held equal to the JAX
package's on seeded operation sequences: metrics snapshots and renders,
request-span order, the Chrome trace, fault firing counts and perturbed
durations, and the SLO guard's transition log and the engine calls it
makes."""

import json

import numpy as np
import pytest

from repro import obs as JO
from repro import resilience as JR
from repro.kvcache.paged import PagedKVPool as JPool
from repro.serving.request import Phase as JPhase
from repro.serving.request import Request as JRequest
from repro_torch import obs as TO
from repro_torch import resilience as TR
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.serving.request import Phase, Request

SPAN_NAMES = ("submit", "admit", "prefill_group", "migrate", "first_token",
              "preempt", "resume", "finish", "cancel")


def _drive_obs(O, seed):
    rng = np.random.default_rng(seed)
    obs = O.Observability()
    for step in range(300):
        op = rng.integers(0, 7)
        t = step * 1e-3
        if op == 0:
            obs.requests_submitted.inc()
            obs.spans.mark(int(rng.integers(0, 12)), "submit", t,
                           prompt_len=int(rng.integers(1, 99)))
        elif op == 1:
            obs.spans.mark(int(rng.integers(0, 12)),
                           str(rng.choice(SPAN_NAMES)), t,
                           rep=float(rng.integers(0, 4)))
        elif op == 2:
            ev = O.CycleEvent(
                t=t, kind=str(rng.choice(["serial", "fused"])),
                predicted_s=float(rng.random() * 1e-2),
                prefill_units=int(rng.integers(0, 132)),
                kv_used_blocks=int(rng.integers(0, 64)), kv_total_blocks=64,
                kv_occupancy=float(rng.random()), reason="slack")
            obs.record_cycle(ev)
            obs.complete_cycle(ev, float(rng.random() * 2e-2))
        elif op == 3:
            obs.requests_cancelled.labels(
                why=str(rng.choice(["ttft_deadline", "shed"]))).inc()
        elif op == 4:
            obs.guard_transitions.labels(
                transition=str(rng.choice(["degrade:fused",
                                           "restore:paged"]))).inc()
            obs.mark_instant("degrade:fused", t, reason="test")
        elif op == 5:
            obs.registry.gauge("bullet_test_gauge", "a gauge").set(
                float(rng.random()))
        else:
            obs.cycle_pred_rel_error.observe(float(rng.random()))
    return obs


@pytest.mark.parametrize("seed", [0, 1])
def test_obs_copy_matches_jax(seed):
    j, t = _drive_obs(JO, seed), _drive_obs(TO, seed)
    assert t.registry.snapshot() == j.registry.snapshot()
    assert t.render_metrics() == j.render_metrics()
    assert [(s.rid, [(e.name, e.t, e.attrs) for e in s.events])
            for s in t.spans.all()] == \
        [(s.rid, [(e.name, e.t, e.attrs) for e in s.events])
         for s in j.spans.all()]
    assert json.dumps(t.chrome_trace(), sort_keys=True) == \
        json.dumps(j.chrome_trace(), sort_keys=True)
    assert TO.NULL_OBS.enabled is False


class _PoolServer:
    """What FaultInjector.begin_cycle / end_of_run touch: the pool."""

    def __init__(self, pool):
        self.pool = pool


PLAN = dict(seed=9, specs=[
    dict(kind="straggler", start=3, end=40, factor=4.0, p=0.4),
    dict(kind="drift", start=10, end=30, factor=1.7),
    dict(kind="dispatch", start=2, end=50, target="decode", count=3, p=0.5),
    dict(kind="dispatch", start=5, end=20, target="any", count=2),
    dict(kind="handoff", start=0, end=60, count=4, p=0.5),
    dict(kind="handoff", start=0, end=60, count=2, delay_s=0.003),
    dict(kind="pool_squeeze", start=6, end=25, blocks=5),
])


def _drive_faults(R, pool_cls):
    inj = R.FaultInjector(R.FaultPlan.from_json(PLAN))
    server = _PoolServer(pool_cls(640, block_size=16))
    server.pool.allocate(0, 100)
    log = []
    for cycle in range(60):
        inj.begin_cycle(server)
        if cycle == 12:
            server.pool.free(0)
        for kind in R.faults.DISPATCH_KINDS:
            try:
                inj.dispatch(kind)
            except R.DispatchError as e:
                log.append((cycle, "dispatch", e.kind, str(e)))
        try:
            inj.handoff_hook()(3)
        except R.HandoffError as e:
            log.append((cycle, "handoff", str(e)))
        log.append((cycle, inj.perturb_cycle(1e-3),
                    sorted(inj.phantom_rids()), server.pool.free_blocks))
    inj.end_of_run(server)
    return log, dict(inj.injected), server.pool.free_blocks


def test_faults_copy_matches_jax():
    j = _drive_faults(JR, JPool)
    t = _drive_faults(TR, PagedKVPool)
    assert t == j
    assert t[1]["dispatch"] > 0 and t[1]["pool_squeeze"] == 1
    assert TR.FaultPlan.from_json(PLAN).to_json() == \
        JR.FaultPlan.from_json(PLAN).to_json()
    assert TR.NULL_FAULTS.enabled is False


class _Stats:
    def __init__(self):
        self.degrades = self.restores = self.dispatch_failures = 0


class _GuardServer:
    """The engine surface SLOGuard drives, recording every call."""

    def __init__(self, req_cls, phase, obs):
        self.fused, self.paged = True, True
        self.partition, self._chip_enabled = "tile", False
        self.pending, self.slot_req = [], [None] * 4
        self.ptask = None
        self.stats, self.obs = _Stats(), obs
        self.calls = []
        self.req_cls, self.phase = req_cls, phase

    def set_fused(self, flag):
        self.calls.append(("set_fused", flag))
        self.fused = flag

    def set_cache_mode(self, paged, now):
        self.calls.append(("set_cache_mode", paged, now))
        self.paged = paged

    def cancel_request(self, r, now, why):
        self.calls.append(("cancel", r.rid, now, why))
        r.phase = self.phase.CANCELLED
        if r in self.pending:
            self.pending.remove(r)


def _drive_guard(R, O, req_cls, phase, seed):
    rng = np.random.default_rng(seed)
    guard = R.SLOGuard(R.GuardConfig(
        deadline_ttft_s=0.05, deadline_total_s=0.2, max_queue=3,
        cooldown_cycles=6, straggler_window=8, straggler_trigger=3,
        divergence_window=6))
    server = _GuardServer(req_cls, phase, O.Observability())
    guard.attach(server)
    rid = 0
    log = []
    burst = []          # dispatch failures still to come, one per cycle
    for cycle in range(200):
        now = cycle * 2e-3
        if rng.random() < 0.3:
            try:
                guard.check_admission(server)
                r = req_cls(rid=rid, arrival=now, prompt_len=8, output_len=4)
                r.phase = phase.QUEUED
                server.pending.append(r)
                rid += 1
            except R.AdmissionRejected as e:
                log.append(("rejected", cycle, e.retry_after_s))
        if server.pending and rng.random() < 0.2:
            server.pending.pop(0)
        guard.before_step(server, now)
        if not burst and rng.random() < 0.1:
            burst = [str(rng.choice(["fused", "decode", "prefill"]))] * \
                int(rng.integers(1, 4))
        if burst:
            guard.on_dispatch_failure(
                server, R.DispatchError("x", burst.pop()), now)
        else:
            pred = float(rng.random() * 1e-3 + 1e-4)
            actual = pred * float(rng.choice([1.0, 1.2, 2.0, 5.0]))
            guard.on_cycle_actual(server, "serial", pred, actual)
    guard.on_idle(server, 1.0)
    return (guard.transitions, server.calls, log, guard.recovered,
            vars(server.stats), server.obs.render_metrics())


@pytest.mark.parametrize("seed", [0, 2])
def test_guard_copy_matches_jax(seed):
    j = _drive_guard(JR, JO, JRequest, JPhase, seed)
    t = _drive_guard(TR, TO, Request, Phase, seed)
    assert t == j
    kinds = {x["transition"] for x in t[0]}
    assert {"degrade:fused", "degrade:paged", "restore:paged"} <= kinds
    assert any(c[0] == "cancel" for c in t[1])
    assert t[3]
