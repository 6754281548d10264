"""Event-driven multi-replica cluster simulation (docs/SIMULATOR.md): the
port's copy of the JAX package's ``sim/cluster.py``, logic unchanged.

N simulated Bullet instances
(:class:`repro_torch.core.simulate.BulletReplicaSim`, one H100 each on the
port's ``HardwareSpec`` — each with its own partition table, live
``SLOScheduler``, and independent ``OnlineRefitter`` state against its own
noisy ``SurrogateMachine``) behind a cluster router, in one event heap.
Three event kinds:

- ``arrival`` — a request (an interaction turn) reaches the router, which
  picks a replica by the configured policy and enqueues it there; an idle
  replica starts a cycle immediately.
- ``cycle`` — a replica's in-flight engine cycle ends; finished requests
  release their KV, closed-loop follow-up turns are scheduled at
  ``finish + think_time``, and the replica starts its next cycle if it has
  work.
- ``down`` / ``up`` — replica outage windows from a ``FaultPlan``
  (cluster semantics below): a down replica drains its queued and
  in-flight work back through the router (progress lost, prefix cache
  cold) and takes no traffic until its ``up`` event.

Routing policies (``ROUTERS``): ``round-robin`` (cyclic over alive
replicas), ``least-kv`` (minimum live+queued KV token pressure),
``prefix-affinity`` (sessions stick to the replica holding their prefix
KV, exploiting the radix-index reuse; falls back to least-kv on first
contact or failover), ``tenant-aware`` (each app has a home replica by
``app_id`` hash, shielded by a 2x pressure escape hatch to least-kv).

FaultPlan cluster semantics: replica outages reuse the engine's
:class:`repro_torch.resilience.faults.FaultSpec` vocabulary — a spec with
``kind="dispatch"`` is read as "replica ``blocks`` is down for
``[start, end)`` simulated *seconds*" (the engine reads start/end as cycle
indices; the cluster's only clock is trace time). Other kinds are ignored
at cluster level — they describe intra-replica faults.

Determinism: every run is a pure function of (config, trace, seeds). The
heap breaks time ties by insertion sequence, each replica's surrogate
noise stream is seeded from ``(seed, replica_id)``, and no wall clock or
global RNG is consulted — the replay-identity property the port's
``tests/port/test_torch_cluster.py`` gates on.
"""

from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.estimator import PerfEstimator
from repro_torch.core.profiler import SurrogateMachine
from repro_torch.core.simulate import BulletReplicaSim, SimConfig
from repro_torch.resilience.faults import FaultPlan
from repro_torch.serving.request import Phase, Request, ServingMetrics
from repro_torch.serving.workload import Interaction


# ---------------------------------------------------------------------------
# Routing policies
# ---------------------------------------------------------------------------

class Router:
    """Pure routing policy: ``pick`` maps a request onto an alive replica
    index. Policies see the replicas (for load signals) but never mutate
    them."""
    name = "base"

    def __init__(self, n: int):
        self.n = n

    def pick(self, req: Request, replicas: List[BulletReplicaSim],
             alive: List[int]) -> int:
        raise NotImplementedError

    def on_replica_down(self, rid: int) -> None:
        """Hook: a replica left the alive set (affinity maps unpin)."""

    @staticmethod
    def _least_kv(replicas, alive: List[int]) -> int:
        return min(alive, key=lambda i: (replicas[i].kv_pressure(), i))


class RoundRobinRouter(Router):
    name = "round-robin"

    def __init__(self, n: int):
        super().__init__(n)
        self._next = 0

    def pick(self, req, replicas, alive):
        for _ in range(self.n):
            i = self._next % self.n
            self._next += 1
            if i in alive:
                return i
        return alive[0]


class LeastKVRouter(Router):
    name = "least-kv"

    def pick(self, req, replicas, alive):
        return self._least_kv(replicas, alive)


class PrefixAffinityRouter(Router):
    """Sessions stick to the replica that holds their prefix KV: turn k+1
    lands where turn k finished, so the radix-index reuse collapses its
    prefill to the unshared suffix (docs/KV_SHARING.md). First contact and
    failover fall back to least-kv; a failed replica's pins dissolve (its
    cache is cold anyway)."""
    name = "prefix-affinity"

    def __init__(self, n: int):
        super().__init__(n)
        self.pins: Dict[int, int] = {}

    def pick(self, req, replicas, alive):
        sid = req.session_id
        if sid is not None:
            pin = self.pins.get(sid)
            if pin is not None and pin in alive:
                return pin
        i = self._least_kv(replicas, alive)
        if sid is not None:
            self.pins[sid] = i
        return i

    def on_replica_down(self, rid: int) -> None:
        for sid in [s for s, p in self.pins.items() if p == rid]:
            del self.pins[sid]


class TenantAwareRouter(Router):
    """Each app hashes to a home replica, so one flooding tenant's queue
    builds up on its own replica instead of inflating everyone's TTFT —
    cluster-level blast-radius isolation on top of the per-replica credit
    scheduler. The 2x pressure escape hatch spills to least-kv when the
    home replica is disproportionately loaded."""
    name = "tenant-aware"

    def pick(self, req, replicas, alive):
        home = alive[(req.app_id or 0) % len(alive)]
        floor = min(replicas[i].kv_pressure() for i in alive)
        if replicas[home].kv_pressure() > 2 * floor + 4096:
            return self._least_kv(replicas, alive)
        return home


ROUTERS = {r.name: r for r in (RoundRobinRouter, LeastKVRouter,
                               PrefixAffinityRouter, TenantAwareRouter)}


def make_router(name: str, n: int) -> Router:
    if name not in ROUTERS:
        raise ValueError(f"unknown router {name!r}; "
                         f"want one of {sorted(ROUTERS)}")
    return ROUTERS[name](n)


# ---------------------------------------------------------------------------
# Cluster simulation
# ---------------------------------------------------------------------------

@dataclass
class ClusterConfig:
    """One fleet: N identical replicas + a routing policy."""
    sim: SimConfig
    n_replicas: int = 4
    router: str = "round-robin"
    system: str = "bullet"
    #: replica-outage plan (cluster FaultSpec semantics, module docstring)
    faults: Optional[FaultPlan] = None
    #: surrogate noise seed; replica i draws from seed*1009 + i
    seed: int = 0
    #: hard simulated-time cutoff (seconds)
    max_time: float = math.inf


@dataclass
class ClusterResult:
    metrics: ServingMetrics
    requests: List[Request]
    n_replicas: int
    router: str
    #: per-replica (cycles, refits_applied, reused_prefill_tokens)
    replica_stats: List[Tuple[int, int, int]]
    rerouted: int = 0
    cancelled_no_replica: int = 0

    @property
    def total_cycles(self) -> int:
        return sum(c for c, _, _ in self.replica_stats)


class ClusterSimulator:
    """Deterministic event-heap loop over N BulletReplicaSim instances.

    ``run`` accepts either a flat open-loop trace (``List[Request]``) or
    closed-loop multi-turn ``Interaction`` sessions; with interactions,
    turn k+1's request is materialized when turn k finishes (its prompt is
    the accumulated history plus fresh tokens, the shared-prefix workload)
    and arrives after the turn's think time.
    """

    def __init__(self, cc: ClusterConfig, est: PerfEstimator):
        self.cc = cc
        self.replicas = [
            BulletReplicaSim(cc.sim, est,
                             SurrogateMachine(cc.sim.hw,
                                              seed=cc.seed * 1009 + i),
                             cc.system, replica_id=i)
            for i in range(cc.n_replicas)]
        self.router = make_router(cc.router, cc.n_replicas)
        self.down = [False] * cc.n_replicas
        self.busy: List[Optional[float]] = [None] * cc.n_replicas
        self.requests: List[Request] = []
        self.rerouted = 0
        self.cancelled_no_replica = 0
        self._heap: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self._rid = itertools.count()
        #: session_id -> (interaction, next turn index, history tokens)
        self._sessions: Dict[int, Tuple[Interaction, int, int]] = {}
        self._down_ends: List[float] = []

    # -- event plumbing -------------------------------------------------
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def _alive(self) -> List[int]:
        return [i for i in range(self.cc.n_replicas) if not self.down[i]]

    # -- request materialization ----------------------------------------
    def _schedule_interaction(self, it: Interaction) -> None:
        self._sessions[it.session_id] = (it, 0, 0)
        self._push(it.arrival, "arrival",
                   self._make_turn(it, 0, 0, it.arrival))

    def _make_turn(self, it: Interaction, k: int, history: int,
                   arrival: float) -> Request:
        turn = it.turns[k]
        req = Request(rid=next(self._rid), arrival=arrival,
                      prompt_len=history + turn.new_tokens,
                      output_len=max(1, turn.output_tokens),
                      user_id=it.user_id, app_id=it.app_id,
                      session_id=it.session_id, turn_index=k)
        self.requests.append(req)
        return req

    def _on_finished(self, req: Request, t: float) -> None:
        sess = self._sessions.get(req.session_id) \
            if req.session_id is not None else None
        if sess is None:
            return
        it, k, _hist = sess
        if req.turn_index != k or k + 1 >= len(it.turns):
            if req.turn_index == k:
                self._sessions.pop(req.session_id, None)
            return
        history = req.prompt_len + req.generated
        self._sessions[req.session_id] = (it, k + 1, history)
        nxt = self._make_turn(it, k + 1, history,
                              t + it.turns[k].think_time_s)
        self._push(nxt.arrival, "arrival", nxt)

    # -- replica drive ---------------------------------------------------
    def _start_cycle(self, i: int, t: float) -> None:
        rep = self.replicas[i]
        t2, finished = rep.run_cycle(t)
        if t2 <= t and not finished:
            self.busy[i] = None
            return
        self.busy[i] = t2
        for r in finished:
            self._on_finished(r, t2)
        self._push(t2, "cycle", i)

    def _route(self, req: Request, t: float) -> None:
        alive = self._alive()
        if not alive:
            nxt = min((e for e in self._down_ends if e > t), default=None)
            if nxt is None:
                req.phase = Phase.CANCELLED
                req.cancel_reason = "no_replica"
                self.cancelled_no_replica += 1
                return
            self._push(nxt, "arrival", req)
            return
        i = self.router.pick(req, self.replicas, alive)
        self.replicas[i].submit(req, t)
        if self.busy[i] is None:
            self._start_cycle(i, t)

    def _take_down(self, i: int, t: float) -> None:
        self.down[i] = True
        self.router.on_replica_down(i)
        for req in self.replicas[i].drain():
            self.rerouted += 1
            self._route(req, t)
        self.busy[i] = None      # any in-flight cycle event goes stale

    # -- main loop -------------------------------------------------------
    def run(self, work: Sequence) -> ClusterResult:
        """Replay ``work`` (Interactions or flat Requests) to completion.
        Returns aggregate metrics over every materialized request."""
        for w in work:
            if isinstance(w, Interaction):
                self._schedule_interaction(w)
            else:
                self.requests.append(w)
                self._push(w.arrival, "arrival", w)
        for spec in (self.cc.faults.specs if self.cc.faults else ()):
            if spec.kind != "dispatch":
                continue             # intra-replica kinds: not cluster-level
            i = int(spec.blocks)
            if not (0 <= i < self.cc.n_replicas):
                continue
            self._push(float(spec.start), "down", i)
            self._push(float(min(spec.end, 1 << 30)), "up", i)
            self._down_ends.append(float(min(spec.end, 1 << 30)))

        t = 0.0
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            if t > self.cc.max_time:
                break
            if kind == "arrival":
                self._route(payload, t)
            elif kind == "cycle":
                i = payload
                # stale if the replica went down (busy reset) or a newer
                # cycle superseded this one
                if self.down[i] or self.busy[i] != t:
                    continue
                self.busy[i] = None
                if self.replicas[i].has_work:
                    self._start_cycle(i, t)
            elif kind == "down":
                self._take_down(payload, t)
            elif kind == "up":
                self.down[payload] = False
                if self.replicas[payload].has_work \
                        and self.busy[payload] is None:
                    self._start_cycle(payload, t)

        for r in self.requests:      # max_time cutoff: close started work
            if r.phase not in (Phase.FINISHED, Phase.CANCELLED) \
                    and r.first_token_time is not None:
                r.finish_time = max(t, r.first_token_time)
                r.phase = Phase.FINISHED
        return ClusterResult(
            metrics=ServingMetrics.from_requests(self.requests,
                                                 self.cc.sim.slo),
            requests=self.requests,
            n_replicas=self.cc.n_replicas,
            router=self.cc.router,
            replica_stats=[(r.cycles, r.refits_applied,
                            r.reused_prefill_tokens)
                           for r in self.replicas],
            rerouted=self.rerouted,
            cancelled_no_replica=self.cancelled_no_replica)
