"""Online serving frontend: arrival-clocked admission over the real engine
(the port's copy of the JAX package's ``serving/frontend.py``, imports
rewritten).

Bridges the sim/real gap: the same ``generate_trace`` workloads the
discrete-event simulator consumes (core/simulate.py) replay against the
real ``BulletServer`` (core/engine.py), with requests released into the
engine's pending queue by arrival timestamp against a pluggable clock:

- ``WallClock(speed)`` — real time, optionally compressed (``--time-scale``
  in launch/serve.py): trace seconds elapse ``speed``× faster than wall
  seconds, and all engine timestamps stay in trace coordinates.
- ``VirtualClock`` — deterministic replay: time advances a fixed (or
  estimator-predicted, see :func:`estimator_cycle_cost`) amount per engine
  cycle and jumps across idle gaps, so two runs of the same trace produce
  byte-identical outputs and metrics regardless of host speed.

Tokens stream back through per-request callbacks the moment the engine
emits them (first token at prefill→decode migration, then one per decode
iteration), and a run aggregates into the same ``ServingMetrics`` the
simulator reports — ``--mode replay`` and ``--mode sim`` rows are directly
comparable on the same trace.
"""

from __future__ import annotations

import bisect
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import BulletServer
from repro_torch.core.estimator import predict_cycle
from repro_torch.core.profiler import SurrogateMachine
from repro_torch.resilience.guard import AdmissionRejected
from repro_torch.serving.request import Phase, Request, ServingMetrics


class WallClock:
    """Monotonic trace-time clock; ``speed`` > 1 compresses replay."""

    def __init__(self, speed: float = 1.0):
        assert speed > 0
        self.speed = speed
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return (time.perf_counter() - self._t0) * self.speed

    def sleep_until(self, t: float) -> None:
        dt = (t - self.now()) / self.speed
        if dt > 0:
            time.sleep(min(dt, 1.0))


class VirtualClock:
    """Deterministic replay clock: advances only when told to."""

    def __init__(self, cycle_dt: float = 1e-3):
        assert cycle_dt > 0
        self.cycle_dt = cycle_dt
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def advance(self, dt: Optional[float] = None) -> None:
        self._t += self.cycle_dt if dt is None else max(dt, 0.0)

    def sleep_until(self, t: float) -> None:
        self._t = max(self._t, t)


def estimator_cycle_cost(server: BulletServer) -> float:
    """Predicted duration of the engine cycle that just ran.

    Reads the engine's ``last_cycle_observation()`` record of what step()
    actually executed and prices it through the shared
    :func:`repro.core.estimator.predict_cycle` rule: a **fused** cycle
    costs the paper's Eq. 2 co-located ``max(prefill, decode)/(1-s)``
    with p_c/p_b contention, a **serial** cycle the SUM of its
    full-machine dispatches, with the decode charge on the KV bytes the
    iteration actually streamed (see docs/PERF_MODEL.md). Because the
    price is read off ``server.est`` *at call time*, replay charges stay
    refit-consistent: the cycle after an OnlineRefitter swap is already
    priced with the refit params."""
    obs = server.last_cycle_observation()
    if obs is None:
        return 1e-4
    dt = predict_cycle(server.est, server.cfg, obs)
    return dt if dt > 0 else 1e-4


def oracle_cycle_cost(truth: SurrogateMachine
                      ) -> Callable[[BulletServer], float]:
    """Cycle-cost callable that charges the *surrogate machine's* noisy
    ground-truth duration for the cycle that just ran, instead of the
    engine's own estimate. Virtual-clock replay then advances on "real"
    time while the engine schedules with its (possibly stale) fitted
    params — the drift regime the OnlineRefitter exists to close; the
    frontend feeds each charged duration back to the engine as the
    cycle's measured actual."""
    def cost(server: BulletServer) -> float:
        obs = server.last_cycle_observation()
        if obs is None:
            return 1e-4
        dt = truth.measure_cycle(server.cfg, obs)
        return dt if dt > 0 else 1e-4
    return cost


class OnlineFrontend:
    """Owns the request queue in front of a BulletServer: releases requests
    into the engine by arrival time, drives engine cycles, dispatches
    streaming callbacks, and aggregates ServingMetrics."""

    def __init__(self, server: BulletServer, clock=None, *,
                 cycle_cost: Optional[Callable[[BulletServer], float]] = None,
                 on_token: Optional[Callable[[Request, int, float], None]] = None,
                 on_cycle: Optional[Callable[[BulletServer, float], None]] = None):
        self.server = server
        self.clock = clock if clock is not None else WallClock()
        self.cycle_cost = cycle_cost
        self.on_token = on_token
        #: called as on_cycle(server, now) after every engine step — the
        #: chaos replay runs the engine invariant checker here
        self.on_cycle = on_cycle
        self.requests: List[Request] = []
        self.admitted_order: List[int] = []
        #: set by run(): True when max_cycles elapsed with work remaining,
        #: i.e. the metrics cover only the completed subset
        self.truncated = False
        #: rids shed by admission backpressure / still in flight when the
        #: cycle budget ran out (filled by run())
        self.shed: List[int] = []
        #: subset of ``shed`` rejected by the tenant gate (rate limit /
        #: KV pressure — always opening turns, never mid-interaction;
        #: docs/MULTITENANCY.md)
        self.throttled: List[int] = []
        self.timed_out: List[int] = []
        self._queue: List[Tuple[Request, np.ndarray]] = []
        #: backpressured submits awaiting retry: (release_at, tries, ...)
        self._deferred: List[Tuple[float, int, Request, np.ndarray]] = []
        self._i = 0
        self._cbs: Dict[int, Callable[[Request, int, float], None]] = {}
        self._chained_hook = server.on_token     # preserve a caller-set hook
        server.on_token = self._dispatch

    # -- ingress --------------------------------------------------------
    def submit(self, req: Request, prompt_tokens: np.ndarray,
               on_token: Optional[Callable[[Request, int, float], None]] = None
               ) -> None:
        """Enqueue a request for release at ``req.arrival`` (trace time)."""
        self.requests.append(req)
        self._queue.append((req, np.asarray(prompt_tokens, np.int32)))
        if on_token is not None:
            self._cbs[req.rid] = on_token

    def submit_trace(self, trace: List[Request], vocab_size: int,
                     seed: int = 0) -> None:
        """Attach synthetic prompt tokens to a generate_trace workload."""
        rng = np.random.default_rng(seed)
        for r in trace:
            self.submit(r, rng.integers(0, vocab_size, r.prompt_len,
                                        dtype=np.int32))

    def submit_interactions(self, sessions: Sequence, vocab_size: int,
                            seed: int = 0) -> None:
        """Closed-loop multi-turn replay of ``workload.Interaction``
        sessions. Turn ``k+1``'s prompt is turn ``k``'s full prompt plus
        its *actual* generated tokens plus fresh user tokens, so
        consecutive turns of a session share a growing prefix — the
        shared-prefix reuse workload (docs/KV_SHARING.md). Follow-up
        turns are scheduled from the finishing turn's token callback and
        inserted into the release queue in arrival order, so they work
        under both clocks and never require a second run() pass.

        Deterministic: each session draws from ``default_rng((seed,
        session_id))``, and follow-up content depends only on the
        engine's (deterministic) outputs."""
        rid_counter = itertools.count(
            max((r.rid for r in self.requests), default=-1) + 1)
        for sess in sessions:
            rng = np.random.default_rng((seed, sess.session_id))
            self._launch_turn(sess.session_id, rng, tuple(sess.turns),
                              np.zeros(0, np.int32), sess.arrival,
                              vocab_size, rid_counter,
                              ident=(getattr(sess, "user_id", None),
                                     getattr(sess, "app_id", None)),
                              turn_index=0)

    def _launch_turn(self, sid: int, rng, turns, history: np.ndarray,
                     arrival: float, vocab_size: int, rid_counter,
                     ident=(None, None), turn_index: int = 0) -> None:
        max_len = self.server.max_len
        turn, rest = turns[0], turns[1:]
        fresh = rng.integers(0, vocab_size, turn.new_tokens, dtype=np.int32)
        toks = np.concatenate([history, fresh]).astype(np.int32)
        if len(toks) + 2 > max_len:
            return                      # history outgrew the context window
        out_len = max(1, min(turn.output_tokens, max_len - len(toks)))
        req = Request(rid=next(rid_counter), arrival=arrival,
                      prompt_len=len(toks), output_len=out_len,
                      user_id=ident[0], app_id=ident[1],
                      session_id=sid, turn_index=turn_index)
        outputs: List[int] = []

        def on_tok(r: Request, token: int, now: float) -> None:
            outputs.append(int(token))
            done = (r.generated >= r.output_len
                    or r.prompt_len + r.generated >= max_len)
            if done and rest:
                nxt = np.concatenate(
                    [toks, np.asarray(outputs, np.int32)])
                self._launch_turn(sid, rng, rest, nxt,
                                  now + rest[0].think_time_s,
                                  vocab_size, rid_counter,
                                  ident=ident, turn_index=turn_index + 1)

        self.requests.append(req)
        # keep the release queue sorted past the release pointer; run()
        # re-sorts everything submitted before it starts anyway
        bisect.insort(self._queue, (req, toks), lo=self._i,
                      key=lambda e: (e[0].arrival, e[0].rid))
        self._cbs[req.rid] = on_tok

    def _dispatch(self, req: Request, token: int, now: float) -> None:
        cb = self._cbs.get(req.rid)
        if cb is not None:
            cb(req, token, now)
        if self.on_token is not None:
            self.on_token(req, token, now)
        if self._chained_hook is not None:
            self._chained_hook(req, token, now)

    # -- admission (guard backpressure) ---------------------------------
    def _release(self, now: float) -> None:
        """Move arrived (and retry-due deferred) requests into the engine,
        honoring the guard's bounded-queue admission backpressure: a
        rejected submit retries after the guard's ``retry_after_s`` up to
        ``max_submit_retries`` times, then sheds."""
        due, still = [], []
        for entry in self._deferred:
            (due if entry[0] <= now else still).append(entry)
        self._deferred = still
        for _, tries, req, toks in due:
            self._try_submit(req, toks, tries, now)
        while (self._i < len(self._queue)
               and self._queue[self._i][0].arrival <= now):
            req, toks = self._queue[self._i]
            self._i += 1
            self._try_submit(req, toks, 0, now)

    def _try_submit(self, req: Request, toks: np.ndarray, tries: int,
                    now: float) -> None:
        ten = self.server.tenancy
        if ten is not None and ten.enabled:
            verdict = ten.gate(req, now, tries)
            if verdict == "throttle":
                # the OIT rule guarantees this is an opening turn: the
                # whole interaction dies before any KV was invested
                self._shed(req, now, tries, reason="throttled")
                return
            if verdict == "defer":
                self._deferred.append(
                    (now + ten.cfg.defer_s, tries + 1, req, toks))
                return
        guard = self.server.guard
        if guard is not None:
            try:
                guard.check_admission(self.server)
            except AdmissionRejected as e:
                if tries < guard.cfg.max_submit_retries:
                    self._deferred.append(
                        (now + e.retry_after_s, tries + 1, req, toks))
                else:
                    self._shed(req, now, tries)
                return
        self.server.submit(req, toks)
        self.admitted_order.append(req.rid)

    def _shed(self, req: Request, now: float, tries: int,
              reason: str = "shed") -> None:
        """Retryable-rejection budget exhausted (or the tenant gate said
        no): the request never enters the engine — terminal CANCELLED
        with ``reason`` as the cause."""
        req.phase = Phase.CANCELLED
        req.cancel_reason = reason
        req.finish_time = now
        self.server.stats.shed += 1
        self.shed.append(req.rid)
        if reason == "throttled":
            self.throttled.append(req.rid)
        obs = self.server.obs
        if obs.enabled:
            obs.requests_shed.inc()
            obs.spans.mark(req.rid, reason, now, retries=float(tries))

    def _next_release(self) -> Optional[float]:
        ts = [t for t, *_ in self._deferred]
        if self._i < len(self._queue):
            ts.append(self._queue[self._i][0].arrival)
        return min(ts) if ts else None

    # -- replay loop ----------------------------------------------------
    def run(self, max_cycles: int = 200_000) -> ServingMetrics:
        """Replay the submitted trace to completion (or ``max_cycles``)."""
        self._queue.sort(key=lambda e: (e[0].arrival, e[0].rid))
        self._i = 0
        cycles = 0
        while cycles < max_cycles:
            cycles += 1
            now = self.clock.now()
            self._release(now)
            did = self.server.step(now)
            if isinstance(self.clock, VirtualClock):
                dt = (self.cycle_cost(self.server)
                      if self.cycle_cost else None)
                if dt is not None and self.server.faults.enabled:
                    # injected stragglers / drift stretch the measured
                    # duration; retry backoff and handoff delays land here
                    dt = self.server.faults.perturb_cycle(dt)
                self.clock.advance(dt)
                if dt is not None:
                    # the replay's advance IS the cycle's elapsed trace
                    # time: feed it back as the measured actual (§3.2.2
                    # feedback). Self-charged replays observe pred==actual
                    # and the refitter holds still; an oracle_cycle_cost
                    # replay observes real drift and the refit loop closes.
                    self.server.record_cycle_actual(dt)
            if self.on_cycle is not None:
                self.on_cycle(self.server, self.clock.now())
            if not did and self.server.idle:
                nxt = self._next_release()
                if nxt is not None:             # idle gap: next release
                    self.clock.sleep_until(nxt)
                    continue
                break
        now = self.clock.now()
        self.truncated = bool(self._i < len(self._queue) or self._deferred
                              or not self.server.idle)
        obs = self.server.obs
        if self.truncated:
            # the cycle budget ran out with work in flight: surface it per
            # request instead of silently dropping their stats (released
            # but unfinished requests are marked timed_out; queue entries
            # never released just stay QUEUED)
            admitted = set(self.admitted_order)
            for r in self.requests:
                if (r.rid in admitted
                        and r.phase not in (Phase.FINISHED,
                                            Phase.CANCELLED)):
                    self.timed_out.append(r.rid)
                    if obs.enabled:
                        obs.requests_timed_out.inc()
                        obs.spans.mark(r.rid, "timed_out", now,
                                       phase=float(r.generated))
        elif self.server.guard is not None:
            # drained clean: probing back to the fast path is free now
            self.server.guard.on_idle(self.server, now)
        if self.server.faults.enabled:
            self.server.faults.end_of_run(self.server)
        self.server.pool.check_invariants()
        m = self.metrics()
        obs = self.server.obs
        if obs.enabled:
            # end-of-run rollup: absorb the engine's counters into the
            # registry and publish the aggregate serving metrics, so an
            # exported snapshot carries the whole run
            obs.sync_engine_stats(self.server)
            r = obs.registry
            r.gauge("bullet_replay_truncated",
                    "1 if the replay hit max_cycles with work left"
                    ).set(float(self.truncated))
            r.gauge("bullet_run_goodput",
                    "fraction of finished requests meeting both SLOs"
                    ).set(0.0 if m.is_empty else m.goodput)
            r.gauge("bullet_run_throughput_tok_s",
                    "output tokens per second over the run"
                    ).set(0.0 if m.is_empty else m.throughput_tok_s)
            r.gauge("bullet_run_finished_requests",
                    "requests that finished during the run"
                    ).set(m.n_requests)
        return m

    def metrics(self) -> ServingMetrics:
        return ServingMetrics.from_requests(self.requests, self.server.slo)
