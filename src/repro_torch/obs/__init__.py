"""Unified observability layer for the serving stack (the port's copy of
the JAX package's ``src/repro/obs``, pure Python, imports rewritten).

Three pillars (docs/OBSERVABILITY.md):

- :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters / gauges /
  histograms with labels, Prometheus text exposition, near-zero overhead
  when disabled;
- :class:`~repro_torch.obs.spans.SpanTracker` — per-request lifecycle spans
  (submit → admit → prefill groups → handoff → decode → finish, surviving
  preempt → resume round-trips);
- :class:`~repro_torch.obs.trace.CycleTrace` — per-cycle structured events
  (kind, partition descriptor, predicted vs. actual duration, handoff
  bytes, KV occupancy, pause gate, scheduler rationale) exportable as
  Chrome trace-event JSON for Perfetto.

One :class:`Observability` object owns all three and is threaded through
``BulletServer`` (engine), ``SLOScheduler`` (decision rationale),
``PagedKVPool`` statistics, and ``OnlineFrontend``. The module-level
:data:`NULL_OBS` singleton is the disabled default: every hook degrades
to an attribute check or a no-op call, keeping the uninstrumented hot
path unchanged.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import fields as dataclass_fields
from typing import Optional

from repro_torch.obs.metrics import (DEFAULT_BUCKETS, MetricsRegistry,
                                     NULL_INSTRUMENT)
from repro_torch.obs.spans import RequestSpan, SpanTracker
from repro_torch.obs.trace import CycleEvent, CycleTrace

__all__ = [
    "Observability", "NULL_OBS", "CycleEvent", "CycleTrace",
    "MetricsRegistry", "RequestSpan", "SpanTracker", "DEFAULT_BUCKETS",
    "NULL_INSTRUMENT",
]

#: histogram buckets for engine cycle durations (seconds): cycles on a
#: reduced CPU model sit around 1-100 ms, real-device cycles lower
CYCLE_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5)

#: buckets for relative prediction error |pred/actual - 1|
ERROR_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6)


class Observability:
    """Owner of the three pillars plus the pre-resolved instrument
    handles the hot paths mutate. Construct once per server; pass to
    ``BulletServer(obs=...)``."""

    def __init__(self, enabled: bool = True, *,
                 trace_capacity: int = 1 << 16,
                 span_capacity: int = 4096):
        self.enabled = enabled
        self.registry = MetricsRegistry(enabled=enabled)
        self.spans = SpanTracker(capacity=span_capacity, enabled=enabled)
        self.trace = CycleTrace(capacity=trace_capacity, enabled=enabled)
        r = self.registry
        # engine cycle signals
        self.cycle_seconds = r.histogram(
            "bullet_cycle_seconds",
            "measured engine cycle duration by cycle kind",
            labels=("kind",), buckets=CYCLE_BUCKETS)
        self.cycle_predicted_seconds = r.histogram(
            "bullet_cycle_predicted_seconds",
            "estimator-predicted engine cycle duration by cycle kind",
            labels=("kind",), buckets=CYCLE_BUCKETS)
        self.cycle_pred_rel_error = r.histogram(
            "bullet_cycle_pred_rel_error",
            "per-cycle |predicted/actual - 1| of the performance model",
            buckets=ERROR_BUCKETS)
        # KV pool signals
        self.kv_occupancy = r.gauge(
            "bullet_kv_occupancy",
            "fraction of pool blocks currently allocated")
        self.kv_fragmentation = r.gauge(
            "bullet_kv_fragmentation",
            "unwritten fraction of allocated block capacity "
            "(internal fragmentation)")
        self.kv_free_blocks = r.gauge(
            "bullet_kv_free_blocks", "pool blocks currently free")
        # shared-prefix reuse signals (docs/KV_SHARING.md)
        self.prefix_hits = r.counter(
            "bullet_prefix_hits_total",
            "admitted requests that mapped shared-prefix pages")
        self.prefix_reused_tokens = r.counter(
            "bullet_prefix_reused_tokens_total",
            "prompt tokens served from shared pages instead of prefill")
        # scheduler signals
        self.sched_decisions = r.counter(
            "bullet_scheduler_decisions_total",
            "scheduling decisions by Algorithm 1 rationale",
            labels=("reason",))
        self.sched_pause_gate = r.counter(
            "bullet_scheduler_pause_gate_total",
            "cycles the §3.3.3 pause gate fired (decode paused to "
            "borrow the machine for prefill)")
        self.sched_ttft_violation = r.counter(
            "bullet_scheduler_ttft_violations_total",
            "scheduling cycles with a projected TTFT SLO violation")
        self.sched_tpot_violation = r.counter(
            "bullet_scheduler_tpot_violations_total",
            "scheduling cycles with an observed TPOT SLO violation")
        # request lifecycle counters (spans carry the detail)
        self.requests_submitted = r.counter(
            "bullet_requests_submitted_total", "requests entering the "
            "pending queue (re-queues after preemption excluded)")
        self.requests_finished = r.counter(
            "bullet_requests_finished_total", "requests fully generated")
        # resilience signals (docs/RESILIENCE.md)
        self.requests_cancelled = r.counter(
            "bullet_requests_cancelled_total",
            "requests cancelled before completing, by cause",
            labels=("why",))
        self.requests_shed = r.counter(
            "bullet_requests_shed_total",
            "requests shed by admission backpressure after retries")
        self.requests_timed_out = r.counter(
            "bullet_requests_timed_out_total",
            "requests still in flight when the replay's cycle budget ran "
            "out")
        self.guard_transitions = r.counter(
            "bullet_guard_transitions_total",
            "SLO-guard degradation lattice transitions "
            "(degrade:<rung> / restore:<rung>)", labels=("transition",))
        self.guard_dispatch_failures = r.counter(
            "bullet_guard_dispatch_failures_total",
            "executable dispatch failures absorbed by the guard, by "
            "dispatch kind", labels=("kind",))
        self.guard_degraded = r.gauge(
            "bullet_guard_degraded_rungs",
            "degradation rungs currently applied (0 = native fast path)")
        #: Chrome-trace instant events (guard transitions etc.), bounded
        self.events = deque(maxlen=4096)

    # -- scheduler hook --------------------------------------------------
    def on_decision(self, decision, ttft_vio: bool = False,
                    tpot_vio: bool = False) -> None:
        """Called by SLOScheduler.schedule once per scheduling cycle."""
        self.sched_decisions.labels(
            reason=decision.reason or "unknown").inc()
        if decision.pause_decode:
            self.sched_pause_gate.inc()
        if ttft_vio:
            self.sched_ttft_violation.inc()
        if tpot_vio:
            self.sched_tpot_violation.inc()

    # -- engine hooks ----------------------------------------------------
    def record_cycle(self, ev: CycleEvent) -> None:
        """Append one executed cycle and refresh the KV gauges."""
        self.trace.append(ev)
        self.cycle_predicted_seconds.labels(kind=ev.kind).observe(
            ev.predicted_s)
        self.kv_occupancy.set(ev.kv_occupancy)
        self.kv_fragmentation.set(ev.kv_fragmentation)
        self.kv_free_blocks.set(ev.kv_total_blocks - ev.kv_used_blocks)

    def complete_cycle(self, ev: CycleEvent, actual_s: float) -> None:
        """Attach the measured duration a caller recorded for ``ev``."""
        ev.actual_s = actual_s
        self.cycle_seconds.labels(kind=ev.kind).observe(actual_s)
        if actual_s > 0:
            self.cycle_pred_rel_error.observe(
                abs(ev.predicted_s / actual_s - 1.0))

    def sync_engine_stats(self, server) -> None:
        """Absorb the engine's always-on ``EngineStats`` counters (and
        the KV pool's op counters) into the registry, so an exported
        snapshot reconciles with the engine's own bookkeeping by
        construction. Call before :meth:`render_metrics`."""
        if not self.enabled:
            return
        for f in dataclass_fields(server.stats):
            c = self.registry.counter(
                f"bullet_engine_{f.name}_total",
                f"engine counter EngineStats.{f.name}")
            c.value = float(getattr(server.stats, f.name))
        pool = server.pool
        for name, v in (("alloc", pool.ops.allocs),
                        ("extend", pool.ops.extends),
                        ("free", pool.ops.frees),
                        ("preempt", pool.ops.preempts),
                        ("shared_hit", pool.ops.shared_hits),
                        ("reused_tokens", pool.ops.reused_tokens),
                        ("cow_copy", pool.ops.cow_copies),
                        ("eviction", pool.ops.evictions),
                        ("register", pool.ops.registers)):
            self.registry.counter(
                "bullet_kv_pool_ops_total", "page-pool table operations",
                labels=("op",)).labels(op=name).value = float(v)
        self.kv_occupancy.set(pool.occupancy())
        self.kv_fragmentation.set(pool.fragmentation())
        self.kv_free_blocks.set(pool.free_blocks)
        if server.pred_actual:
            rel = [abs(p / a - 1.0)
                   for _, p, a in server.pred_actual if a > 0]
            g = self.registry.gauge(
                "bullet_estimator_mean_rel_error",
                "mean |pred/actual - 1| over the pred_actual window")
            if rel:
                g.set(sum(rel) / len(rel))
            self.registry.gauge(
                "bullet_estimator_observed_cycles",
                "cycles with a recorded actual in the pred_actual "
                "window").set(len(server.pred_actual))

    def mark_instant(self, name: str, t: float, **args) -> None:
        """Record a global instant event (``ph: "i"``) on the trace —
        guard lattice transitions use this so degradations are visible
        next to the cycles they interrupt."""
        if not self.enabled:
            return
        self.events.append({"name": name, "cat": "guard", "ph": "i",
                            "s": "g", "ts": t * 1e6, "pid": 1, "tid": 0,
                            "args": dict(args)})

    # -- export ----------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The combined Chrome trace-event document: engine cycles, KV
        counters, request-span tracks, and guard instant events."""
        return self.trace.chrome_trace(
            extra_events=self.spans.chrome_events() + list(self.events))

    def render_metrics(self) -> str:
        return self.registry.render()

    def write_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def write_metrics(self, path: str,
                      server: Optional[object] = None) -> None:
        if server is not None:
            self.sync_engine_stats(server)
        with open(path, "w") as f:
            f.write(self.render_metrics())


#: the disabled default: every registry factory returns the shared no-op
#: instrument and span/trace appends return immediately
NULL_OBS = Observability(enabled=False)
