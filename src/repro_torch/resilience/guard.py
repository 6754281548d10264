"""SLO watchdog + degradation state machine (docs/RESILIENCE.md).

An :class:`SLOGuard` is consulted by ``BulletServer.step`` every cycle:

1. **Deadlines** — a request whose TTFT or total latency exceeds its
   configured deadline is cancelled: its pool pages are freed through
   the same table-ownership edits preemption uses, its span is marked,
   and the cancellation is counted in the metrics registry.
2. **Admission backpressure** — ``BulletServer.submit`` raises
   :class:`AdmissionRejected` (retryable) when the pending queue is at
   ``max_queue``; the online frontend retries with backoff a bounded
   number of times, then sheds the request instead of queueing it
   unboundedly.
3. **Degradation lattice** — sustained prediction divergence, straggler
   cycles, repeated dispatch failures and exhausted handoff retries
   degrade the engine one rung at a time along fused→serial, chip→tile,
   paged→dense. Every rung keeps the token streams byte-identical (the
   degraded paths are the engine's proven numerics references; aborted
   in-flight work re-prefills from scratch deterministically).
4. **Probe-back** — after ``cooldown_cycles`` quiet cycles the most
   recent rung is restored (LIFO); a drained-idle engine restores all
   rungs immediately. Every transition is counted in the metrics
   registry (``bullet_guard_transitions_total``) and emitted as an
   instant event in the Chrome trace.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from repro_torch.launch.submesh import HandoffPolicy
from repro_torch.serving.request import Phase


class AdmissionRejected(RuntimeError):
    """Bounded-queue backpressure: the submit was *shed*, not failed —
    the caller may retry after ``retry_after_s``."""

    def __init__(self, msg: str, retry_after_s: float = 0.05):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclass(frozen=True)
class GuardConfig:
    """Operating envelope of the watchdog (all times in trace seconds,
    windows/cooldowns in engine cycles)."""

    #: per-request deadlines; None disables that check
    deadline_ttft_s: Optional[float] = None
    deadline_total_s: Optional[float] = None
    #: pending-queue bound for admission backpressure; None = unbounded
    max_queue: Optional[int] = None
    retry_after_s: float = 0.05
    max_submit_retries: int = 3
    #: sustained-divergence trigger: mean |pred/actual - 1| over the last
    #: ``divergence_window`` cycles above the threshold degrades a rung
    divergence_threshold: float = 0.5
    divergence_window: int = 24
    #: straggler trigger: a cycle whose actual exceeds
    #: ``straggler_factor`` x predicted is a straggler; ``straggler_trigger``
    #: of them inside ``straggler_window`` cycles degrades a rung
    straggler_factor: float = 3.0
    straggler_window: int = 16
    straggler_trigger: int = 4
    #: consecutive dispatch failures of one kind before degrading
    dispatch_trigger: int = 2
    #: quiet cycles before probing one rung back toward the fast path
    cooldown_cycles: int = 48
    #: transient-handoff retry policy installed into the engine
    handoff: HandoffPolicy = field(default_factory=HandoffPolicy)


class SLOGuard:
    """Watchdog consulted in ``BulletServer.step``. Attach once via
    ``BulletServer(guard=...)``; the engine calls :meth:`before_step`,
    :meth:`on_cycle_actual`, :meth:`on_dispatch_failure` and
    :meth:`on_handoff_exhausted`, and the frontend calls
    :meth:`on_idle` when the replay drains."""

    #: degradation rungs, in the order the lattice descends
    RUNGS = ("fused", "chip", "paged")

    def __init__(self, cfg: Optional[GuardConfig] = None):
        self.cfg = cfg if cfg is not None else GuardConfig()
        self.cycle = 0
        #: rungs currently applied, in application order (restore = LIFO)
        self.degraded: List[str] = []
        #: structured transition log the chaos benchmark gates on
        self.transitions: List[dict] = []
        self._consec: Dict[str, int] = {}
        self._rel: Deque[float] = deque(maxlen=self.cfg.divergence_window)
        self._straggler_cycles: Deque[int] = deque()
        self._pending_reason: Optional[str] = None
        self._last_event_cycle = 0
        self._native: Dict[str, object] = {}

    # -- attach ----------------------------------------------------------
    def attach(self, server) -> None:
        """Record the engine's native (fast-path) modes so probe-back
        knows what to restore, and install the handoff retry policy."""
        self._native = {"fused": server.fused,
                        "partition": server.partition,
                        "paged": server.paged}
        server.handoff_policy = self.cfg.handoff

    # -- admission backpressure (seam: OnlineFrontend.submit) ------------
    def check_admission(self, server) -> None:
        mq = self.cfg.max_queue
        if mq is not None and len(server.pending) >= mq:
            raise AdmissionRejected(
                f"pending queue at {len(server.pending)} >= "
                f"max_queue={mq}; retry after {self.cfg.retry_after_s}s",
                retry_after_s=self.cfg.retry_after_s)

    # -- per-cycle hook ---------------------------------------------------
    def before_step(self, server, now: float) -> None:
        self.cycle += 1
        self._enforce_deadlines(server, now)
        if self._pending_reason is not None:
            reason, self._pending_reason = self._pending_reason, None
            self._event()
            # divergence/stragglers indict the estimator-driven fused
            # split; serial charging is the conservative mode. Further
            # rungs are reserved for hard dispatch/handoff failures.
            if server.fused and "fused" not in self.degraded:
                self._degrade(server, "fused", now, reason)
                self._rel.clear()
        self._maybe_probe(server, now)

    def _enforce_deadlines(self, server, now: float) -> None:
        ttft, total = self.cfg.deadline_ttft_s, self.cfg.deadline_total_s
        if ttft is None and total is None:
            return
        live = list(server.pending)
        live += [r for r in server.slot_req if r is not None]
        for r in live:
            if r.phase in (Phase.FINISHED, Phase.CANCELLED):
                continue
            if r.cancel_reason is not None:      # already marked mid-prefill
                continue
            age = now - r.arrival
            if total is not None and age > total:
                server.cancel_request(r, now, why="total_deadline")
            elif (ttft is not None and r.first_token_time is None
                    and age > ttft):
                server.cancel_request(r, now, why="ttft_deadline")

    # -- fault signals ----------------------------------------------------
    def _event(self) -> None:
        """A fault signal arrived: postpone probe-back."""
        self._last_event_cycle = self.cycle

    def on_cycle_actual(self, server, kind: str, pred: float,
                        actual: float) -> None:
        """Fed from ``record_cycle_actual``: divergence and straggler
        detection over the completed cycle."""
        self._consec.clear()          # a dispatch completed successfully
        if pred <= 0 or actual <= 0:
            return
        rel = abs(pred / actual - 1.0)
        self._rel.append(rel)
        cfg = self.cfg
        if actual > cfg.straggler_factor * pred:
            self._straggler_cycles.append(self.cycle)
            self._event()
        while (self._straggler_cycles and self._straggler_cycles[0]
                <= self.cycle - cfg.straggler_window):
            self._straggler_cycles.popleft()
        if len(self._straggler_cycles) >= cfg.straggler_trigger:
            self._pending_reason = (
                f"{len(self._straggler_cycles)} straggler cycles within "
                f"{cfg.straggler_window} (actual > "
                f"{cfg.straggler_factor:g}x predicted)")
        elif len(self._rel) >= cfg.divergence_window:
            mean = sum(self._rel) / len(self._rel)
            if mean > cfg.divergence_threshold:
                self._pending_reason = (
                    f"sustained prediction divergence: mean |pred/actual-1|"
                    f" = {mean:.2f} over {len(self._rel)} cycles")
                self._event()

    def on_dispatch_failure(self, server, err, now: float) -> None:
        """A dispatch raised DispatchError: count it, and degrade the
        rung that routes around the failing path once failures persist."""
        kind = getattr(err, "kind", "any")
        self._event()
        server.stats.dispatch_failures += 1
        if server.obs.enabled:
            server.obs.guard_dispatch_failures.labels(kind=kind).inc()
        c = self._consec[kind] = self._consec.get(kind, 0) + 1
        if c < self.cfg.dispatch_trigger:
            return
        reason = f"{c} consecutive {kind} dispatch failures"
        if kind == "fused" and server.fused:
            self._degrade(server, "fused", now, reason)
        elif kind.startswith("chip_"):
            self._degrade(server, "chip", now, reason)
        elif kind in ("prefill", "decode") and server.paged:
            # the serial path itself is failing: the last rung swaps the
            # paged kernels for the dense fixed-slot reference
            self._degrade(server, "paged", now, reason)

    def on_handoff_exhausted(self, server, now: float) -> None:
        """Cross-mesh handoff failed past the retry budget (the engine
        already aborted the chip task): leave the chip rung."""
        self._event()
        self._degrade(server, "chip", now,
                      "handoff retries exhausted")

    # -- lattice transitions ----------------------------------------------
    def _degrade(self, server, rung: str, now: float, reason: str) -> None:
        if rung in self.degraded:
            return
        if rung == "fused":
            if not server.fused:
                return
            server.set_fused(False)
        elif rung == "chip":
            if server.ptask is not None and \
                    server.ptask.granularity == "chip":
                server._abort_prefill_task(server.ptask, now)
                server.ptask = None
            server.partition = "tile"
        elif rung == "paged":
            if not server.paged:
                return
            # the lower rungs depend on the paged pool: leave them first
            if server.fused:
                self._degrade(server, "fused", now, reason)
            if server._chip_enabled and server.partition != "tile":
                self._degrade(server, "chip", now, reason)
            server.set_cache_mode(False, now)
        self.degraded.append(rung)
        self._record_transition(server, f"degrade:{rung}", now, reason)
        server.stats.degrades += 1

    def _restore(self, server, now: float) -> None:
        rung = self.degraded.pop()
        if rung == "fused":
            if self._native.get("fused"):
                server.set_fused(True)
        elif rung == "chip":
            server.partition = self._native.get("partition", "tile")
        elif rung == "paged":
            server.set_cache_mode(True, now)
        self._record_transition(server, f"restore:{rung}", now, "cooldown")
        server.stats.restores += 1
        self._last_event_cycle = self.cycle
        self._consec.clear()

    def _record_transition(self, server, transition: str, now: float,
                           reason: str) -> None:
        self.transitions.append({"t": now, "cycle": self.cycle,
                                 "transition": transition,
                                 "reason": reason})
        obs = server.obs
        if obs.enabled:
            obs.guard_transitions.labels(transition=transition).inc()
            obs.guard_degraded.set(float(len(self.degraded)))
            obs.mark_instant(transition, now, reason=reason,
                             degraded=float(len(self.degraded)))

    def _maybe_probe(self, server, now: float) -> None:
        if (self.degraded and self.cycle - self._last_event_cycle
                >= self.cfg.cooldown_cycles):
            self._restore(server, now)

    def on_idle(self, server, now: float) -> None:
        """The replay drained with rungs still applied: probing back is
        free when nothing is in flight — restore everything."""
        while self.degraded:
            self._restore(server, now)

    # -- introspection -----------------------------------------------------
    @property
    def recovered(self) -> bool:
        """True when every degradation has been matched by a restore."""
        return not self.degraded
