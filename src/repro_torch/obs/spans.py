"""Per-request lifecycle spans (docs/OBSERVABILITY.md).

One :class:`RequestSpan` records the ordered lifecycle marks of a request
as the engine emits them::

    submit -> admit -> prefill_group* -> [handoff] -> migrate
           -> first_token -> decode ... -> finish
    (preempt -> resume re-enters at admit; marks accumulate, so the span
     survives preemption and the breakdown stays attributable)

Marks carry the engine's trace-time timestamps (wall or virtual clock —
whatever drives ``BulletServer.step``), so TTFT/TPOT/queue breakdowns
derived here agree with ``ServingMetrics`` exactly.

Invariants (tested in tests/test_obs.py):
- timestamps are non-decreasing in mark order;
- exactly one ``submit`` and at most one ``finish`` per span;
- every ``preempt`` is matched by a later ``resume`` (or the request is
  still queued);
- ``first_token`` appears at most once — resumed requests re-prefill but
  do not re-emit their first token.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

#: marks that end a span's lifecycle (docs/RESILIENCE.md): normal
#: completion, deadline/operator cancel, admission shed, or the replay's
#: cycle budget running out with the request still in flight
TERMINAL_MARKS = ("finish", "cancel", "shed", "timed_out")


@dataclass
class SpanEvent:
    name: str
    t: float
    attrs: Dict[str, float] = field(default_factory=dict)


@dataclass
class RequestSpan:
    rid: int
    events: List[SpanEvent] = field(default_factory=list)

    def mark(self, name: str, t: float, **attrs) -> None:
        self.events.append(SpanEvent(name, t, attrs))

    # -- queries ---------------------------------------------------------
    def first(self, name: str) -> Optional[SpanEvent]:
        for e in self.events:
            if e.name == name:
                return e
        return None

    def count(self, name: str) -> int:
        return sum(1 for e in self.events if e.name == name)

    def names(self) -> List[str]:
        return [e.name for e in self.events]

    @property
    def start(self) -> Optional[float]:
        e = self.first("submit")
        return e.t if e is not None else None

    @property
    def end(self) -> Optional[float]:
        for e in self.events:
            if e.name in TERMINAL_MARKS:
                return e.t
        return None

    def breakdown(self) -> Dict[str, float]:
        """Lifecycle latency decomposition in seconds; preempted spans
        attribute each re-queue wait to ``queue_s`` (the sum over all
        admit waits), so the parts still add up across a preempt→resume
        round-trip."""
        submit = self.first("submit")
        first_tok = self.first("first_token")
        finish = self.first("finish")
        out: Dict[str, float] = {
            "preempts": float(self.count("preempt")),
            "resumes": float(self.count("resume")),
            "aborts": float(self.count("abort")),
            "prefill_groups": float(self.count("prefill_group")),
        }
        if submit is None:
            return out
        # each admit/resume wait measured from the preceding queue entry
        # (a preempted decode slot or an aborted prefill batch both
        # requeue the request)
        queue = 0.0
        q_start: Optional[float] = submit.t
        for e in self.events:
            if e.name in ("admit", "resume") and q_start is not None:
                queue += max(0.0, e.t - q_start)
                q_start = None
            elif e.name in ("preempt", "abort"):
                q_start = e.t
        out["queue_s"] = queue
        if first_tok is not None:
            out["ttft_s"] = first_tok.t - submit.t
        if finish is not None and first_tok is not None:
            out["decode_s"] = finish.t - first_tok.t
            toks = finish.attrs.get("generated", 0.0)
            if toks > 1:
                out["tpot_s"] = (finish.t - first_tok.t) / (toks - 1)
        return out


class SpanTracker:
    """Owns the per-request spans: a live dict keyed by rid plus a
    bounded deque of finished spans (long-running servers must not grow
    without bound — ``capacity`` finished spans are retained)."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.enabled = enabled
        self.live: Dict[int, RequestSpan] = {}
        self.finished: Deque[RequestSpan] = deque(maxlen=capacity)

    def mark(self, rid: int, name: str, t: float, **attrs) -> None:
        if not self.enabled:
            return
        span = self.live.get(rid)
        if span is None:
            span = RequestSpan(rid)
            self.live[rid] = span
        span.mark(name, t, **attrs)
        if name in TERMINAL_MARKS:
            self.finished.append(self.live.pop(rid))

    def get(self, rid: int) -> Optional[RequestSpan]:
        span = self.live.get(rid)
        if span is not None:
            return span
        for s in self.finished:
            if s.rid == rid:
                return s
        return None

    def all(self) -> List[RequestSpan]:
        return list(self.finished) + list(self.live.values())

    def check_invariants(self) -> None:
        """Span phase-ordering audit (run by the engine's
        ``check_invariants`` under fault injection): timestamps are
        non-decreasing in mark order, lifecycle-unique marks appear at
        most once, and exactly one terminal mark ends a span — live spans
        have none (terminal marks pop to the finished deque)."""
        for span in self.all():
            ts = [e.t for e in span.events]
            assert all(a <= b for a, b in zip(ts, ts[1:])), (
                f"span {span.rid}: timestamps regress: "
                f"{list(zip(span.names(), ts))}")
            assert span.count("submit") <= 1, \
                f"span {span.rid}: multiple submits"
            assert span.count("first_token") <= 1, \
                f"span {span.rid}: multiple first_tokens"
            terminal = sum(span.count(n) for n in TERMINAL_MARKS)
            assert terminal <= 1, \
                f"span {span.rid}: {terminal} terminal marks"
            if span.rid in self.live:
                assert terminal == 0, (
                    f"span {span.rid} live but terminally marked: "
                    f"{span.names()}")

    # -- Chrome trace-event export --------------------------------------
    def chrome_events(self, pid: int = 1) -> List[dict]:
        """Async begin/end pairs (``ph`` b/e, matched by cat+id+name)
        plus instant events for every lifecycle mark — Perfetto renders
        one track per request id."""
        evs: List[dict] = []
        for span in self.all():
            start, end = span.start, span.end
            if start is None:
                continue
            ident = str(span.rid)
            evs.append({"name": "request", "cat": "request", "ph": "b",
                        "id": ident, "ts": start * 1e6, "pid": pid,
                        "tid": 2})
            for e in span.events:
                evs.append({
                    "name": e.name, "cat": "request", "ph": "n",
                    "id": ident, "ts": e.t * 1e6, "pid": pid, "tid": 2,
                    "args": {"rid": span.rid, **e.attrs}})
            if end is not None:
                evs.append({"name": "request", "cat": "request",
                            "ph": "e", "id": ident, "ts": end * 1e6,
                            "pid": pid, "tid": 2,
                            "args": dict(span.breakdown())})
        return evs
