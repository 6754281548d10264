"""Per-cycle structured event trace + Chrome trace-event export.

Every engine cycle that did device work appends one :class:`CycleEvent`
recording *what ran and what the performance model thought it would
cost*: the cycle kind (serial / fused / chip), the partition descriptor
the resource manager executed, predicted vs. actual duration, handoff
bytes, KV-pool occupancy/fragmentation, the pause gate, and the
scheduler's decision rationale.

The export (:meth:`CycleTrace.chrome_trace`) is Chrome trace-event JSON
(the ``traceEvents`` array format) viewable in Perfetto / chrome://
tracing: cycles as complete (``ph: "X"``) slices on the engine thread,
KV occupancy as counter (``ph: "C"``) samples, and request spans as
async tracks (see spans.py). docs/OBSERVABILITY.md documents the schema.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import asdict, dataclass
from typing import Deque, List, Optional


@dataclass
class CycleEvent:
    """One engine cycle's structured record (trace-time seconds)."""
    t: float                              # cycle start (clock time)
    kind: str                             # serial | fused | chip
    predicted_s: float
    actual_s: Optional[float] = None      # filled by record_cycle_actual
    # partition descriptor the resource manager executed
    config_id: int = 0
    granularity: str = "tile"
    prefill_units: int = 0
    decode_units: int = 0
    prefill_chips: int = 0
    decode_chips: int = 0
    # work executed
    prefill_tokens: int = 0
    decode_batch: int = 0
    handoff_tokens: int = 0
    handoff_bytes: int = 0
    # KV pool state after the cycle
    kv_used_blocks: int = 0
    kv_total_blocks: int = 0
    kv_occupancy: float = 0.0
    kv_fragmentation: float = 0.0
    # scheduler outcome driving the cycle
    paused: bool = False
    reason: str = ""

    @property
    def duration_s(self) -> float:
        """Best available duration: the measured actual when a caller
        recorded one, else the model's prediction."""
        return self.actual_s if self.actual_s is not None \
            else self.predicted_s


class CycleTrace:
    """Bounded in-memory cycle log (a long-running server appending one
    event per cycle must not leak; ``capacity`` newest are retained)."""

    def __init__(self, capacity: int = 1 << 16, enabled: bool = True):
        self.enabled = enabled
        self.events: Deque[CycleEvent] = deque(maxlen=capacity)
        self.dropped = 0

    def append(self, ev: CycleEvent) -> None:
        if not self.enabled:
            return
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    # -- export ----------------------------------------------------------
    def chrome_events(self, pid: int = 1) -> List[dict]:
        evs: List[dict] = []
        for ev in self.events:
            args = asdict(ev)
            args["predicted_ms"] = ev.predicted_s * 1e3
            args["actual_ms"] = (ev.actual_s * 1e3
                                 if ev.actual_s is not None else None)
            evs.append({
                "name": f"cycle:{ev.kind}", "cat": "cycle", "ph": "X",
                "ts": ev.t * 1e6, "dur": max(ev.duration_s, 0.0) * 1e6,
                "pid": pid, "tid": 1, "args": args})
            evs.append({
                "name": "kv_occupancy", "cat": "kv", "ph": "C",
                "ts": ev.t * 1e6, "pid": pid, "tid": 1,
                "args": {"used_blocks": ev.kv_used_blocks,
                         "free_blocks": (ev.kv_total_blocks
                                         - ev.kv_used_blocks)}})
        return evs

    def chrome_trace(self, extra_events: Optional[List[dict]] = None,
                     pid: int = 1) -> dict:
        """The full trace document: metadata + cycles (+ caller-supplied
        events, e.g. request spans), sorted by timestamp."""
        evs = [
            {"name": "process_name", "ph": "M", "ts": 0.0, "pid": pid,
             "tid": 0, "args": {"name": "bullet-server"}},
            {"name": "thread_name", "ph": "M", "ts": 0.0, "pid": pid,
             "tid": 1, "args": {"name": "engine cycles"}},
            {"name": "thread_name", "ph": "M", "ts": 0.0, "pid": pid,
             "tid": 2, "args": {"name": "requests"}},
        ]
        evs.extend(self.chrome_events(pid))
        if extra_events:
            evs.extend(extra_events)
        evs.sort(key=lambda e: (e["ts"], e["tid"]))
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"dropped_cycles": self.dropped}}

    def to_json(self, extra_events: Optional[List[dict]] = None) -> str:
        return json.dumps(self.chrome_trace(extra_events), indent=None)
