"""Metrics registry: counters, gauges, histograms with labels.

Zero-dependency Prometheus-flavored instrumentation substrate for the
serving stack (docs/OBSERVABILITY.md). Design constraints:

- **Near-zero overhead when disabled**: a disabled registry hands out one
  shared no-op instrument, so instrumented hot paths pay a single
  attribute call per signal and allocate nothing.
- **Handles, not lookups**: callers resolve an instrument once (at init)
  and hold it; the per-event path is a plain float add on ``__slots__``
  objects.
- **Text exposition**: :meth:`MetricsRegistry.render` emits the
  Prometheus text format (``# HELP`` / ``# TYPE`` / sample lines,
  histograms as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``)
  so a snapshot file is scrapable and diffable.

The registry is process-local and single-threaded by construction (the
engine's host loop), matching the MetadataBuffer's threading model — no
locks on the hot path.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence, Tuple

#: default histogram buckets (seconds-oriented, like Prometheus defaults)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _NullInstrument:
    """Shared no-op instrument handed out by a disabled registry: every
    mutator is a constant-time pass, and ``labels`` returns itself so
    labeled call sites need no disabled-branch of their own."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def labels(self, **kv) -> "_NullInstrument":
        return self


NULL_INSTRUMENT = _NullInstrument()


class Counter:
    """Monotonically increasing count. ``value`` may also be assigned
    directly by snapshot-sync code (absorbing an external dataclass
    counter such as ``EngineStats``) — the exposition layer does not
    distinguish the two."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (occupancy, queue depth, last error)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram with Prometheus ``histogram_quantile``
    style percentile estimation (linear interpolation inside the bucket
    the target rank falls in; the +Inf bucket clamps to the largest
    finite bound, matching promql semantics)."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bounds = sorted(float(b) for b in buckets)
        assert bounds and all(b > 0 or True for b in bounds)
        assert all(a < b for a, b in zip(bounds, bounds[1:])), (
            "histogram buckets must be strictly increasing")
        self.bounds: Tuple[float, ...] = tuple(bounds)
        #: per-bucket (non-cumulative) counts; trailing slot is +Inf
        self.counts: List[int] = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile (q in [0, 1]) from the buckets."""
        assert 0.0 <= q <= 1.0
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        cum = self.cumulative()
        for i, c in enumerate(cum):
            if c >= rank:
                if i >= len(self.bounds):       # +Inf bucket: clamp
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                prev = cum[i - 1] if i > 0 else 0
                in_bucket = c - prev
                if in_bucket <= 0:
                    return hi
                return lo + (hi - lo) * (rank - prev) / in_bucket
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric and its labeled children. ``labels(**kv)``
    resolves (and memoizes) the child for a label-value combination;
    unlabeled metrics have a single child under the empty key."""

    __slots__ = ("name", "kind", "help", "label_names", "children",
                 "_buckets")

    def __init__(self, name: str, kind: str, help: str = "",
                 label_names: Tuple[str, ...] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        assert kind in _KINDS, kind
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self.children: Dict[Tuple[str, ...], object] = {}
        self._buckets = tuple(buckets)

    def labels(self, **kv):
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self.children.get(key)
        if child is None:
            child = (Histogram(self._buckets) if self.kind == "histogram"
                     else _KINDS[self.kind]())
            self.children[key] = child
        return child

    def _label_str(self, key: Tuple[str, ...]) -> str:
        if not key:
            return ""
        pairs = ",".join(f'{n}="{v}"'
                         for n, v in zip(self.label_names, key))
        return "{" + pairs + "}"


def _fmt(v: float) -> str:
    if v != v:                       # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Named metric families, created on first use and rendered in
    creation order. ``enabled=False`` turns every factory into a return
    of the shared no-op instrument."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.families: Dict[str, Family] = {}

    # -- instrument factories -------------------------------------------
    def _family(self, name: str, kind: str, help: str,
                labels: Tuple[str, ...],
                buckets: Sequence[float] = DEFAULT_BUCKETS):
        fam = self.families.get(name)
        if fam is None:
            fam = Family(name, kind, help, labels, buckets)
            self.families[name] = fam
        assert fam.kind == kind, (
            f"metric {name} re-registered as {kind}, was {fam.kind}")
        assert fam.label_names == tuple(labels), (
            f"metric {name} re-registered with labels {labels}, "
            f"was {fam.label_names}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()):
        """Unlabeled: returns the Counter. Labeled: returns the Family
        (call ``.labels(...)`` per combination)."""
        if not self.enabled:
            return NULL_INSTRUMENT
        fam = self._family(name, "counter", help, tuple(labels))
        return fam if labels else fam.labels()

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()):
        if not self.enabled:
            return NULL_INSTRUMENT
        fam = self._family(name, "gauge", help, tuple(labels))
        return fam if labels else fam.labels()

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not self.enabled:
            return NULL_INSTRUMENT
        fam = self._family(name, "histogram", help, tuple(labels), buckets)
        return fam if labels else fam.labels()

    # -- read side -------------------------------------------------------
    def value(self, name: str, **labels) -> Optional[float]:
        """Current value of a counter/gauge child (None if absent)."""
        fam = self.families.get(name)
        if fam is None:
            return None
        key = tuple(str(labels[n]) for n in fam.label_names)
        child = fam.children.get(key)
        if child is None:
            return None
        return child.value            # type: ignore[union-attr]

    def snapshot(self) -> Dict[str, float]:
        """Flat ``name{labels}`` → value map (histograms contribute
        ``_sum`` and ``_count``); the test-facing reconciliation view."""
        out: Dict[str, float] = {}
        for fam in self.families.values():
            for key, child in fam.children.items():
                label = fam._label_str(key)
                if fam.kind == "histogram":
                    out[f"{fam.name}_sum{label}"] = child.sum
                    out[f"{fam.name}_count{label}"] = child.count
                else:
                    out[f"{fam.name}{label}"] = child.value
        return out

    def render(self) -> str:
        """Prometheus text exposition of every family."""
        lines: List[str] = []
        for fam in self.families.values():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.children.items()):
                label = fam._label_str(key)
                if fam.kind == "histogram":
                    cum = child.cumulative()
                    for bound, c in zip(
                            list(child.bounds) + [math.inf], cum):
                        le = f'le="{_fmt(bound)}"'
                        lab = (label[:-1] + "," + le + "}" if label
                               else "{" + le + "}")
                        lines.append(f"{fam.name}_bucket{lab} {c}")
                    lines.append(
                        f"{fam.name}_sum{label} {_fmt(child.sum)}")
                    lines.append(
                        f"{fam.name}_count{label} {child.count}")
                else:
                    lines.append(
                        f"{fam.name}{label} {_fmt(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")
