"""Request lifecycle, SLO definitions, metric aggregation (paper §4.1)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence


class Phase(Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    #: terminal without completing: deadline cancel or admission shed
    #: (docs/RESILIENCE.md); never counted toward goodput's denominator
    CANCELLED = "cancelled"


@dataclass
class SLO:
    """Latency targets (paper Table 2): normalized TTFT (ms/input-token) and
    absolute TPOT (ms)."""
    norm_ttft_ms: float
    tpot_ms: float


# paper Table 2
WORKLOAD_SLOS: Dict[str, SLO] = {
    "sharegpt": SLO(norm_ttft_ms=3.0, tpot_ms=150.0),
    "azure-code": SLO(norm_ttft_ms=1.5, tpot_ms=200.0),
    "arxiv-summary": SLO(norm_ttft_ms=1.5, tpot_ms=175.0),
}


@dataclass
class Request:
    rid: int
    arrival: float                    # seconds
    prompt_len: int
    output_len: int
    phase: Phase = Phase.QUEUED

    # progress
    prefill_done_tokens: int = 0      # chunked-prefill progress
    prefill_done_layers: int = 0      # Bullet layer-level progress
    generated: int = 0

    # timestamps
    prefill_start: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    #: why the request was cancelled (``ttft_deadline`` / ``total_deadline``
    #: / ``shed`` / ``throttled`` / ...). Set before the terminal phase flip
    #: for requests cancelled mid-prefill: the engine defers their removal
    #: to the next layer-group boundary, and this mark is the tombstone it
    #: honors.
    cancel_reason: Optional[str] = None

    # -- tenant identity (docs/MULTITENANCY.md) ------------------------
    #: None on single-tenant traces; the tenancy layer maps None -> the
    #: anonymous app 0
    user_id: Optional[int] = None
    app_id: Optional[int] = None
    #: multi-turn session this request is a turn of (None = standalone)
    session_id: Optional[int] = None
    #: 0 = the interaction's opening turn (the only kind the tenant gate
    #: may throttle — the OIT rule); > 0 = mid-conversation follow-up
    turn_index: int = 0

    # -- metrics ------------------------------------------------------
    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    @property
    def norm_ttft_ms(self) -> Optional[float]:
        t = self.ttft
        return None if t is None else 1e3 * t / max(self.prompt_len, 1)

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean time per output token after the first (paper §2.1)."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        if self.generated <= 1:
            return 0.0
        return 1e3 * (self.finish_time - self.first_token_time) / (self.generated - 1)

    def meets_slo(self, slo: SLO) -> bool:
        nt, tp = self.norm_ttft_ms, self.tpot_ms
        return (nt is not None and tp is not None
                and nt <= slo.norm_ttft_ms and tp <= slo.tpot_ms)


def percentile(values: Sequence[float], q: float) -> float:
    vs = sorted(v for v in values if v is not None)
    if not vs:
        return float("nan")
    idx = min(len(vs) - 1, max(0, math.ceil(q / 100 * len(vs)) - 1))
    return vs[idx]


@dataclass
class ServingMetrics:
    """Aggregate per-run metrics (paper Fig. 11)."""
    n_requests: int
    duration_s: float
    mean_ttft_s: float
    p90_ttft_s: float
    mean_norm_ttft_ms: float
    mean_tpot_ms: float
    p90_tpot_ms: float
    throughput_tok_s: float          # output tokens / s
    goodput: float                   # fraction meeting both SLOs
    mean_queue_s: float
    #: requests that ended CANCELLED (deadline / shed) — reported beside
    #: the finished population, never inside its latency stats
    n_cancelled: int = 0

    @property
    def is_empty(self) -> bool:
        """True for the zero-finished sentinel (see :meth:`empty`)."""
        return self.n_requests == 0

    @staticmethod
    def empty() -> "ServingMetrics":
        """Explicit zero-finished sentinel: all fields zero (never NaN),
        ``is_empty`` true, and :meth:`row` reports the case legibly
        instead of printing NaN-stuffed columns."""
        return ServingMetrics(0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                              0.0)

    @staticmethod
    def from_requests(reqs: Sequence[Request], slo: SLO) -> "ServingMetrics":
        done = [r for r in reqs if r.phase == Phase.FINISHED]
        n_cancelled = sum(r.phase == Phase.CANCELLED for r in reqs)
        if not done:
            m = ServingMetrics.empty()
            m.n_cancelled = n_cancelled
            return m
        t0 = min(r.arrival for r in done)
        t1 = max(r.finish_time for r in done)
        out_tokens = sum(r.generated for r in done)
        ttfts = [r.ttft for r in done]
        tpots = [r.tpot_ms for r in done]
        queue = [max(0.0, (r.prefill_start or r.arrival) - r.arrival)
                 for r in done]
        return ServingMetrics(
            n_requests=len(done),
            duration_s=t1 - t0,
            mean_ttft_s=sum(ttfts) / len(done),
            p90_ttft_s=percentile(ttfts, 90),
            mean_norm_ttft_ms=sum(r.norm_ttft_ms for r in done) / len(done),
            mean_tpot_ms=sum(tpots) / len(done),
            p90_tpot_ms=percentile(tpots, 90),
            throughput_tok_s=out_tokens / max(t1 - t0, 1e-9),
            goodput=sum(r.meets_slo(slo) for r in done) / len(done),
            mean_queue_s=sum(queue) / len(done),
            n_cancelled=n_cancelled,
        )

    def row(self) -> str:
        if self.is_empty:
            return "n=0 (no requests finished; no latency stats)"
        extra = f" cancelled={self.n_cancelled}" if self.n_cancelled else ""
        return (f"n={self.n_requests} ttft={self.mean_ttft_s*1e3:.1f}ms "
                f"p90={self.p90_ttft_s*1e3:.1f}ms tpot={self.mean_tpot_ms:.1f}ms "
                f"p90tpot={self.p90_tpot_ms:.1f}ms thr={self.throughput_tok_s:.0f}tok/s "
                f"goodput={self.goodput*100:.1f}%{extra}")
