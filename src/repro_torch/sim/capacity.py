"""Capacity planning over the cluster simulator (docs/SIMULATOR.md): the
port's copy of the JAX package's ``sim/capacity.py``.

Answers the provisioning question a production deployment asks: *how many
replicas does this traffic need at this SLO?* — by replaying one fixed
multi-tenant trace through fleets of increasing size and binary-searching
the smallest N whose tail latencies hold the SLO.

"Holds" means p99 of both tails is inside the target: p99 normalized TTFT
<= ``slo.norm_ttft_ms`` and p99 TPOT <= ``slo.tpot_ms``, over every
finished request (cancelled requests count as misses — a fleet that sheds
traffic has not met capacity). SLO attainment (the fraction of requests
meeting both SLOs individually) is reported per point as the
replicas-vs-attainment curve; attainment is monotone non-decreasing in N
up to simulation noise.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from repro_torch.serving.request import Phase, Request, SLO, percentile


def slo_holds(requests: Sequence[Request], slo: SLO, *,
              quantile: float = 99.0) -> bool:
    """p99 tail check over a replay's request population."""
    pt = tail_point(requests, slo, quantile=quantile)
    return bool(pt["holds"])


def tail_point(requests: Sequence[Request], slo: SLO, *,
               quantile: float = 99.0) -> Dict:
    """One capacity-curve point: tails, attainment, and the hold verdict."""
    done = [r for r in requests if r.phase == Phase.FINISHED]
    n_cancelled = sum(r.phase == Phase.CANCELLED for r in requests)
    if not done:
        return {"n": 0, "n_cancelled": n_cancelled, "attainment": 0.0,
                "p99_norm_ttft_ms": float("inf"),
                "p99_tpot_ms": float("inf"), "holds": False}
    p99_ttft = percentile([r.norm_ttft_ms for r in done], quantile)
    p99_tpot = percentile([r.tpot_ms for r in done], quantile)
    met = sum(r.meets_slo(slo) for r in done)
    return {
        "n": len(done),
        "n_cancelled": n_cancelled,
        "attainment": met / max(len(done) + n_cancelled, 1),
        "p99_norm_ttft_ms": p99_ttft,
        "p99_tpot_ms": p99_tpot,
        "holds": (n_cancelled == 0 and p99_ttft <= slo.norm_ttft_ms
                  and p99_tpot <= slo.tpot_ms),
    }


def attainment_curve(run_at: Callable[[int], Sequence[Request]],
                     ns: Sequence[int], slo: SLO, *,
                     quantile: float = 99.0) -> List[Dict]:
    """Evaluate the replicas-vs-attainment curve at fleet sizes ``ns``.
    ``run_at(n)`` must replay the SAME trace (fresh Request objects) on an
    n-replica cluster and return its requests."""
    out = []
    for n in ns:
        pt = tail_point(run_at(n), slo, quantile=quantile)
        pt["replicas"] = n
        out.append(pt)
    return out


def capacity_search(run_at: Callable[[int], Sequence[Request]], slo: SLO, *,
                    n_lo: int = 1, n_hi: int = 16,
                    quantile: float = 99.0) -> Dict:
    """Binary-search the minimum replica count whose p99 tails hold the
    SLO. ``run_at(n)`` replays the fixed trace on an n-replica fleet.

    Assumes capacity is monotone in N (more replicas never hurt the
    tail); every evaluated point is returned so the caller can verify the
    monotonicity assumption held on this trace (the bench gates on it).
    Returns ``min_replicas = None`` when even ``n_hi`` cannot hold the
    SLO — the trace needs a bigger fleet ceiling, not a silent answer.
    """
    points: Dict[int, Dict] = {}

    def holds(n: int) -> bool:
        if n not in points:
            pt = tail_point(run_at(n), slo, quantile=quantile)
            pt["replicas"] = n
            points[n] = pt
        return points[n]["holds"]

    lo, hi = n_lo, n_hi
    answer = None
    if holds(hi):
        answer = hi
        if lo < hi and holds(lo):
            answer = lo
        else:
            a, b = lo, hi            # invariant: !holds(a), holds(b)
            while b - a > 1:
                mid = (a + b) // 2
                if holds(mid):
                    b = mid
                else:
                    a = mid
            answer = b
    return {
        "min_replicas": answer,
        "quantile": quantile,
        "slo": {"norm_ttft_ms": slo.norm_ttft_ms, "tpot_ms": slo.tpot_ms},
        "points": [points[n] for n in sorted(points)],
    }
