"""Human-readable end-of-run report derived from the metrics snapshot.

``launch/serve.py``'s host and replay modes used to hand-print
``server.stats`` and pred/actual error lines separately; both now route
through :func:`run_report`, which syncs the engine's counters into the
registry and formats ONE view off the resulting snapshot — the printed
report and an exported ``--metrics-out`` file can never disagree.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.serving.request import ServingMetrics


def _engine_counters(snap: dict) -> str:
    prefix = "bullet_engine_"
    parts = [f"{k[len(prefix):-len('_total')]}={int(v)}"
             for k, v in snap.items()
             if k.startswith(prefix) and k.endswith("_total")]
    return " ".join(parts)


def run_report(server, metrics: Optional[ServingMetrics] = None,
               header: str = "") -> str:
    """Format the end-of-run summary for ``server`` from its metrics
    snapshot (works for host batches and online replays alike)."""
    obs = server.obs
    obs.sync_engine_stats(server)
    snap = obs.registry.snapshot()
    lines: List[str] = []
    if header:
        lines.append(header)
    if metrics is not None:
        lines.append(metrics.row())
    lines.append(f"stats: {_engine_counters(snap)}")
    n_obs = snap.get("bullet_estimator_observed_cycles", 0)
    if n_obs:
        lines.append(
            f"estimator: {int(n_obs)} cycles observed, "
            f"mean |pred/actual-1| = "
            f"{snap.get('bullet_estimator_mean_rel_error', 0.0):.3f}, "
            f"refits applied = {int(snap.get('bullet_engine_refits_total', 0))}")
    timed_out = snap.get("bullet_requests_timed_out_total", 0)
    if timed_out:
        lines.append(
            f"WARNING: {int(timed_out)} request(s) still in flight when "
            "the cycle budget ran out — raise max_cycles or shrink the "
            "trace; their latency stats are not in the row above")
    degrades = snap.get("bullet_engine_degrades_total", 0)
    if degrades:
        lines.append(
            f"guard: {int(degrades)} degradation(s), "
            f"{int(snap.get('bullet_engine_restores_total', 0))} "
            f"restore(s), "
            f"{int(snap.get('bullet_engine_cancelled_total', 0))} "
            f"cancelled, {int(snap.get('bullet_engine_shed_total', 0))} "
            "shed")
    # available_blocks counts ref-0 cached pages kept by shared-prefix
    # reuse as reclaimable (they are evicted on demand), so a drained
    # server reports clean with sharing on or off
    clean = server.pool.available_blocks == server.pool.n_blocks
    lines.append(f"KV pool clean: {clean}")
    return "\n".join(lines)
