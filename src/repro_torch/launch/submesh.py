"""Chip-granular sub-mesh partitions (paper §3.4, second granularity).

The port holds only :class:`HandoffPolicy` so far, which the SLO guard
installs into the engine (``resilience/guard.py``). The sub-mesh carving
itself, disjoint groups of CUDA devices with peer-to-peer KV handoff, comes
with the ROADMAP port item "chip granularity".
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HandoffPolicy:
    """Retry-with-backoff policy for *transient* cross-mesh KV handoff
    failures (docs/RESILIENCE.md): the engine re-attempts the
    ``transfer_pages`` re-shard up to ``max_retries`` times, charging an
    exponentially growing backoff to the cycle's measured duration, and
    only then aborts the prefill task and degrades chip→tile. Frozen so
    a guard config can carry one as a hashable default."""

    max_retries: int = 3
    backoff_s: float = 0.005

    def backoff(self, attempt: int) -> float:
        """Seconds to wait before retry ``attempt`` (1-based)."""
        return self.backoff_s * (2 ** max(attempt - 1, 0))
