"""Chip-granular sub-mesh partitions (paper §3.4, second granularity).

The resource manager's table holds execution states at two granularities:
tile-granular splits share every card spatially (one fused launcher per
quantized ``decode_share``, ``core/engine.FusedExecutable``), and
*chip-granular* splits carve the device group itself into a disjoint
(prefill side, decode side) pair — the intra-group disaggregation regime
of Nexus / MuxServe's spatial-temporal multiplexing, where the two phases
never contend for a card but every finished prefill pays a KV handoff
over the interconnect.

This module owns the carving: a device group (a sequence of
``torch.device``) becomes one :class:`SubMeshSplit` per quantized split,
each side a tuple of the group's devices. A side computes on its lead
device, its first entry (``models/sharding.py``,
``submesh_param_sharding`` / ``submesh_cache_sharding``). A group may name
one card more than once when its caller lists it so: the two sides are
then disjoint by position in the list, each with its own stream and page
pool, on one card. Carving touches no device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

#: the sub-mesh axis name (chips are the partition quanta here; intra-card
#: SM splits are the other table granularity)
CHIP_AXIS = "chip"


@dataclass(frozen=True)
class SubMeshSplit:
    """One chip-granular partition: disjoint prefill / decode sides carved
    from a single device group."""

    prefill_chips: int
    decode_chips: int
    prefill_mesh: Tuple[torch.device, ...]
    decode_mesh: Tuple[torch.device, ...]

    @property
    def key(self) -> tuple:
        return (self.prefill_chips, self.decode_chips)

    def __repr__(self) -> str:          # keep the device lists out of it
        return (f"SubMeshSplit(prefill_chips={self.prefill_chips}, "
                f"decode_chips={self.decode_chips})")


def chip_mesh(devices: Sequence) -> Tuple[torch.device, ...]:
    """A side over an explicit device list (the whole group, or one side
    of a split): the devices as ``torch.device``, in order."""
    return tuple(torch.device(d) for d in devices)


def carve_submeshes(devices: Sequence, *, quantum: int = 1,
                    min_chips: int = 1) -> List[SubMeshSplit]:
    """Every quantized (prefill side, decode side) split of ``devices``
    with at least ``min_chips`` on each side.

    The split point walks the device list in ``quantum``-entry steps, so
    split k gives prefill ``devices[:k]`` and decode ``devices[k:]`` —
    disjoint by position, covering the group exactly. Fewer than
    ``2 * min_chips`` entries (or a quantum that leaves no interior point)
    yields an empty table: chip granularity does not exist on that group.
    """
    n = len(devices)
    out: List[SubMeshSplit] = []
    if n < 2 * min_chips:
        return out
    q = max(quantum, 1)
    for k in range(min_chips, n - min_chips + 1, q):
        out.append(SubMeshSplit(
            prefill_chips=k, decode_chips=n - k,
            prefill_mesh=chip_mesh(devices[:k]),
            decode_mesh=chip_mesh(devices[k:])))
    return out


def find_split(splits: Sequence[SubMeshSplit], prefill_chips: int,
               decode_chips: int) -> Optional[SubMeshSplit]:
    for s in splits:
        if s.prefill_chips == prefill_chips and s.decode_chips == decode_chips:
            return s
    return None


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
