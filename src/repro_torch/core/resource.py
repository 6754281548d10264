"""Computational resource manager (paper §3.4).

GPU Bullet pre-creates CUDA streams with libsmctrl SM masks and switches
among them in ~4 µs. The port keeps a table of *pre-configured
execution states* at two granularities:

- **tile granularity**: one fused-step launcher per quantized
  ``decode_share`` — the share of the SMs whose CTAs in the fused
  attention kernel take decode work first (both phases co-resident on
  the card, Eq. 2 contention applies);
- **chip granularity**: one pjit executable pair per (prefill sub-mesh,
  decode sub-mesh) split of the device group (launch/submesh.py) — the
  phases run on disjoint chips with no co-location contention, and a
  finished prefill pays a cross-mesh KV handoff instead.

The table is the *union* of both granularities, keyed by the full
partition descriptor ``(granularity, prefill_units, decode_units,
prefill_chips, decode_chips)`` — unit counts alone are ambiguous (a
2+2-chip split and a (16, 16)-unit tile split both read "16 units each"
but name different machines), so quantizing on units silently collapsed
distinct chip entries until the key carried the descriptor.

"Re-configuration" is a dict lookup — measured in benchmarks/overheads.py
(Table 3 'Resource Re-config'). Non-strict isolation (paper Fig. 8b's
overlapping masks) maps to decode_share values whose tile streams share
grid slots. See docs/PARTITIONS.md for when the scheduler picks which
granularity.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.estimator import HardwareSpec
from repro_torch.core.metadata import ResourceStatus

TILE = "tile"
CHIP = "chip"


@dataclass(frozen=True)
class PartitionConfig:
    """One pre-configured spatial-temporal partition.

    Tile entries leave ``prefill_chips``/``decode_chips`` at 0; chip
    entries carry both the chip split and its unit-space projection
    (``prefill_units = U * prefill_chips / n_chips``), so the estimator
    prices every entry in one unit vocabulary.
    """
    config_id: int
    prefill_units: int
    decode_units: int
    granularity: str = TILE
    prefill_chips: int = 0
    decode_chips: int = 0

    @property
    def decode_share(self) -> float:
        tot = self.prefill_units + self.decode_units
        return self.decode_units / tot if tot else 0.0

    @property
    def key(self) -> Tuple[str, int, int, int, int]:
        """The full partition descriptor the table is keyed by."""
        return (self.granularity, self.prefill_units, self.decode_units,
                self.prefill_chips, self.decode_chips)

    def status(self) -> ResourceStatus:
        return ResourceStatus(self.prefill_units, self.decode_units,
                              self.config_id, self.granularity,
                              self.prefill_chips, self.decode_chips)


def _status_key(res: ResourceStatus) -> Tuple[str, int, int, int, int]:
    gran = getattr(res, "granularity", TILE) or TILE
    return (gran, res.prefill_units, res.decode_units,
            getattr(res, "prefill_chips", 0), getattr(res, "decode_chips", 0))


def default_partitions(hw: HardwareSpec, quantum: int = 2
                       ) -> List[PartitionConfig]:
    """The pre-created tile-granular partition table (paper Fig. 8b):
    every quantized split including prefill-only and decode-only."""
    U = hw.total_units
    out = []
    cid = 0
    for u in range(0, U + 1, quantum):
        out.append(PartitionConfig(cid, u, U - u))
        cid += 1
    return out


def chip_partitions(hw: HardwareSpec, splits: Sequence[Tuple[int, int]], *,
                    first_id: int = 0) -> List[PartitionConfig]:
    """Chip-granular entries for ``splits`` of (prefill_chips,
    decode_chips), with unit counts projected proportionally onto the
    estimator's unit space so both granularities price through the same
    Eq. 2 terms."""
    U = hw.total_units
    out = []
    for i, (pc, dc) in enumerate(splits):
        n = max(pc + dc, 1)
        u = U * pc // n
        out.append(PartitionConfig(first_id + i, u, U - u,
                                   granularity=CHIP,
                                   prefill_chips=pc, decode_chips=dc))
    return out


class ResourceManager:
    """Holds pre-built execution states; instant switching.

    ``builder`` pre-builds one execution state per *tile* entry (the
    engine's FusedExecutable factory); ``chip_builder`` does the same per
    *chip* entry (the pjit-pair factory). Either may be None — entries
    without an executable still exist on the table for pricing (the
    simulator and serial mode only need the numbers).
    """

    def __init__(self, hw: HardwareSpec, quantum: int = 2,
                 builder: Optional[Callable[[PartitionConfig], object]] = None,
                 chip_splits: Optional[Sequence[Tuple[int, int]]] = None,
                 chip_builder: Optional[
                     Callable[[PartitionConfig], object]] = None):
        self.hw = hw
        self.quantum = quantum
        tile = default_partitions(hw, quantum)
        chips = chip_partitions(hw, chip_splits or (), first_id=len(tile))
        self.partitions: List[PartitionConfig] = tile + chips
        self._tile = tile
        self._chip = chips
        self._by_key: Dict[Tuple[str, int, int, int, int], PartitionConfig] = {
            p.key: p for p in self.partitions}
        assert len(self._by_key) == len(self.partitions), (
            "partition descriptors collide")
        self._exec: Dict[int, object] = {}
        self._builder = builder
        self.current: PartitionConfig = tile[len(tile) // 2]
        self.switch_latencies: List[float] = []
        if builder is not None:
            for p in tile:
                self._exec[p.config_id] = builder(p)
        if chip_builder is not None:
            for p in chips:
                self._exec[p.config_id] = chip_builder(p)

    @property
    def tile_entries(self) -> List[PartitionConfig]:
        return self._tile

    @property
    def chip_entries(self) -> List[PartitionConfig]:
        return self._chip

    def on_table(self, res: ResourceStatus) -> bool:
        """Is the full partition descriptor exactly a pre-built entry?
        The engine asserts this for every fused-mode Decision: the split
        search must only propose execution states that exist, with
        ``nearest()`` reserved for callers that legitimately quantize
        (the simulator, serial mode)."""
        return _status_key(res) in self._by_key

    def lookup(self, res: ResourceStatus) -> Optional[PartitionConfig]:
        return self._by_key.get(_status_key(res))

    def nearest(self, res: ResourceStatus) -> PartitionConfig:
        """Quantize an arbitrary request onto the partition table, *within
        its granularity*.

        Tile: clamp-then-round can land off the table when ``total_units``
        is not a multiple of ``quantum`` (e.g. U=5, quantum=3: u=5 rounds
        to 6, but the table tops out at (3, 2)); snap to the nearest entry
        that actually exists instead of KeyError-ing mid-serve.

        Chip: snap to the entry with the nearest prefill chip count. A
        chip-granular request never resolves to a tile entry (or vice
        versa) even when the unit counts coincide — the regression the
        descriptor key exists for.
        """
        gran = getattr(res, "granularity", TILE) or TILE
        if gran == CHIP and self._chip:
            want = getattr(res, "prefill_chips", 0)
            return min(self._chip,
                       key=lambda p: (abs(p.prefill_chips - want),
                                      p.config_id))
        U = self.hw.total_units
        u = max(0, min(U, res.prefill_units))
        u = round(u / self.quantum) * self.quantum
        cfg = self._by_key.get((TILE, u, U - u, 0, 0))
        if cfg is None:
            cfg = min(self._tile,
                      key=lambda p: (abs(p.prefill_units - u), p.config_id))
        return cfg

    def switch(self, res: ResourceStatus) -> PartitionConfig:
        """Instant re-configuration (Table 3): a table lookup."""
        t0 = time.perf_counter()
        cfg = self.nearest(res)
        self.current = cfg
        self.switch_latencies.append(time.perf_counter() - t0)
        return cfg

    def executable(self, cfg: Optional[PartitionConfig] = None):
        cfg = cfg or self.current
        return self._exec.get(cfg.config_id)
