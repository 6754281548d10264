"""Shared metadata buffer (paper §3.5.2).

On GPU Bullet uses OS shared memory between the prefill and decode
processes. Here both engines live in one process and share one stream,
so the buffer is a plain object with the same contract: decentralized
schedulers read global state from it and write their own status back, with
generation counters standing in for the paper's control bits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class PrefillStatus:
    """P_k of §3.3.2: (l_k, n_p, p_k, q_i, w_k)."""
    active_rid: Optional[int] = None
    layers_done: int = 0                 # l_k
    total_layers: int = 0
    n_tokens: int = 0                    # n_p
    started_at: float = 0.0              # p_k reference point
    queue_wait: Dict[int, float] = field(default_factory=dict)   # q_i
    n_waiting: int = 0                   # w_k


@dataclass
class DecodeStatus:
    """D_k of §3.3.2: (n_d, o_i, d_i)."""
    batch: List[int] = field(default_factory=list)               # request ids
    out_tokens: Dict[int, int] = field(default_factory=dict)     # o_i
    decode_time: Dict[int, float] = field(default_factory=dict)  # d_i
    mean_context: int = 0
    #: summed live context across the batch — the KV tokens a paged decode
    #: iteration actually streams (mean_context truncates; the scheduler's
    #: bandwidth charge uses this when available)
    ctx_tokens: int = 0
    paused: bool = False

    @property
    def n_d(self) -> int:
        return len(self.batch)

    @property
    def context(self) -> float:
        """Best available mean context: exact (ctx_tokens/n_d) when the
        engine reports summed live context, else the stored mean."""
        if self.ctx_tokens and self.batch:
            return self.ctx_tokens / len(self.batch)
        return float(self.mean_context)

    def tpot(self, rid: int) -> float:
        o = self.out_tokens.get(rid, 0)
        return self.decode_time.get(rid, 0.0) / max(o, 1)


@dataclass
class ResourceStatus:
    """R_k: units allocated to prefill (u_k) and decode (v_k), plus the
    partition descriptor that disambiguates *which* execution state those
    units name. ``granularity`` is ``"tile"`` (both phases share every
    chip spatially; the fused-executable table) or ``"chip"`` (disjoint
    prefill/decode sub-meshes of ``prefill_chips``/``decode_chips``
    devices; the pjit-pair table). Unit counts alone are ambiguous — a
    2+2-chip split and a (16, 16)-unit tile split are different machines
    — so the resource-manager table is keyed on the full descriptor."""
    prefill_units: int = 0
    decode_units: int = 0
    config_id: int = 0
    granularity: str = "tile"
    prefill_chips: int = 0
    decode_chips: int = 0


@dataclass
class SystemState:
    """S_k = (P_k, D_k, R_k) plus handoff queues."""
    prefill: PrefillStatus = field(default_factory=PrefillStatus)
    decode: DecodeStatus = field(default_factory=DecodeStatus)
    resources: ResourceStatus = field(default_factory=ResourceStatus)
    #: prefill→decode migration queue: (rid, first_token, cache handles);
    #: copy-free — only indices travel (shared KV pool).
    ready_for_decode: List[Tuple[int, int]] = field(default_factory=list)
    generation: int = 0

    def publish(self):
        self.generation += 1


class MetadataBuffer:
    """Single-writer-per-section shared buffer with rough latency tracking
    (Table 3 'Metadata Send/Recv' analogue)."""

    def __init__(self):
        self.state = SystemState()
        self._rw_latencies: List[float] = []

    def read(self) -> SystemState:
        t0 = time.perf_counter()
        s = self.state
        self._rw_latencies.append(time.perf_counter() - t0)
        return s

    def write(self, mutate) -> None:
        t0 = time.perf_counter()
        mutate(self.state)
        self.state.publish()
        self._rw_latencies.append(time.perf_counter() - t0)

    @property
    def rw_latencies(self) -> List[float]:
        return self._rw_latencies
