"""SLO-aware task scheduler (paper §3.3, Algorithm 1).

Each scheduling cycle (one prefill layer-group / one decode iteration):

1. Track progress: estimate remaining prefill time, per-request TTFT,
   queueing delays, and decode TPOTs (lines 2-10).
2. Pick the resource move (lines 11-18):
     both SLOs met            → ReduceDecodeSM   (free units for prefill /
                                 throughput, the paper's prefill-priority)
     both violated            → SetBalancedSM
     TPOT violated only       → ReducePrefillSM
     TTFT violated only       → ReduceDecodeSM (may pause decode entirely,
                                 §3.3.3 "temporarily borrow")
3. Return the new ResourceStatus; the resource manager (resource.py) swaps
   to the matching pre-configured partition.

Units are the TPU resource quanta of estimator.HardwareSpec (chips × grid
interleave slots); ``unit_quantum`` mirrors libsmctrl's 2-SM granularity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import analytics as A
from repro_torch.core.estimator import PerfEstimator
from repro_torch.core.metadata import SystemState, ResourceStatus
from repro_torch.serving.request import SLO, percentile


@dataclass
class SchedulerConfig:
    """Knobs of the Algorithm 1/2 search (see docs/TUNING.md)."""
    #: allocation granularity in resource units — the libsmctrl 2-SM
    #: analogue; every proposed split is a multiple of this, matching the
    #: quantum the ResourceManager pre-built its partition table with
    unit_quantum: int = 2
    #: v_min / u_min: neither phase is starved below this many units while
    #: it has work (the §3.3.3 pause is the only exception)
    min_decode_units: int = 2
    min_prefill_units: int = 2
    #: layers launched per scheduling cycle — the granularity at which the
    #: prefill engine yields back to the scheduler (one pattern-repeat
    #: group in the real engine)
    layer_group: int = 1
    #: percentile over per-request latency projections used for the
    #: violation checks (p90 in the paper's SLO-attainment definition)
    p_quantile: float = 90.0
    #: bound decode starvation under repeated §3.3.3 borrows (W_max)
    max_decode_pause_cycles: int = 48
    #: fraction of the TPOT SLO the search targets — headroom so that
    #: transiently slow iterations cannot poison the cumulative per-request
    #: TPOT (the paper's "estimating delays each step to prevent future
    #: violations")
    tpot_margin: float = 0.6
    #: same headroom for the (normalized) TTFT violation check
    ttft_margin: float = 0.8
    #: execution mode the estimates must match: True (fused spatial
    #: co-execution) applies Eq. 2's p_c/p_b contention whenever both
    #: phases are resident; False (serial temporal dispatches) never
    #: does — the phases time-share the whole device instead of
    #: contending for partitions. BulletServer wires this to its own
    #: fused/serial mode. When the scheduler is additionally given the
    #: engine's prebuilt partition table (``split_candidates``), fused
    #: mode switches the split search itself to the fused objective:
    #: minimize predicted ``fused_cycle_time`` over exactly the table's
    #: PartitionConfigs (docs/PERF_MODEL.md).
    fused: bool = True


@dataclass
class Decision:
    resources: ResourceStatus
    pause_decode: bool = False
    reorder: Optional[List[int]] = None      # new pending-queue order
    reason: str = ""


class SLOScheduler:
    """Decentralized scheduler instance (one per engine, sharing state)."""

    def __init__(self, cfg: ModelConfig, est: PerfEstimator, slo: SLO,
                 sched: Optional[SchedulerConfig] = None,
                 split_candidates: Optional[List[Tuple[int, int]]] = None):
        self.cfg = cfg
        self.est = est
        self.slo = slo
        # None -> a fresh per-scheduler instance, never a shared
        # module-level default object
        self.sc = sched if sched is not None else SchedulerConfig()
        self.decode_paused_cycles = 0
        #: the engine's prebuilt partition table [(prefill_units,
        #: decode_units), ...] (one FusedExecutable each). When set, every
        #: Decision is snapped onto it — the split search can only propose
        #: partitions that actually exist as execution states — and fused
        #: mode searches them under the fused-cycle objective. None (e.g.
        #: the discrete-event simulator, which has no executable table)
        #: keeps the quantized per-phase Algorithm 2 search.
        self.split_candidates = split_candidates
        #: the engine's full partition table (List[PartitionConfig], both
        #: granularities) when chip-granular sub-meshes exist. The
        #: combined-table argmin prices tile entries with Eq. 2's fused
        #: co-location contention and chip entries with no contention but
        #: a KV-handoff charge (docs/PARTITIONS.md) — the
        #: disaggregation-vs-sharing tradeoff as one table argmin.
        self.partition_table: Optional[List] = None
        #: observability sink (repro.obs.Observability); the engine wires
        #: its own instance in so decision rationale / pause-gate firings
        #: land in the same registry as the cycle trace. None = silent.
        self.obs = None
        #: the most recent Decision returned by schedule() — the engine's
        #: cycle trace reads its ``reason`` as the scheduler rationale
        self.last_decision: Optional[Decision] = None
        #: optional admission-priority hook ``rid -> tier`` (higher tier
        #: admits earlier). The engine wires the tenancy layer's
        #: credit-quantized tier here (docs/MULTITENANCY.md); the slack
        #: sort stays the within-tier order, so None (default) keeps
        #: reorder_pending's pure Algorithm 1 behavior.
        self.priority = None

    # -- progress tracking (Algorithm 1 lines 2-10) -------------------
    def estimate_ttfts(self, state: SystemState, now: float,
                       pending: List[Tuple[int, float, int]]) -> Dict[int, float]:
        """Estimated TTFT (ms, normalized per prompt token) for the active
        prefill and all pending requests [(rid, arrival, prompt_len)]."""
        P, R = state.prefill, state.resources
        colocated = (self.sc.fused and state.decode.n_d > 0
                     and not state.decode.paused)
        out: Dict[int, float] = {}
        rem_layers = max(P.total_layers - P.layers_done, 0)
        per_layer = self.est.prefill_layer_time(
            self.cfg, max(P.n_tokens, 1), 0, max(R.prefill_units, 1),
            colocated=colocated)
        rem_time = per_layer * rem_layers
        if P.active_rid is not None:
            elapsed = now - P.started_at
            q = P.queue_wait.get(P.active_rid, 0.0)
            out[P.active_rid] = (q + elapsed + rem_time) * 1e3 / max(P.n_tokens, 1)
        # pending requests queue behind the active prefill (line 5-7)
        t_ahead = rem_time
        for rid, arrival, plen in pending:
            t_pre = self.est.prefill_time(self.cfg, plen,
                                          max(R.prefill_units, 1),
                                          colocated=colocated)
            waited = now - arrival
            out[rid] = (waited + t_ahead + t_pre) * 1e3 / max(plen, 1)
            t_ahead += t_pre
        return out

    def observed_tpots(self, state: SystemState) -> Dict[int, float]:
        D = state.decode
        return {rid: D.tpot(rid) * 1e3 for rid in D.batch}

    def predicted_tpot_ms(self, state: SystemState, units: int) -> float:
        D = state.decode
        if D.n_d == 0:
            return 0.0
        colocated = self.sc.fused and state.prefill.active_rid is not None
        return 1e3 * self.est.decode_iter_time(
            self.cfg, D.n_d, max(D.context, 1), max(units, 1),
            colocated=colocated)

    # -- search moves (Algorithm 1 lines 11-18 + Algorithm 2) ----------
    def _quantize(self, units: int) -> int:
        q = self.sc.unit_quantum
        return max(q, (units // q) * q)

    def _snap_to_table(self, res: ResourceStatus) -> ResourceStatus:
        """Snap a proposed (u, v) onto the engine's prebuilt partition
        table (mirror of ResourceManager.nearest): the scheduler must
        never hand the engine a split it has no executable for — e.g.
        prefill-only on a table whose total_units is not a multiple of
        the quantum."""
        if not self.split_candidates:
            return res
        u, v = min(self.split_candidates,
                   key=lambda c: abs(c[0] - res.prefill_units))
        return ResourceStatus(u, v)

    def _fused_candidates(self, total: int) -> List[Tuple[int, int]]:
        """Both-phases-resident splits of the prebuilt table (extremes
        excluded by the v_min/u_min floors)."""
        return [(u, v) for u, v in self.split_candidates
                if u + v == total and u >= self.sc.min_prefill_units
                and v >= self.sc.min_decode_units]

    def _fused_search_applicable(self, state: SystemState,
                                 total: int) -> bool:
        """One gate for both Algorithm 1 branches: the fused-cycle
        objective applies when the scheduler drives the fused engine
        (sc.fused + a prebuilt table), both phases are resident, and the
        table offers at least one both-phases split."""
        return bool(self.sc.fused and self.split_candidates
                    and state.decode.n_d > 0 and state.prefill.n_tokens > 0
                    and self._fused_candidates(total))

    def _fused_cycle_ms(self, state: SystemState, u: int, v: int) -> float:
        """Predicted duration of one fused engine cycle under split
        (u, v) — also the decode batch's per-token cadence, since a fused
        cycle emits one token per running slot."""
        P, D = state.prefill, state.decode
        lg = self.sc.layer_group * len(self.cfg.pattern)
        return 1e3 * self.est.fused_cycle_time(
            self.cfg, max(P.n_tokens, 1), max(u, 1), max(v, 1),
            max(D.n_d, 1), max(int(D.context), 1), layer_group=lg)

    def _fused_split_search(self, state: SystemState, total: int,
                            target_tpot_ms: float
                            ) -> Tuple[int, int, float]:
        """Fused-objective Algorithm 2: pick the table split minimizing
        the predicted fused cycle time, subject to the TPOT gate (cycle
        time IS the fused TPOT, so the gate is directly on the objective;
        the TTFT side needs no separate gate — minimizing the cycle also
        maximizes prefill progress per cycle, and the §3.3.3 pause branch
        remains the escalation when no co-run split can rescue TTFT).

        Ties (the shared-HBM-pipe regime, where Eq. 2's bandwidth term is
        split-independent) break toward the lower compute-side imbalance,
        then toward more decode units. Returns (u, v, cycle_ms).
        """
        P, D = state.prefill, state.decode
        lg = self.sc.layer_group * len(self.cfg.pattern)
        U = self.est.hw.total_units
        p_flops = (A.prefill_cost(self.cfg, max(P.n_tokens, 1), 0,
                                  include_head=False).flops
                   / self.cfg.n_layers * lg)
        d_flops = A.decode_cost(self.cfg, max(D.n_d, 1),
                                max(int(D.context), 1)).flops
        gated = ungated = None            # (t_ms, t_c, -v, u, v)
        for u, v in self._fused_candidates(total):
            t_ms = self._fused_cycle_ms(state, u, v)
            # compute-side imbalance, for tie-breaking only: both phases'
            # partitioned Eq. 2 compute terms under this split (same
            # formula fused_cycle_time's t_c uses)
            t_c = max(
                self.est.colocated_compute_time(p_flops, max(u, 1) / U),
                self.est.colocated_compute_time(d_flops, max(v, 1) / U))
            key = (t_ms, t_c, -v, u, v)
            if ungated is None or key < ungated:
                ungated = key
            if t_ms <= target_tpot_ms and (gated is None or key < gated):
                gated = key
        best = gated if gated is not None else ungated
        # no candidate meets the gate: minimizing the cycle still
        # minimizes the fused TPOT, so the argmin is the best rescue
        return best[3], best[4], best[0]

    # -- chip-granular search (sub-mesh disaggregation) ----------------
    def _chip_candidates(self) -> List:
        return [p for p in (self.partition_table or [])
                if getattr(p, "granularity", "tile") == "chip"]

    def _chip_cycle_ms(self, state: SystemState, part) -> float:
        """Predicted duration of one chip-granular cycle under ``part``:
        disjoint sub-meshes run the phases concurrently (max, no
        contention) and the task's one-shot KV handoff is amortized over
        its layer-group cycles — n_tokens · lg / total_layers per cycle —
        so the argmin weighs handoff cost at the same per-cycle
        granularity it weighs contention."""
        P, D = state.prefill, state.decode
        lg = self.sc.layer_group * len(self.cfg.pattern)
        total_layers = max(P.total_layers, lg) or lg
        amortized = P.n_tokens * lg / total_layers
        return 1e3 * self.est.chip_cycle_time(
            self.cfg, max(P.n_tokens, 1), part.prefill_units,
            part.decode_units, max(D.n_d, 1), max(int(D.context), 1),
            layer_group=lg, handoff_tokens=amortized)

    def _chip_split_search(self, state: SystemState, target_tpot_ms: float):
        """Argmin of the predicted chip-cycle time over the chip entries,
        TPOT-gated like the fused search (a chip cycle emits one token per
        running slot, so the cycle time is the decode cadence there too).
        Ties break toward more decode chips. Returns (entry, cycle_ms)."""
        gated = ungated = None            # (t_ms, -decode_chips, cid, part)
        for p in self._chip_candidates():
            t_ms = self._chip_cycle_ms(state, p)
            key = (t_ms, -p.decode_chips, p.config_id, p)
            if ungated is None or key[:3] < ungated[:3]:
                ungated = key
            if t_ms <= target_tpot_ms and (gated is None
                                           or key[:3] < gated[:3]):
                gated = key
        best = gated if gated is not None else ungated
        return best[3], best[0]

    def combined_argmin(self, state: SystemState):
        """The §3.4 table argmin over BOTH granularities for the current
        co-resident mix: tile entries priced at Eq. 2's fused co-located
        cycle (contention, shared HBM pipe), chip entries at the
        disjoint-sub-mesh max plus amortized KV handoff. Returns
        (granularity, cycle_ms) of the winner — ``"chip"`` exactly when
        the modeled handoff cost undercuts the modeled co-location
        contention. None when either phase is absent (the tradeoff needs
        both resident)."""
        chips = self._chip_candidates()
        total = self.est.hw.total_units
        if (not chips or state.decode.n_d == 0
                or state.prefill.n_tokens <= 0):
            return None
        _, chip_ms = self._chip_split_search(state, float("inf"))
        if self.sc.fused and self.split_candidates \
                and self._fused_candidates(total):
            tile_ms = min(self._fused_cycle_ms(state, u, v)
                          for u, v in self._fused_candidates(total))
        else:
            P, D = state.prefill, state.decode
            lg = self.sc.layer_group * len(self.cfg.pattern)
            tile_ms = 1e3 * self.est.serial_cycle_time(
                self.cfg, max(P.n_tokens, 1), max(D.n_d, 1),
                max(int(D.context), 1), layer_group=lg)
        return ("chip", chip_ms) if chip_ms < tile_ms else ("tile", tile_ms)

    def preferred_granularity(self, state: SystemState) -> str:
        """Task-granularity pick at prefill admission: the combined-table
        argmin's winner (tile when the tradeoff is moot)."""
        best = self.combined_argmin(state)
        return best[0] if best is not None else "tile"

    def _to_chip(self, state: SystemState, d: Decision) -> Decision:
        """Restrict a Decision to the chip-granular half of the table (the
        engine pins a prefill task's granularity for its lifetime; every
        scheduling cycle of a chip task must name a chip entry). Both
        phases resident: TPOT-gated chip split search. One phase absent:
        snap to the chip entry nearest the tile decision's unit split.
        The §3.3.3 pause never applies — decode owns its chips outright,
        so there is nothing to borrow."""
        chips = self._chip_candidates()
        if not chips:
            return d
        if state.decode.n_d > 0 and state.prefill.n_tokens > 0:
            part, _ = self._chip_split_search(
                state, self.sc.tpot_margin * self.slo.tpot_ms)
        else:
            part = min(chips, key=lambda p: (
                abs(p.prefill_units - d.resources.prefill_units),
                p.config_id))
        d.resources = ResourceStatus(
            part.prefill_units, part.decode_units, part.config_id,
            "chip", part.prefill_chips, part.decode_chips)
        d.pause_decode = False
        return d

    def _pause_ok(self, state: SystemState, dt_pause: float) -> bool:
        """Is delaying decode by ``dt_pause`` seconds safe for every
        in-flight request's *cumulative* TPOT (§3.3.3 borrow)?"""
        D = state.decode
        if not D.batch:
            return False
        proj = [1e3 * (D.decode_time.get(r, 0.0) + dt_pause)
                / max(D.out_tokens.get(r, 1), 1) for r in D.batch]
        return (percentile(proj, self.sc.p_quantile)
                < self.sc.tpot_margin * self.slo.tpot_ms)

    def _reduce_decode(self, state: SystemState, total: int, *,
                       ttft_violated: bool = False) -> Decision:
        """Shift units decode→prefill while the *predicted* TPOT stays under
        tpot_margin·SLO (Algorithm 2's step-wise search, v → v_min); in the
        TTFT-violated branch, if v_min still cannot rescue TTFT while TPOT
        has slack, temporarily pause decode (§3.3.3 "borrow").

        With the fused engine (``sc.fused`` + a prebuilt partition table)
        and both phases resident, the search objective is the predicted
        ``fused_cycle_time`` over the table's splits instead of the
        per-phase prefill-group time — the partition the engine actually
        runs is one fused dispatch, so per-phase times are fiction there.
        """
        target = self.sc.tpot_margin * self.slo.tpot_ms
        n_tok = max(state.prefill.n_tokens, 1)
        colocated = self.sc.fused and state.decode.n_d > 0

        if self._fused_search_applicable(state, total):
            u, v, _ = self._fused_split_search(state, total, target)
            # §3.3.3 gate preserved: the exclusive-gain comparison below
            # keeps its per-phase semantics — the best prefill-group time
            # any co-run split could offer (what the serial-objective
            # search used as best_t) vs. exclusive. Using the fused-chosen
            # split (or the whole cycle time, which includes decode's
            # share) would inflate the "gain" and turn the proactive
            # borrow into a constant pause, starving the fused path.
            best_t = min(self.est.prefill_layer_time(
                self.cfg, n_tok, 0, cu, colocated=colocated)
                for cu, _cv in self._fused_candidates(total))
        else:
            # Algorithm 2: walk candidate splits, *estimating* both phases
            # at each step — maximizing prefill units is NOT monotone in
            # prefill speed because of Eq. 1 tail waves (tile count vs.
            # slot count).
            best_v, best_t = None, float("inf")
            v = self.sc.min_decode_units
            while v <= total - self.sc.min_prefill_units:
                if (not state.decode.n_d or
                        self.predicted_tpot_ms(state, v) <= target):
                    t_p = self.est.prefill_layer_time(
                        self.cfg, n_tok, 0, total - v, colocated=colocated)
                    # prefer more decode units at equal prefill speed
                    if t_p < best_t * 0.999 or (abs(t_p - best_t) <= best_t * 1e-3
                                                and best_v is not None and v > best_v):
                        best_v, best_t = v, min(t_p, best_t)
                v += self.sc.unit_quantum
            if best_v is None:      # no split satisfies TPOT: give decode all
                best_v = total - self.sc.min_prefill_units
            v = self._quantize(best_v)
            u = total - v

        # §3.3.3 borrow: while a prefill is resident, running it exclusively
        # (no contention, full units) beats any co-run split as long as the
        # projected cumulative TPOTs keep their margin. Bounded by
        # max_decode_pause_cycles so decode always makes progress. When TTFT
        # is already violated, any exclusive speedup justifies borrowing —
        # the gain threshold only gates the proactive (SLOs-met) branch.
        pause = False
        if state.prefill.n_tokens > 0 and state.decode.n_d:
            dt_pause = self.est.prefill_layer_time(
                self.cfg, n_tok, 0, total,
                colocated=False) * self.sc.layer_group
            exclusive_gain = best_t / max(self.est.prefill_layer_time(
                self.cfg, n_tok, 0, total, colocated=False), 1e-12)
            if ((ttft_violated or exclusive_gain > 1.02) and
                    self._pause_ok(state, dt_pause) and
                    self.decode_paused_cycles < self.sc.max_decode_pause_cycles):
                pause = True
                u, v = total, 0
        return Decision(ResourceStatus(u, v), pause_decode=pause,
                        reason="reduce_decode")

    def _reduce_prefill(self, state: SystemState, total: int) -> Decision:
        u = state.resources.prefill_units or total // 2
        u = max(self.sc.min_prefill_units,
                self._quantize(u - 2 * self.sc.unit_quantum))
        return Decision(ResourceStatus(u, total - u), reason="reduce_prefill")

    def _balanced(self, state: SystemState, total: int) -> Decision:
        """Both SLOs violated. Serial model: split proportionally to
        estimated phase demand. Fused engine: every split runs as one
        cycle anyway, so the only lever is the cycle time itself —
        minimize predicted ``fused_cycle_time`` over the table, gated at
        the full (margin-free) TPOT SLO since the margin headroom is
        already gone."""
        P, D = state.prefill, state.decode
        if self._fused_search_applicable(state, total):
            u, v, _ = self._fused_split_search(state, total,
                                               self.slo.tpot_ms)
            return Decision(ResourceStatus(u, v), reason="balanced")
        t_p = self.est.prefill_time(self.cfg, max(P.n_tokens, 1), total,
                                    colocated=self.sc.fused)
        t_d = self.est.decode_iter_time(self.cfg, max(D.n_d, 1),
                                        max(D.context, 1), total,
                                        colocated=self.sc.fused)
        frac = t_p / max(t_p + t_d, 1e-9)
        u = self._quantize(int(total * frac))
        u = min(max(u, self.sc.min_prefill_units),
                total - self.sc.min_decode_units)
        return Decision(ResourceStatus(u, total - u), reason="balanced")

    def reorder_pending(self, state: SystemState, now: float,
                        pending: List[Tuple[int, float, int]],
                        ttfts: Optional[Dict[int, float]] = None
                        ) -> List[int]:
        """Slack-sorted pending order (Algorithm 1 line 7 "sort") — the
        admission-time subset of ``schedule`` (no resource search, no
        pause-counter side effects)."""
        if ttfts is None:
            ttfts = self.estimate_ttfts(state, now, pending)
        order = sorted(
            (rid for rid, _, _ in pending),
            key=lambda rid: self.slo.norm_ttft_ms - ttfts.get(rid, 0.0))
        if self.priority is not None:
            # stable: high-credit tenants admit first, slack order within
            # a tier is untouched
            order.sort(key=lambda rid: -self.priority(rid))
        return order

    # -- main entry (Algorithm 1) --------------------------------------
    def schedule(self, state: SystemState, now: float,
                 pending: List[Tuple[int, float, int]],
                 granularity: Optional[str] = None) -> Decision:
        """One scheduling cycle. ``granularity="chip"`` restricts the
        decision to chip-granular entries (the engine passes it for
        cycles driving a chip-pinned prefill task); None keeps the
        tile-granular Algorithm 1/2 behavior."""
        total = self.est.hw.total_units
        ttfts = self.estimate_ttfts(state, now, pending)
        tpots = self.observed_tpots(state)
        order = self.reorder_pending(state, now, pending, ttfts)

        q = self.sc.p_quantile
        # proactive: act before the estimate actually crosses the SLO
        ttft_vio = (bool(ttfts) and percentile(list(ttfts.values()), q)
                    > self.sc.ttft_margin * self.slo.norm_ttft_ms)
        tpot_vio = (bool(tpots) and
                    percentile(list(tpots.values()), q) > self.slo.tpot_ms)

        if not ttft_vio and not tpot_vio:
            d = self._reduce_decode(state, total)         # line 11-12
        elif ttft_vio and tpot_vio:
            d = self._balanced(state, total)              # line 13-14
        elif tpot_vio:
            d = self._reduce_prefill(state, total)        # line 15-16
        else:
            d = self._reduce_decode(state, total,         # line 17-18
                                    ttft_violated=True)
        d.reorder = order
        # nothing to prefill -> give decode everything
        if state.prefill.active_rid is None and not pending:
            d = Decision(ResourceStatus(0, total), reorder=order,
                         reason="decode_only")
        if state.decode.n_d == 0 and not d.pause_decode:
            d = Decision(ResourceStatus(total, 0), reorder=order,
                         reason="prefill_only")
        # every decision the engine sees must name a prebuilt partition
        d.resources = self._snap_to_table(d.resources)
        if granularity == "chip":
            d = self._to_chip(state, d)
        if d.pause_decode:
            self.decode_paused_cycles += 1
        else:
            self.decode_paused_cycles = 0
        self.last_decision = d
        if self.obs is not None and self.obs.enabled:
            self.obs.on_decision(d, ttft_vio, tpot_vio)
        return d
