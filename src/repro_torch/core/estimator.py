"""Bullet performance estimator (paper §3.2) — profile-augmented roofline.

Eq. 1 (wave quantization):   s = 1 - g / (M · ceil(g/M))
Eq. 2 (partitioned, co-located execution):

    t = max( c/C · M/(m·d_c·p_c) ,  b/B · M/(m·d_b·p_b) ) / (1 - s)

On the H100 the partitionable unit is the paper's own: one SM, so
``units_per_chip`` is the card's SM count. The fused kernel gives the
share ``decode_share`` of the SMs of one persistent launch to decode and
the rest to prefill: each CTA reads its SM's id, and an SM's CTAs take
their own phase's items first and the other's once those run out. The decay factors d_c(u), d_b(u) model the sub/super-linear scaling
of compute and bandwidth with the partition fraction u = m/M (paper Fig. 7),
and p_c, p_b model co-location contention. All four are fitted from
profiles (offline profiling, §3.2.2); until the port runs that sweep on the
card they keep the JAX package's defaults.
"""

from __future__ import annotations

import functools
import math
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Deque, Dict, List, NamedTuple, Optional, Sequence, Tuple


from repro_torch.configs.base import ModelConfig
from repro_torch.core import analytics as A


# Cost accounting is pure in hashable args (ModelConfig is frozen), and the
# refit loss / split search re-price the same cycles under many candidate
# params — memoize the counts so only the Eq. 2 parameter math re-runs.
_prefill_cost = functools.lru_cache(maxsize=4096)(A.prefill_cost)


@functools.lru_cache(maxsize=4096)
def _decode_cost(cfg: ModelConfig, batch: int, ctx: int,
                 contexts: Optional[Tuple[int, ...]],
                 page_size: Optional[int]):
    return A.decode_cost(cfg, batch, ctx, contexts=contexts,
                         page_size=page_size)


def _decode_cost_any(cfg: ModelConfig, batch: int, ctx: int,
                     contexts: Optional[Sequence[int]],
                     page_size: Optional[int]):
    return _decode_cost(cfg, batch, ctx,
                        tuple(contexts) if contexts is not None else None,
                        page_size)


# ---------------------------------------------------------------------------
# Hardware
# ---------------------------------------------------------------------------

#: SMs of an H100 SXM (data sheet); used when no card is present
H100_SMS = 132


def _sm_count() -> int:
    """SMs of CUDA device 0, or the H100's 132 where no card is present."""
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).multi_processor_count
    return H100_SMS


@dataclass(frozen=True)
class HardwareSpec:
    """A serving instance: one NVIDIA H100 SXM. Peaks are NVIDIA data-sheet
    values (dense bf16 tensor-core rate, HBM3 rate, NVLink per direction),
    not measurements."""
    name: str = "h100-sxm"
    n_chips: int = 1
    peak_flops: float = 989e12          # bf16 dense, data sheet
    hbm_bw: float = 3.35e12             # bytes/s, data sheet
    ici_bw: float = 450e9               # NVLink bytes/s each way, data sheet
    #: the partitionable unit is one SM (the CTA split of the fused kernel)
    units_per_chip: int = field(default_factory=_sm_count)
    grid_slots: int = field(default_factory=_sm_count)  # CTAs resident, Eq. 1

    @property
    def total_units(self) -> int:
        return self.n_chips * self.units_per_chip

    @property
    def total_flops(self) -> float:
        return self.n_chips * self.peak_flops

    @property
    def total_bw(self) -> float:
        return self.n_chips * self.hbm_bw



def wave_quantization_idle(grid: int, slots: int) -> float:
    """Eq. 1: idle fraction caused by the tail wave."""
    if grid <= 0:
        return 0.0
    waves = math.ceil(grid / slots)
    return 1.0 - grid / (slots * waves)


# ---------------------------------------------------------------------------
# Estimator parameters (fitted)
# ---------------------------------------------------------------------------

@dataclass
class EstimatorParams:
    """d/p factors of Eq. 2, parameterized as u^alpha curves.

    effective_compute(u)  = u^alpha_c          (alpha_c > 1: sub-linear)
    effective_bw(u)       = u^alpha_b          (alpha_b < 1: super-linear)
    contention            = p_c (compute), p_b (bandwidth), applied only
                            when both phases are resident.
    sustained_frac        = fraction of peak a saturated kernel reaches
                            (the paper's 75-92%% ceiling, Fig. 2).
    """
    alpha_c: float = 1.15
    alpha_b: float = 0.85
    p_c: float = 0.92
    p_b: float = 0.88
    sustained_compute: float = 0.80
    sustained_bw: float = 0.85

    def d_c(self, u: float) -> float:
        return max(u, 1e-3) ** (self.alpha_c - 1.0)

    def d_b(self, u: float) -> float:
        return max(u, 1e-3) ** (self.alpha_b - 1.0)


@dataclass
class PerfEstimator:
    hw: HardwareSpec = field(default_factory=HardwareSpec)
    params: EstimatorParams = field(default_factory=EstimatorParams)
    #: multiplicative residual corrections learned online (§3.3.2 feedback)
    feedback: Dict[str, float] = field(default_factory=dict)

    # -- Eq. 2 --------------------------------------------------------
    def kernel_time(self, flops: float, bytes_: float, units: int, *,
                    colocated: bool = False, grid: Optional[int] = None,
                    oversub: float = 1.0) -> float:
        """Partition-and-contention-aware roofline time (seconds).

        ``oversub`` > 1 models unmanaged co-location (the Naive/MuxServe-
        style full-claim regime): both phases claim units whose sum exceeds
        the machine, so each effectively time-shares (m -> m/oversub).
        """
        m = max(1, min(units, self.hw.total_units))
        m = m / max(oversub, 1.0)
        u = m / self.hw.total_units
        pc = self.params.p_c if colocated else 1.0
        pb = self.params.p_b if colocated else 1.0
        c_eff = (self.hw.total_flops * self.params.sustained_compute
                 * u * self.params.d_c(u) * pc)
        b_eff = (self.hw.total_bw * self.params.sustained_bw
                 * u * self.params.d_b(u) * pb)
        t = max(flops / c_eff, bytes_ / b_eff)
        # Grid size: attention tiles bound parallelism explicitly, but GEMM
        # work always tiles over the weight dims too — take the max so a
        # small batch is not modeled as occupying a single tile.
        g = max(grid or 0, self._grid_for(flops))
        s = wave_quantization_idle(g, max(1, int(self.hw.grid_slots * u *
                                                 self.hw.n_chips)))
        return t / max(1.0 - s, 1e-2)

    def _grid_for(self, flops: float) -> int:
        # tiles of ~128x128x512 MACs as the GEMM grid granule
        return max(1, int(flops / (2 * 128 * 128 * 512)))

    def colocated_compute_time(self, flops: float, u: float) -> float:
        """Eq. 2's compute term for one co-located phase on partition
        fraction ``u``: flops / (C·u·d_c(u)·p_c). Building block of
        ``fused_cycle_time``'s t_c, exposed so the scheduler's split
        tie-break prices compute imbalance with the same formula."""
        C = self.hw.total_flops * self.params.sustained_compute
        return flops / (C * max(u, 1e-3) * self.params.d_c(u)
                        * self.params.p_c)

    # -- phase-level API used by scheduler & simulator ----------------
    def prefill_layer_time(self, cfg: ModelConfig, n_tokens: int,
                           ctx_start: int, units: int, *,
                           colocated: bool, oversub: float = 1.0) -> float:
        c = _prefill_cost(cfg, n_tokens, ctx_start, include_head=False)
        per_layer = self.kernel_time(
            c.flops / cfg.n_layers, c.hbm_bytes / cfg.n_layers, units,
            colocated=colocated, oversub=oversub,
            grid=max(1, math.ceil(n_tokens / 128) * max(cfg.n_heads, 1)))
        return per_layer * self._fb("prefill")

    def prefill_time(self, cfg: ModelConfig, n_tokens: int, units: int, *,
                     ctx_start: int = 0, colocated: bool = False,
                     oversub: float = 1.0) -> float:
        return self.prefill_layer_time(cfg, n_tokens, ctx_start, units,
                                       colocated=colocated,
                                       oversub=oversub) * cfg.n_layers

    def decode_iter_time(self, cfg: ModelConfig, batch: int, ctx: int,
                         units: int, *, colocated: bool = False,
                         oversub: float = 1.0,
                         contexts: Optional[Sequence[int]] = None,
                         page_size: Optional[int] = None) -> float:
        """One continuous-batching decode iteration. ``contexts`` charges
        summed per-slot live-context bytes (what the block-paged cache
        actually streams) instead of the ``batch × mean`` collapse;
        ``page_size`` adds the page-granularity round-up."""
        c = _decode_cost_any(cfg, batch, ctx, contexts, page_size)
        if contexts is not None:
            batch = len(contexts)
        t = self.kernel_time(c.flops, c.hbm_bytes, units,
                             colocated=colocated, oversub=oversub,
                             grid=max(1, batch * max(cfg.n_kv_heads, 1)))
        return t * self._fb("decode")

    def fused_cycle_time(self, cfg: ModelConfig, n_tokens: int,
                         prefill_units: int, decode_units: int,
                         batch: int, ctx: int, *,
                         contexts: Optional[Sequence[int]] = None,
                         page_size: Optional[int] = None,
                         layer_group: Optional[int] = None,
                         ctx_start: int = 0) -> float:
        """One fused engine cycle: Eq. 2's co-located
        ``max(prefill, decode)/(1-s)`` for a prefill layer group and a
        decode iteration sharing the device spatially — never the serial
        sum of two back-to-back dispatches.

        Resource units divide the SMs, so each phase's compute runs on its
        ``m_i`` share with Eq. 2's d_c decay and p_c contention, while the
        two phases' memory streams share one HBM pipe (the α_b→0 limit of
        Eq. 2's d_b, where only p_b survives): their bytes SUM on the
        bandwidth side. The formula is the JAX package's, unchanged, so
        both engines price a cycle alike for the same HardwareSpec. Wave
        quantization (Eq. 1) applies to the merged work-item grid.
        """
        lg = layer_group if layer_group is not None else len(cfg.pattern)
        if n_tokens <= 0 or batch <= 0:
            return self.serial_cycle_time(
                cfg, n_tokens, batch, ctx, contexts=contexts,
                page_size=page_size, layer_group=layer_group,
                ctx_start=ctx_start)
        U = self.hw.total_units
        u_p = max(1, min(prefill_units, U)) / U
        u_d = max(1, min(decode_units, U)) / U
        B = self.hw.total_bw * self.params.sustained_bw
        p_b = self.params.p_b

        cp = _prefill_cost(cfg, n_tokens, ctx_start, include_head=False)
        p_flops = cp.flops / cfg.n_layers * lg
        p_bytes = cp.hbm_bytes / cfg.n_layers * lg
        cd = _decode_cost_any(cfg, batch, max(ctx, 1), contexts, page_size)
        if contexts is not None:
            batch = len(contexts)

        # compute side: concurrent on disjoint slot shares -> max of the
        # phases' partitioned Eq. 2 compute terms
        t_c = max(self.colocated_compute_time(p_flops, u_p),
                  self.colocated_compute_time(cd.flops, u_d))
        # bandwidth side: one shared pipe -> the phases' bytes sum
        t_b = (p_bytes + cd.hbm_bytes) / (B * p_b)
        g_p = max(1, math.ceil(n_tokens / 128) * max(cfg.n_heads, 1))
        g_d = max(1, batch * max(cfg.n_kv_heads, 1))
        s = wave_quantization_idle(g_p + g_d,
                                   self.hw.grid_slots * self.hw.n_chips)
        t = max(t_c, t_b) / max(1.0 - s, 1e-2)
        return t * self._fb("fused")

    def serial_cycle_time(self, cfg: ModelConfig, n_tokens: int,
                          batch: int, ctx: int, *,
                          contexts: Optional[Sequence[int]] = None,
                          page_size: Optional[int] = None,
                          layer_group: Optional[int] = None,
                          ctx_start: int = 0) -> float:
        """Temporal-sharing reference for the same engine cycle: the
        prefill layer group and the decode iteration dispatched
        back-to-back, each alone on the full machine (no partition, no
        contention) — the serialized regime the fused path is measured
        against. SUM of the dispatches."""
        lg = layer_group if layer_group is not None else len(cfg.pattern)
        U = self.hw.total_units
        t = 0.0
        if n_tokens > 0:
            t += self.prefill_layer_time(cfg, n_tokens, ctx_start, U,
                                         colocated=False) * lg
        if batch > 0:
            t += self.decode_iter_time(cfg, batch, max(ctx, 1), U,
                                       colocated=False, contexts=contexts,
                                       page_size=page_size)
        return t

    def kv_handoff_time(self, cfg: ModelConfig, n_tokens: int,
                        dtype_bytes: int = 2) -> float:
        """Cross-mesh KV handoff charge: the K/V bytes written for
        ``n_tokens`` of finished prefill, re-sharded from the prefill
        sub-mesh onto the decode sub-mesh over the interconnect —
        ``bytes / ici_bw``. This is the term chip-granular entries pay
        instead of Eq. 2's co-location contention; the scheduler's
        combined-table argmin is exactly the handoff-vs-contention
        comparison (docs/PARTITIONS.md)."""
        if n_tokens <= 0:
            return 0.0
        return (A.kv_transfer_bytes(cfg, n_tokens, dtype_bytes)
                / max(self.hw.ici_bw, 1.0))

    def chip_cycle_time(self, cfg: ModelConfig, n_tokens: float,
                        prefill_units: int, decode_units: int,
                        batch: int, ctx: int, *,
                        contexts: Optional[Sequence[int]] = None,
                        page_size: Optional[int] = None,
                        layer_group: Optional[int] = None,
                        handoff_tokens: float = 0.0,
                        ctx_start: int = 0) -> float:
        """One chip-granular engine cycle: the prefill layer group and the
        decode iteration run concurrently on *disjoint* sub-meshes, so the
        cycle is the MAX of the two sides' partitioned Eq. 2 times with NO
        co-location contention (``colocated=False`` — neither p_c/p_b nor
        a shared HBM pipe applies across chips), plus the KV handoff
        charge for any prefill that finished and re-sharded its pages this
        cycle. The disaggregation-vs-sharing tradeoff in one line:
        ``max(p, d) + handoff`` vs the fused ``max(p, d)/(1-s)`` under
        contention."""
        lg = layer_group if layer_group is not None else len(cfg.pattern)
        t_p = t_d = 0.0
        if n_tokens > 0:
            t_p = self.prefill_layer_time(
                cfg, int(n_tokens), ctx_start, max(prefill_units, 1),
                colocated=False) * lg
        if batch > 0 or contexts:
            t_d = self.decode_iter_time(
                cfg, max(batch, 1), max(ctx, 1), max(decode_units, 1),
                colocated=False, contexts=contexts, page_size=page_size)
        return max(t_p, t_d) + self.kv_handoff_time(cfg, handoff_tokens)

    def lockstep_iter_time(self, cfg: ModelConfig,
                           prefill_parts: List[Tuple[int, int]],
                           ds: int, ctx_d: int, *,
                           overlap: bool = False) -> float:
        """One chunked-prefill hybrid-batch iteration (paper §2.3).

        Lock-step batches serialize the phase kinds per layer: GEMMs run
        compute-bound with bandwidth idle, then prefill attention, then
        decode attention runs bandwidth-bound with the MXU idle — the
        under-utilization Bullet's concurrent execution removes. Hence a
        SUM of phase times, not a max:

            t = max(gemm/C, weights/B) + max(attn_p/C, reload/B) + kv_d/B

        prefill_parts: [(chunk_tokens, ctx_start), ...]; ds decode tokens at
        mean context ctx_d. Full machine, no partitioning.
        """
        C = (self.hw.total_flops * self.params.sustained_compute)
        B = (self.hw.total_bw * self.params.sustained_bw)
        gemm = weights = attn_p = reload = kv_d = 0.0
        n_tok = ds
        for take, ctx0 in prefill_parts:
            c = A.prefill_cost(cfg, take, ctx0, include_head=False)
            gemm += c.gemm_flops
            attn_p += c.attn_flops
            reload += c.kv_bytes
            weights = max(weights, c.weight_bytes)   # weights read once
            n_tok += take
        if ds > 0:
            cd = A.decode_cost(cfg, ds, max(ctx_d, 1))
            gemm += cd.gemm_flops
            kv_d += cd.kv_bytes
            weights = max(weights, cd.weight_bytes)
        # wave quantization on the GEMM grid (small chunks hurt, Table 1)
        g = max(1, math.ceil(n_tok / 128) * max(cfg.n_heads, 1))
        g = max(g, self._grid_for(gemm))
        s = wave_quantization_idle(g, self.hw.grid_slots * self.hw.n_chips)
        if overlap:
            # NanoFlow-style nano-batch pipelining (paper §2.4 / Fig. 3b):
            # compute-, memory- and network-bound ops of different nano
            # batches overlap; the iteration approaches the overlapped
            # roofline at ~85% pipeline efficiency, but chunk-growth
            # attention still serializes at the pipeline tail.
            cs_tot = max(sum(t for t, _ in prefill_parts), 1)
            attn_eff = cs_tot / (cs_tot + 256.0)
            t = max((gemm + attn_p / attn_eff) / C,
                    (weights + reload + kv_d) / B) / 0.85
            return t * self._fb("lockstep")
        t_gemm = max(gemm / C, weights / B) / max(1.0 - s, 1e-2)
        # chunked attention kernels lose efficiency at small q-chunks
        # (paper Fig. 4: final/initial chunk latency 1.9x at cs=1k) — the
        # per-chunk startup/pipeline term modeled as cs/(cs + 256)
        cs_tot = max(sum(t for t, _ in prefill_parts), 1)
        attn_eff = cs_tot / (cs_tot + 256.0)
        t_attn = attn_p / (C * attn_eff) + reload / B
        t_dec = kv_d / B
        return (t_gemm + t_attn + t_dec) * self._fb("lockstep")

    # -- online feedback (§3.3.2: predicted-vs-observed correction) ---
    def _fb(self, key: str) -> float:
        """Multiplicative residual correction for one cycle kind.

        Every phase-level prediction is scaled by the feedback factor of
        its kind (``"prefill"``, ``"decode"``, ``"fused"``, ``"lockstep"``);
        1.0 (no entry) means no correction. This is the *cheap* half of the
        §3.3.2 loop — a scalar EMA that absorbs uniform model bias per
        kind. The *structural* half is :class:`OnlineRefitter`, which
        re-solves the Eq. 2 parameters themselves; the two should not run
        on the same observations (the refitter would chase a moving
        target), so the engine's refit path leaves ``feedback`` untouched.
        """
        return self.feedback.get(key, 1.0)

    def observe(self, key: str, predicted: float, actual: float,
                ema: float = 0.3):
        """Fold one predicted-vs-actual pair into the ``key`` feedback EMA.

        The stored factor converges to the steady-state actual/predicted
        ratio (each update multiplies the previous factor by the observed
        ratio, smoothed by ``ema``), so a consistently 2x-slow kind ends up
        charged 2x. Use this when only a scalar bias correction is wanted
        — e.g. static params pinned via ``BulletServer(refit=False)`` (see
        docs/TUNING.md); :class:`OnlineRefitter` supersedes it when live
        refitting is enabled.
        """
        if predicted <= 0 or actual <= 0:
            return
        ratio = actual / predicted
        prev = self.feedback.get(key, 1.0)
        self.feedback[key] = (1 - ema) * prev + ema * prev * ratio

    def with_params(self, params: EstimatorParams) -> "PerfEstimator":
        """A new estimator with ``params`` swapped in (same hardware,
        feedback copied). This is the refit hand-over point: the engine
        replaces its own and its scheduler's estimator reference with the
        returned object, so in-flight predictions keep the old params and
        every later scheduling cycle sees the refit ones — no estimator is
        ever mutated mid-decision."""
        return PerfEstimator(self.hw, params, dict(self.feedback))


@dataclass(frozen=True)
class ProfileSample:
    """One offline profiling measurement (§3.2.2 5-tuple)."""
    sl: int          # prefill sequence length (0 = decode-only)
    bs: int          # decode batch size (0 = prefill-only)
    cl: int          # mean context length in decode batch
    pm: int          # units allocated to prefill
    dm: int          # units allocated to decode
    t_prefill: float
    t_decode: float


#: fit/refit search space: the 6 Eq. 2 parameters with physical bounds
#: (alpha_c >= 1: compute scales sub-linearly with the partition; alpha_b
#: <= 1: bandwidth super-linearly; p/sustained are fractions of peak).
#: Shared by the offline fit_params sweep and the OnlineRefitter.
PARAM_FIELDS = ("alpha_c", "alpha_b", "p_c", "p_b",
                "sustained_compute", "sustained_bw")
PARAM_BOUNDS = {"alpha_c": (1.0, 1.6), "alpha_b": (0.5, 1.0),
                "p_c": (0.5, 1.0), "p_b": (0.5, 1.0),
                "sustained_compute": (0.4, 1.0), "sustained_bw": (0.4, 1.0)}


def _coordinate_descent(loss, start: EstimatorParams, *, iters: int,
                        fields: Sequence[str] = PARAM_FIELDS,
                        step0: float = 0.1,
                        clamp=None) -> Tuple[EstimatorParams, float]:
    """Shared fit/refit solver: greedy per-field moves with halving steps.
    ``clamp(field, value)`` optionally restricts each candidate further
    (the refitter's per-refit movement bound)."""
    cur = start
    cur_loss = loss(cur)
    step = {f: step0 for f in fields}
    for _ in range(iters):
        improved = False
        for f in fields:
            for sgn in (+1, -1):
                lo, hi = PARAM_BOUNDS[f]
                cand_v = min(hi, max(lo, getattr(cur, f) + sgn * step[f]))
                if clamp is not None:
                    cand_v = clamp(f, cand_v)
                cand = replace(cur, **{f: cand_v})
                l2 = loss(cand)
                if l2 < cur_loss - 1e-9:
                    cur, cur_loss = cand, l2
                    improved = True
        if not improved:
            for f in fields:
                step[f] *= 0.5
            if max(step.values()) < 1e-3:
                break
    return cur, cur_loss


def fit_params(samples: List[ProfileSample], cfg: ModelConfig,
               hw: HardwareSpec, *, iters: int = 60) -> EstimatorParams:
    """Coordinate-descent least squares over the 6 estimator parameters
    (numpy only; the sample count ~12k mirrors the paper's sweep)."""
    base = EstimatorParams()
    est = PerfEstimator(hw, base)

    def loss(p: EstimatorParams) -> float:
        e = PerfEstimator(hw, p)
        err = 0.0
        n = 0
        for s in samples:
            co = s.sl > 0 and s.bs > 0
            if s.sl > 0 and s.t_prefill > 0:
                pred = e.prefill_time(cfg, s.sl, s.pm, colocated=co)
                err += (math.log(pred) - math.log(s.t_prefill)) ** 2
                n += 1
            if s.bs > 0 and s.t_decode > 0:
                pred = e.decode_iter_time(cfg, s.bs, s.cl, s.dm, colocated=co)
                err += (math.log(pred) - math.log(s.t_decode)) ** 2
                n += 1
        return err / max(n, 1)

    cur, _ = _coordinate_descent(loss, base, iters=iters)
    return cur


# ---------------------------------------------------------------------------
# Online refit (closing the §3.2.2 loop on live serving cycles)
# ---------------------------------------------------------------------------

class CycleObservation(NamedTuple):
    """What one engine cycle executed — enough to re-predict its duration
    under *any* candidate ``EstimatorParams`` (the refit loss re-evaluates
    the whole window per candidate, so features, not predictions, are
    stored).

    ``kind`` selects the charging model: ``"fused"`` cycles are charged
    Eq. 2's co-located max (``fused_cycle_time``), ``"serial"`` cycles the
    full-machine sum of their dispatches (``serial_cycle_time``), and
    ``"chip"`` cycles the disjoint-sub-mesh max plus the KV handoff charge
    (``chip_cycle_time``; ``handoff_tokens`` > 0 on the cycle whose
    finished prefill re-sharded its pages across the interconnect).
    ``contexts`` carries the per-slot KV tokens the decode side actually
    streamed (page-bucketed), exactly what virtual-clock replay charges.
    ``reused_tokens`` counts shared-prefix KV tokens mapped instead of
    prefilled (docs/KV_SHARING.md): ``n_tokens`` is the suffix the cycle
    actually computed, and the reused span enters the prefill charge only
    as the attention-context start offset (``ctx_start``).
    """
    kind: str                             # "fused" | "serial" | "chip"
    n_tokens: int                         # prefill tokens this cycle (0 = none)
    prefill_units: int
    decode_units: int
    batch: int                            # decode slots that ran (0 = none)
    ctx: int                              # mean live context of the batch
    contexts: Optional[Tuple[int, ...]] = None   # streamed KV tokens per slot
    layer_group: Optional[int] = None     # layers launched (None = pattern)
    handoff_tokens: int = 0               # KV tokens re-sharded cross-mesh
    reused_tokens: int = 0                # prefix KV tokens reused, not computed


def predict_cycle(est: PerfEstimator, cfg: ModelConfig,
                  obs: CycleObservation) -> float:
    """Predicted duration (s) of ``obs`` under ``est`` — the single
    charging rule shared by virtual-clock replay, the refit loss, and the
    surrogate oracle, so all three always price the same cycle the same
    way (refit-consistent replay costs)."""
    if obs.kind == "fused":
        return est.fused_cycle_time(
            cfg, obs.n_tokens, max(obs.prefill_units, 1),
            max(obs.decode_units, 1), max(obs.batch, 1), max(obs.ctx, 1),
            contexts=obs.contexts, layer_group=obs.layer_group,
            ctx_start=obs.reused_tokens)
    if obs.kind == "chip":
        return est.chip_cycle_time(
            cfg, obs.n_tokens, max(obs.prefill_units, 1),
            max(obs.decode_units, 1), obs.batch, max(obs.ctx, 1),
            contexts=obs.contexts, layer_group=obs.layer_group,
            handoff_tokens=obs.handoff_tokens,
            ctx_start=obs.reused_tokens)
    return est.serial_cycle_time(
        cfg, obs.n_tokens, obs.batch, max(obs.ctx, 1),
        contexts=obs.contexts, layer_group=obs.layer_group,
        ctx_start=obs.reused_tokens)


class OnlineRefitter:
    """Sliding-window re-fit of the Eq. 2 parameters from live cycles.

    The offline profile fit (§3.2.2) happens once, on surrogate or
    pre-deployment measurements; under real traffic the contention terms
    drift (co-location mixes, page-bucketed KV traffic, thermal/SMEM
    effects the sweep never saw). The refitter closes the loop:

    1. ``observe(obs, actual)`` appends one executed cycle and its
       measured duration to a bounded window (``window`` cycles,
       newest-wins).
    2. ``refit()`` — called by the engine every ``refit_interval`` cycles
       — re-solves the parameters by the same coordinate-descent
       log-least-squares ``fit_params`` uses, but over the live window,
       warm-started from the current params.

    Three guards keep a few noisy cycles from destabilizing serving (see
    docs/TUNING.md for how to size them):

    - **min_samples** — no refit until the window holds enough cycles to
      constrain all six parameters.
    - **hysteresis** (``improve_tol``) — the candidate params are adopted
      only if they cut the window loss by more than this relative margin;
      pure measurement noise (whose optimum hovers near the current
      params) is rejected and the params hold still.
    - **step clamp** (``max_step``) — each accepted refit may move a
      parameter at most this far from its current value, so even a
      pathological window (e.g. a burst of preemption-mangled cycles)
      only nudges the model, and sustained drift is absorbed over several
      refits. PARAM_BOUNDS applies on top, as in the offline fit.

    The refitter never mutates the estimator it reads: the engine swaps
    the returned params in via :meth:`PerfEstimator.with_params`.
    """

    def __init__(self, cfg: ModelConfig, est: PerfEstimator, *,
                 window: int = 192, min_samples: int = 24,
                 improve_tol: float = 0.05, max_step: float = 0.2,
                 min_loss: float = 4e-3, iters: int = 12):
        self.cfg = cfg
        self.est = est
        self.window: Deque[Tuple[CycleObservation, float]] = deque(
            maxlen=window)
        self.min_samples = min_samples
        self.improve_tol = improve_tol
        self.max_step = max_step
        #: measurement-noise floor: when the window's mean squared log
        #: error is already below this, hold the params and skip the
        #: search entirely (4e-3 ~= the 6% lognormal noise of the
        #: surrogate profiler; raise it for noisier hardware clocks)
        self.min_loss = min_loss
        self.iters = iters
        self.refits_applied = 0
        self.refits_rejected = 0
        self.last_loss: Optional[float] = None

    def observe(self, obs: CycleObservation, actual: float) -> None:
        """Record one executed cycle and its measured duration (s)."""
        if actual > 0 and (obs.n_tokens > 0 or obs.batch > 0):
            self.window.append((obs, actual))

    def _loss(self, params: EstimatorParams) -> float:
        e = self.est.with_params(params)
        err = 0.0
        for obs, actual in self.window:
            pred = predict_cycle(e, self.cfg, obs)
            if pred > 0:
                err += (math.log(pred) - math.log(actual)) ** 2
        return err / max(len(self.window), 1)

    def refit(self) -> Optional[EstimatorParams]:
        """Re-solve the params on the current window; returns the new
        params iff they beat the current ones by the hysteresis margin,
        else None (caller keeps serving on the old params)."""
        if len(self.window) < self.min_samples:
            return None
        cur = self.est.params
        cur_loss = self._loss(cur)
        self.last_loss = cur_loss
        if cur_loss < self.min_loss:   # at the noise floor: hold
            return None

        def clamp(f: str, v: float) -> float:
            c = getattr(cur, f)
            return min(c + self.max_step, max(c - self.max_step, v))

        cand, cand_loss = _coordinate_descent(
            self._loss, cur, iters=self.iters, step0=0.05, clamp=clamp)
        if cand_loss < (1.0 - self.improve_tol) * cur_loss:
            self.refits_applied += 1
            return cand
        self.refits_rejected += 1
        return None
