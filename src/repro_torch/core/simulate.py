"""Estimator-driven discrete-event serving simulator: the port's copy of
the JAX package's ``core/simulate.py``, logic unchanged.

Runs Bullet and the chunked-prefill / static-partition / naive baselines on
identical workload traces, priced with the port's
:class:`repro_torch.core.estimator.HardwareSpec` (one H100: data-sheet
peaks, one resource unit per SM, the SM count read from the card where
one is present) — the evaluation harness behind the paper's Figs. 11-14.
The same PerfEstimator the Bullet scheduler uses for decisions drives the
simulation clock, with the *hidden surrogate* parameters as ground truth,
so scheduling decisions are made with the fitted (imperfect) model against
"real" (surrogate) durations — exactly the paper's estimation-error regime.
The simulated times are the estimator's prices, not measurements of a card.

The ``bullet`` systems simulate the engine's *actual* control plane:

- every cycle is one fused / serial / chip engine cycle priced through the
  ONE :func:`repro_torch.core.estimator.predict_cycle` charging rule (Eq. 2
  co-located max, full-machine sum, or disjoint-sub-mesh max + handoff),
  with ``ctx_start`` suffix pricing for shared-prefix cache hits;
- the scheduler is the live :class:`repro_torch.core.scheduler.SLOScheduler`
  given the same pre-built :class:`repro_torch.core.resource.ResourceManager`
  partition table the engine builds its fused launchers for
  (``split_candidates`` + combined tile/chip ``partition_table``), so the
  split search is the fused-objective table argmin, never a
  re-implementation; on the H100 the table holds one entry per quantized
  SM share;
- an :class:`repro_torch.core.estimator.OnlineRefitter` closes the loop
  against the hidden :class:`repro_torch.core.profiler.SurrogateMachine`
  truth, so the simulated system exhibits the same
  estimation-error-then-convergence regime as the live engine
  (docs/SIMULATOR.md).

The single-replica state machine is :class:`BulletReplicaSim`; the
fleet-scale event-driven cluster simulation in ``repro_torch.sim.cluster``
drives N of them behind a router (docs/SIMULATOR.md).

Systems:
  bullet        — concurrent phases, SLO scheduler, dynamic partitions,
                  online refit (the adaptive system the paper measures)
  bullet-fixN   — static partition of N prefill units, SMs on the H100
                  (paper Fig. 13)
  bullet-nosched— partitioning but FCFS, no reorder/pause (Fig. 14 w/Part.)
  bullet-nopart — scheduler but full-GPU contention (Fig. 14 w/Sched.)
  naive         — concurrent, no partitioning, no scheduling (Fig. 14)
  chunked-N     — chunked prefill with token budget N (vLLM/SGLang-style)
  nanoflow-N    — chunked with nano-batch pipeline overlap (paper §2.4)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.estimator import (CycleObservation, HardwareSpec,
                                        OnlineRefitter, PerfEstimator,
                                        predict_cycle)
from repro_torch.core.metadata import ResourceStatus, SystemState
from repro_torch.core.profiler import SurrogateMachine
from repro_torch.core.resource import ResourceManager
from repro_torch.core.scheduler import SchedulerConfig, SLOScheduler
from repro_torch.serving.request import Phase, Request, ServingMetrics, SLO


@dataclass
class SimConfig:
    model: ModelConfig
    hw: HardwareSpec
    slo: SLO
    kv_budget_tokens: int = 400_000
    max_decode_batch: int = 256
    max_prefill_tokens: int = 8192      # prefill engine batch cap (n_p)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    #: online estimator refit against the surrogate truth (bullet only);
    #: False pins the fitted params for the whole run
    refit: bool = True
    #: cycles between refit attempts (the engine's refit_interval analogue;
    #: each attempt at the noise floor costs one window loss evaluation)
    refit_interval: int = 64
    #: chip-granular (prefill_chips, decode_chips) sub-mesh splits to add
    #: to the partition table; None = tile-only (docs/PARTITIONS.md)
    chip_splits: Optional[Tuple[Tuple[int, int], ...]] = None
    #: model shared-prefix KV reuse: a turn whose session already finished
    #: a turn on this replica prefills only the unshared suffix, with the
    #: reused span priced as the attention ctx_start (docs/KV_SHARING.md)
    share_prefix: bool = True
    #: run the scheduler every k-th cycle while a prefill batch is
    #: resident (1 = every cycle, the engine's behavior; the fleet
    #: simulator raises it to trade fidelity for replay speed —
    #: docs/SIMULATOR.md). Batch admission always schedules, and pure
    #: decode-only cycles (no prefill resident or pending) never do —
    #: their decision is trivially decode-exclusive.
    sched_every: int = 1
    #: cap on how many pending requests are handed to the scheduler's
    #: TTFT-projection/reorder pass per cycle (0 = all, the engine's
    #: behavior). Scheduling cost is O(pending); under fleet-scale
    #: backlogs only the queue head is admissible anyway, so the fleet
    #: level caps this (docs/SIMULATOR.md)
    sched_pending_cap: int = 0


@dataclass
class SimLogEntry:
    t: float
    prefill_units: int
    decode_units: int
    n_decode: int
    n_waiting: int
    prefill_tokens: int


class BulletReplicaSim:
    """One simulated Bullet instance as a resumable cycle state machine.

    Mirrors ``BulletServer``'s control plane without device work: the
    partition table comes from the same :class:`ResourceManager`
    constructors the engine pre-builds executables for, scheduling is the
    live :class:`SLOScheduler` fused-objective search over exactly that
    table, every executed cycle is charged through
    :func:`predict_cycle` (prediction, under the replica's current fitted
    params) and :meth:`SurrogateMachine.measure_cycle` (hidden-truth
    actual), and an :class:`OnlineRefitter` re-solves the params from the
    live (observation, actual) window.

    Drive it either in batch (``ServingSimulator.run``) or event-driven
    (``repro_torch.sim.cluster``): ``submit()`` enqueues work at any time, and
    ``run_cycle(now)`` executes exactly one engine cycle starting at
    ``now``, returning ``(t_end, finished_requests)``.
    """

    def __init__(self, sim: SimConfig, est: PerfEstimator,
                 truth: SurrogateMachine, system: str = "bullet", *,
                 replica_id: int = 0):
        self.sim = sim
        self.cfg = sim.model
        self.est = est                      # what the scheduler believes
        self.truth = truth                  # what "actually" happens
        self.system = system
        self.replica_id = replica_id

        sys_ = system
        self.dynamic = sys_ == "bullet"
        self.sched_on = sys_ == "bullet"
        self.fixed_units: Optional[int] = None
        if sys_.startswith("bullet-fix"):
            self.fixed_units = int(sys_.replace("bullet-fix", ""))

        chip_splits = list(sim.chip_splits or ())
        self.rm = ResourceManager(sim.hw, sim.scheduler.unit_quantum,
                                  chip_splits=chip_splits)
        self.scheduler = SLOScheduler(self.cfg, est, sim.slo, sim.scheduler)
        # the sim must schedule over exactly the engine's table — never a
        # private re-quantization (the drift sim/replay_vs_sim.py's gate
        # fails loudly on)
        self.scheduler.split_candidates = [
            (p.prefill_units, p.decode_units) for p in self.rm.tile_entries]
        if self.rm.chip_entries:
            self.scheduler.partition_table = self.rm.partitions

        self.refitter: Optional[OnlineRefitter] = None
        if sim.refit and self.dynamic:
            self.refitter = OnlineRefitter(self.cfg, est)
        self._obs_since_refit = 0
        self.refits_applied = 0
        self.refit_log: List[int] = []

        self.state = SystemState()
        U = sim.hw.total_units
        if self.fixed_units is not None:
            init = ResourceStatus(self.fixed_units, U - self.fixed_units)
        else:
            init = ResourceStatus(U // 2, U - U // 2)
        self.state.resources = self.rm.switch(init).status()
        self._decode_only = self.rm.nearest(ResourceStatus(0, U)).status()

        self.pending: List[Request] = []
        self.decoding: List[Request] = []
        self.active: List[Request] = []      # prefill batch
        self.active_tokens = 0               # suffix tokens (computed)
        self.active_reused = 0               # shared-prefix tokens mapped
        self.active_layer = 0
        self.granularity = "tile"            # pinned per prefill batch
        self.pause_decode = False
        self.kv_tokens = 0
        #: session_id -> KV tokens resident from a finished turn (the
        #: radix-index stand-in; cold after a replica failure)
        self.prefix_cache: Dict[int, int] = {}
        self.cycles = 0
        self.reused_prefill_tokens = 0
        self.pred_actual: List[Tuple[str, float, float]] = []
        self.log: List[SimLogEntry] = []

    # -- queue interface (router-facing) -------------------------------
    def submit(self, req: Request, now: float) -> None:
        del now
        self.pending.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.pending or self.active or self.decoding)

    def kv_pressure(self) -> int:
        """Live + committed KV tokens — the least-KV router's load signal."""
        live = self.kv_tokens + self.active_tokens + self.active_reused
        queued = sum(r.prompt_len + r.output_len for r in self.pending)
        return live + queued

    def drain(self) -> List[Request]:
        """Remove every unfinished request (replica failure): queued and
        in-flight work is returned for re-routing with prefill/decode
        progress lost, and the prefix cache goes cold."""
        out = []
        for r in self.pending + self.active + self.decoding:
            r.phase = Phase.QUEUED
            r.prefill_start = None
            r.first_token_time = None
            r.generated = 0
            r.prefill_done_layers = 0
            r.token_times.clear()
            out.append(r)
        self.pending, self.active, self.decoding = [], [], []
        self.active_tokens = self.active_reused = self.active_layer = 0
        self.kv_tokens = 0
        self.prefix_cache.clear()
        self.state.decode.batch = []
        self.state.decode.out_tokens.clear()
        self.state.decode.decode_time.clear()
        return out

    # -- scheduling -----------------------------------------------------
    def _sync_state(self, now: float) -> None:
        P, D = self.state.prefill, self.state.decode
        P.active_rid = self.active[0].rid if self.active else None
        P.layers_done = self.active_layer
        P.total_layers = self.cfg.n_layers
        P.n_tokens = self.active_tokens
        P.started_at = (self.active[0].prefill_start
                        if self.active else now)
        P.n_waiting = len(self.pending)
        D.batch = [r.rid for r in self.decoding]
        D.ctx_tokens = int(sum(r.prompt_len + r.generated
                               for r in self.decoding))
        D.mean_context = (int(D.ctx_tokens / len(self.decoding))
                          if self.decoding else 0)
        D.paused = self.pause_decode
        for r in self.decoding:
            D.out_tokens[r.rid] = r.generated
            # wall-clock decode time (pauses included) so the scheduler's
            # cumulative-TPOT projections are honest
            D.decode_time[r.rid] = max(
                0.0, now - (r.first_token_time or now))

    def _run_scheduler(self, now: float) -> None:
        self._sync_state(now)
        if not self.sched_on:
            self.pause_decode = False
            return
        cap = self.sim.sched_pending_cap
        head = self.pending if cap <= 0 else self.pending[:cap]
        d = self.scheduler.schedule(
            self.state, now,
            [(r.rid, r.arrival, r.prompt_len) for r in head],
            granularity=self.granularity if self.active else None)
        if self.dynamic:
            assert self.rm.on_table(d.resources), (
                "simulator decision off the engine partition table: "
                f"{d.resources}")
            self.state.resources = self.rm.switch(d.resources).status()
        self.pause_decode = d.pause_decode
        if d.reorder:
            # capped pass: the reorder names only the head; tail keeps its
            # FCFS order behind it (stable sort, unnamed rids sink)
            order = {rid: i for i, rid in enumerate(d.reorder)}
            self.pending.sort(key=lambda r: order.get(r.rid, 1e9))

    def _admit_batch(self, now: float) -> bool:
        """Form a new prefill batch from the (reordered) pending queue,
        mapping shared-prefix hits to suffix-only computed spans."""
        if self.active or not self.pending:
            return False
        sp = self.sim.share_prefix
        while self.pending:
            r = self.pending[0]
            reused = 0
            if sp and r.session_id is not None:
                cached = self.prefix_cache.get(r.session_id, 0)
                reused = max(0, min(cached, r.prompt_len - 1))
            suffix = r.prompt_len - reused
            if self.active and (
                    self.active_tokens + suffix > self.sim.max_prefill_tokens
                    or len(self.decoding) + len(self.active) + 1
                    > self.sim.max_decode_batch):
                break
            if (self.kv_tokens + self.active_tokens + self.active_reused
                    + r.prompt_len + r.output_len
                    > self.sim.kv_budget_tokens and self.active):
                break
            self.pending.pop(0)
            r.phase = Phase.PREFILL
            r.prefill_start = now
            self.state.prefill.queue_wait[r.rid] = now - r.arrival
            # homogeneous batching: the engine groups hit/miss prefills
            # separately; the sim folds the batch's reused spans into one
            # ctx_start offset, so mixed batches stay suffix-honest
            self.active.append(r)
            self.active_tokens += suffix
            self.active_reused += reused
            self.reused_prefill_tokens += reused
            if len(self.decoding) + len(self.active) \
                    >= self.sim.max_decode_batch:
                break
        self.active_layer = 0
        if self.active and self.rm.chip_entries and self.sched_on:
            # granularity pinned per prefill batch at admission, exactly
            # like the engine's _admit_prefill under partition="auto"
            self._sync_state(now)
            self.granularity = self.scheduler.preferred_granularity(
                self.state)
        return bool(self.active)

    # -- one engine cycle -----------------------------------------------
    def _lg_layers(self) -> int:
        return self.sim.scheduler.layer_group * len(self.cfg.pattern)

    def _compose_observation(self) -> Optional[CycleObservation]:
        lg = self._lg_layers()
        n_tok = self.active_tokens if self.active else 0
        batch = 0 if self.pause_decode else len(self.decoding)
        ctx = (max(1, int(sum(r.prompt_len + r.generated
                              for r in self.decoding) / len(self.decoding)))
               if self.decoding else 1)
        if n_tok <= 0 and batch <= 0:
            return None
        R = self.state.resources
        chip = (self.granularity == "chip" and self.active
                and R.granularity == "chip")
        if chip:
            final = self.active_layer + lg >= self.cfg.n_layers
            return CycleObservation(
                "chip", n_tok, max(R.prefill_units, 1),
                max(R.decode_units, 1), batch, ctx, layer_group=lg,
                handoff_tokens=n_tok if final else 0,
                reused_tokens=self.active_reused)
        fused = self.sim.scheduler.fused and n_tok > 0 and batch > 0
        kind = "fused" if fused else "serial"
        return CycleObservation(
            kind, n_tok, max(R.prefill_units, 1), max(R.decode_units, 1),
            batch, ctx, layer_group=lg, reused_tokens=self.active_reused)

    def _maybe_refit(self) -> None:
        if (self.refitter is None
                or self._obs_since_refit < self.sim.refit_interval):
            return
        self._obs_since_refit = 0
        new = self.refitter.refit()
        if new is not None:
            self.est = self.est.with_params(new)
            self.scheduler.est = self.est
            self.refitter.est = self.est
            self.refits_applied += 1
            self.refit_log.append(len(self.pred_actual))

    def run_cycle(self, now: float, *, log_timeline: bool = False
                  ) -> Tuple[float, List[Request]]:
        """Execute one engine cycle starting at ``now``. Returns the cycle
        end time (``now`` + the surrogate-truth duration) and the requests
        that finished during it. No-op (zero-duration) when idle."""
        self._maybe_refit()
        self.cycles += 1
        if self.active:
            if self.cycles % max(self.sim.sched_every, 1) == 0:
                self._run_scheduler(now)
        elif self.pending:
            self._run_scheduler(now)       # reorder before admission
        else:
            # pure decode: the decision is trivially decode-exclusive —
            # skip the O(pending)+Algorithm-2 work the engine would also
            # short-circuit to "decode_only"
            self.pause_decode = False
            if self.dynamic:
                self.state.resources = self._decode_only
        if self._admit_batch(now):
            # partition for the fresh batch (the engine schedules with the
            # task resident; without this the batch would launch on the
            # previous, possibly decode-only, split)
            self._run_scheduler(now)
        obs = self._compose_observation()
        if obs is None:
            return now, []

        pred = predict_cycle(self.est, self.cfg, obs)
        actual = self.truth.measure_cycle(self.cfg, obs)
        self.pred_actual.append((obs.kind, pred, actual))
        if self.refitter is not None:
            self.refitter.observe(obs, actual)
            self._obs_since_refit += 1
        t_end = now + actual

        finished: List[Request] = []
        # decode side: every slot resident at cycle start emits one token
        if obs.batch > 0:
            for r in list(self.decoding):
                r.generated += 1
                r.token_times.append(t_end)
                self.kv_tokens += 1
                if r.generated >= r.output_len:
                    r.phase = Phase.FINISHED
                    r.finish_time = t_end
                    self.decoding.remove(r)
                    self.kv_tokens -= r.prompt_len + r.generated
                    if r.session_id is not None and self.sim.share_prefix:
                        self.prefix_cache[r.session_id] = (
                            r.prompt_len + r.generated)
                    finished.append(r)
        # prefill side: one layer group
        if obs.n_tokens > 0:
            self.active_layer += self._lg_layers()
            if self.active_layer >= self.cfg.n_layers:
                for r in self.active:
                    r.phase = Phase.DECODE
                    r.first_token_time = t_end
                    r.generated = 1
                    r.token_times.append(t_end)
                    self.kv_tokens += r.prompt_len + 1
                    self.decoding.append(r)
                    self.state.decode.decode_time[r.rid] = 0.0
                self.active = []
                self.active_tokens = self.active_reused = 0
                self.active_layer = 0
                self.granularity = "tile"
        if log_timeline:
            self.log.append(SimLogEntry(
                t_end, self.state.resources.prefill_units,
                self.state.resources.decode_units, len(self.decoding),
                len(self.pending), self.active_tokens))
        return t_end, finished


class ServingSimulator:
    def __init__(self, sim: SimConfig, est: PerfEstimator,
                 truth: SurrogateMachine, system: str = "bullet"):
        self.sim = sim
        self.est = est                       # what the scheduler believes
        self.truth = truth                   # what "actually" happens
        self.system = system
        self.log: List[SimLogEntry] = []
        self.pred_actual: List[Tuple[str, float, float]] = []
        #: the single-replica state machine the bullet systems ran on
        #: (None for chunked/nanoflow/unpartitioned baselines)
        self.replica: Optional[BulletReplicaSim] = None

    # ------------------------------------------------------------------
    def run(self, trace: List[Request], *, log_timeline: bool = False,
            max_time: float = 1e9) -> ServingMetrics:
        if self.system.startswith("chunked"):
            budget = int(self.system.split("-")[1])
            self._run_chunked(trace, budget, max_time)
        elif self.system.startswith("nanoflow"):
            budget = int(self.system.split("-")[1])
            self._run_chunked(trace, budget, max_time, overlap=True)
        elif self.system in ("naive", "bullet-nopart"):
            self._run_unpartitioned(trace, max_time, log_timeline)
        else:
            self._run_cycles(trace, max_time, log_timeline)
        return ServingMetrics.from_requests(trace, self.sim.slo)

    # ------------------------------------------------------------------
    # Bullet and its partitioned ablations: the real control plane
    # ------------------------------------------------------------------
    def _run_cycles(self, trace: List[Request], max_time: float,
                    log_timeline: bool):
        """Cycle-granular loop over :class:`BulletReplicaSim`: each event
        is one fused/serial/chip engine cycle priced by predict_cycle
        against surrogate truth, with the scheduler re-deciding the
        partition from the engine's own table every cycle."""
        rep = BulletReplicaSim(self.sim, self.est, self.truth, self.system)
        self.replica = rep
        arrivals = sorted(trace, key=lambda r: r.arrival)
        ai = 0
        t = 0.0
        steps = 0
        while True:
            steps += 1
            if steps > 5_000_000:
                raise RuntimeError("simulator runaway")
            while ai < len(arrivals) and arrivals[ai].arrival <= t:
                rep.submit(arrivals[ai], t)
                ai += 1
            if not rep.has_work:
                if ai >= len(arrivals):
                    break
                t = arrivals[ai].arrival
                continue
            if t > max_time:
                break
            t2, _ = rep.run_cycle(t, log_timeline=log_timeline)
            # idle cycle (e.g. decode paused with nothing to prefill):
            # jump to the next arrival so time always advances
            if t2 <= t and ai < len(arrivals):
                t = arrivals[ai].arrival
            elif t2 <= t:
                break
            else:
                t = t2
        self.pred_actual = rep.pred_actual
        self.log = rep.log
        for r in trace:
            if r.phase != Phase.FINISHED and r.first_token_time is not None:
                r.finish_time = t
                r.phase = Phase.FINISHED
            elif r.phase != Phase.FINISHED:
                pass   # never started — dropped at max_time

    # ------------------------------------------------------------------
    # Unpartitioned concurrency (naive / bullet-nopart, Fig. 14)
    # ------------------------------------------------------------------
    def _run_unpartitioned(self, trace: List[Request], max_time: float,
                           log_timeline: bool):
        """Two-engine discrete-event loop for the full-GPU-contention
        regimes predict_cycle deliberately has no vocabulary for: both
        phases claim the whole machine and time-share it (oversub = 2),
        the MuxServe-style unmanaged co-location of paper Fig. 14. The
        partitioned systems run through :class:`BulletReplicaSim`.
        """
        cfg, hw, slo = self.sim.model, self.sim.hw, self.sim.slo
        sched_on = self.system == "bullet-nopart"
        scheduler = SLOScheduler(cfg, self.est, slo, self.sim.scheduler)
        state = SystemState()
        U = hw.total_units
        state.resources = ResourceStatus(U, U)

        pending: List[Request] = []
        decoding: List[Request] = []
        arrivals = sorted(trace, key=lambda r: r.arrival)
        ai = 0
        t = 0.0
        active: List[Request] = []           # prefill batch (n_p = sum lens)
        active_tokens = 0
        active_layer = 0
        pf_end: Optional[float] = None
        dec_end: Optional[float] = None
        dec_started: float = 0.0
        pause_decode = False
        steps = 0

        def admit(now):
            nonlocal ai
            while ai < len(arrivals) and arrivals[ai].arrival <= now:
                pending.append(arrivals[ai])
                ai += 1

        def sync_state(now):
            P, D = state.prefill, state.decode
            P.active_rid = active[0].rid if active else None
            P.layers_done = active_layer
            P.total_layers = cfg.n_layers
            P.n_tokens = active_tokens
            P.started_at = active[0].prefill_start if active else now
            P.n_waiting = len(pending)
            D.batch = [r.rid for r in decoding]
            D.ctx_tokens = int(sum(r.prompt_len + r.generated
                                   for r in decoding))
            D.mean_context = (int(D.ctx_tokens / len(decoding))
                              if decoding else 0)
            for r in decoding:
                D.out_tokens[r.rid] = r.generated
                D.decode_time[r.rid] = max(
                    0.0, now - (r.first_token_time or now))

        def run_cycle(now):
            nonlocal pause_decode
            sync_state(now)
            if not sched_on:
                return
            d = scheduler.schedule(
                state, now, [(r.rid, r.arrival, r.prompt_len)
                             for r in pending])
            state.resources = ResourceStatus(U, U)
            pause_decode = d.pause_decode
            if d.reorder:
                order = {rid: i for i, rid in enumerate(d.reorder)}
                pending.sort(key=lambda r: order.get(r.rid, 1e9))

        while True:
            steps += 1
            if steps > 5_000_000:
                raise RuntimeError("simulator runaway")
            admit(t)
            if (ai >= len(arrivals) and not active and not pending
                    and not decoding):
                break
            if t > max_time:
                break

            colocated = bool(active) and len(decoding) > 0

            # launch prefill layer group if engine idle
            if pf_end is None:
                if not active and pending:
                    run_cycle(t)
                    while (pending and (not active or
                           active_tokens + pending[0].prompt_len
                           <= self.sim.max_prefill_tokens)):
                        r = pending.pop(0)
                        r.phase = Phase.PREFILL
                        r.prefill_start = t
                        state.prefill.queue_wait[r.rid] = t - r.arrival
                        active.append(r)
                        active_tokens += r.prompt_len
                    active_layer = 0
                    colocated = len(decoding) > 0
                if active:
                    osub = 2.0 if colocated else 1.0
                    lg = self.sim.scheduler.layer_group
                    dur = self.truth.measure_prefill(
                        cfg, active_tokens, U, colocated=colocated,
                        oversub=osub) / cfg.n_layers * lg
                    pred = self.est.prefill_layer_time(
                        cfg, active_tokens, 0, U,
                        colocated=colocated, oversub=osub) * lg
                    self.pred_actual.append(("prefill", pred, dur))
                    pf_end = t + dur

            # launch decode iteration if engine idle
            if dec_end is None and decoding and not pause_decode:
                osub = 2.0 if colocated else 1.0
                # pred and truth must use the same batch×mean formula:
                # the surrogate machine is mean-based, so passing exact
                # per-slot contexts here would bake a formula mismatch
                # into the pred/actual pairs (estimator-accuracy figs)
                ctx = max(1, int(sum(r.prompt_len + r.generated
                                     for r in decoding) / len(decoding)))
                dur = self.truth.measure_decode(
                    cfg, len(decoding), ctx, U,
                    colocated=colocated, oversub=osub)
                pred = self.est.decode_iter_time(
                    cfg, len(decoding), ctx, U,
                    colocated=colocated, oversub=osub)
                self.pred_actual.append(("decode", pred, dur))
                dec_end = t + dur
                dec_started = t

            events = [e for e in (pf_end, dec_end) if e is not None]
            if ai < len(arrivals):
                events.append(arrivals[ai].arrival)
            if not events:
                break
            t = min(events)

            if pf_end is not None and t >= pf_end - 1e-15:
                pf_end = None
                active_layer += self.sim.scheduler.layer_group
                if active and active_layer >= cfg.n_layers:
                    for r in active:
                        r.phase = Phase.DECODE
                        r.first_token_time = t
                        r.generated = 1
                        r.token_times.append(t)
                        decoding.append(r)
                        state.decode.decode_time[r.rid] = 0.0
                    active = []
                    active_tokens = 0
                    active_layer = 0
                run_cycle(t)

            if dec_end is not None and t >= dec_end - 1e-15:
                dt = t - dec_started
                dec_end = None
                finished = []
                for r in decoding:
                    if r.first_token_time is not None and \
                            r.first_token_time >= dec_started:
                        continue                 # joined mid-iteration
                    r.generated += 1
                    r.token_times.append(t)
                    state.decode.decode_time[r.rid] = (
                        state.decode.decode_time.get(r.rid, 0.0) + dt)
                    if r.generated >= r.output_len:
                        r.phase = Phase.FINISHED
                        r.finish_time = t
                        finished.append(r)
                for r in finished:
                    decoding.remove(r)
                run_cycle(t)

            if log_timeline:
                self.log.append(SimLogEntry(
                    t, state.resources.prefill_units,
                    state.resources.decode_units, len(decoding),
                    len(pending), active_tokens))

        for r in trace:
            if r.phase != Phase.FINISHED and r.first_token_time is not None:
                r.finish_time = t
                r.phase = Phase.FINISHED
            elif r.phase != Phase.FINISHED:
                pass   # never started — dropped at max_time

    # ------------------------------------------------------------------
    # Chunked prefill baseline (lock-step hybrid batches, §2.3)
    # ------------------------------------------------------------------
    def _run_chunked(self, trace: List[Request], budget: int,
                     max_time: float, overlap: bool = False):
        cfg = self.sim.model
        pending: List[Request] = []
        prefilling: List[Request] = []       # partially prefilled (FCFS)
        decoding: List[Request] = []
        arrivals = sorted(trace, key=lambda r: r.arrival)
        ai = 0
        t = 0.0
        steps = 0
        while True:
            steps += 1
            if steps > 5_000_000:
                raise RuntimeError("simulator runaway")
            while ai < len(arrivals) and arrivals[ai].arrival <= t:
                pending.append(arrivals[ai])
                ai += 1
            if (ai >= len(arrivals) and not pending and not prefilling
                    and not decoding):
                break
            if t > max_time:
                break
            if not pending and not prefilling and not decoding:
                t = arrivals[ai].arrival
                continue

            # compose hybrid batch: decode tokens first (§2.3.1)
            ds = len(decoding)
            room = max(budget - ds, 0)
            # admit new prefill requests FCFS until the budget is covered
            admitted_room = room - sum(r.prompt_len - r.prefill_done_tokens
                                       for r in prefilling)
            while pending and admitted_room > 0:
                r = pending.pop(0)
                if r.prefill_start is None:
                    r.prefill_start = t
                    r.phase = Phase.PREFILL
                prefilling.append(r)
                admitted_room -= r.prompt_len
            chunk_tokens = 0
            chunk_parts: List[Tuple[Request, int]] = []
            for r in prefilling:
                if room <= 0:
                    break
                take = min(room, r.prompt_len - r.prefill_done_tokens)
                if take > 0:
                    chunk_parts.append((r, take))
                    chunk_tokens += take
                    room -= take

            if ds == 0 and chunk_tokens == 0:
                if ai < len(arrivals):
                    t = max(t, arrivals[ai].arrival)
                    continue
                break

            # lock-step hybrid iteration (phase-serial, §2.3)
            parts = [(take, r.prefill_done_tokens) for r, take in chunk_parts]
            ctx = (int(sum(x.prompt_len + x.generated for x in decoding) / ds)
                   if ds else 0)
            t_iter = self.truth._noisy(self.truth._est.lockstep_iter_time(
                cfg, parts, ds, ctx, overlap=overlap))
            t += t_iter

            # apply progress
            for r, take in chunk_parts:
                r.prefill_done_tokens += take
                if r.prefill_done_tokens >= r.prompt_len:
                    prefilling.remove(r)
                    r.phase = Phase.DECODE
                    r.first_token_time = t
                    r.generated = 1
                    decoding.append(r)
            finished = []
            for r in decoding:
                if r.first_token_time == t:
                    continue               # joined this iteration
                r.generated += 1
                if r.generated >= r.output_len:
                    r.phase = Phase.FINISHED
                    r.finish_time = t
                    finished.append(r)
            for r in finished:
                decoding.remove(r)

        for r in trace:
            if r.phase != Phase.FINISHED and r.first_token_time is not None:
                r.finish_time = t
                r.phase = Phase.FINISHED
