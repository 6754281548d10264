"""Concurrent execution engine (paper §3.5) on PyTorch: the paged,
tile-granular Bullet path.

Two engine roles (prefill, decode) share a MetadataBuffer and one block-
paged KV pool ((R, pages+1, ps, K, D) per pattern position) driven by
``PagedKVPool``'s block tables:

- The **prefill engine** launches one pattern-repeat group of layers per
  cycle, consulting the SLO scheduler between groups, and scatters the
  group's KV straight into pooled pages; a finished prompt migrates to
  decode by block-table handoff only.
- The **decode engine** runs one continuous-batching iteration per cycle,
  streaming only live pages through the paged decode kernel (the table
  width bucketed to powers of two).
- When both have work and the engine runs fused (the default), one cycle
  runs the prefill group AND the decode iteration together: at that
  group's layers both phases' attention is one launch of the bullet
  kernel, whose CTAs split the SMs by the active partition's
  ``decode_share``.

Preempt / resume / migrate move block ownership in the table; pages never
move on the device. The module-level step functions are the torch
counterparts of the JAX package's jitted helpers; where those donated the
page pool, these write it in place.
"""

from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import ServerConfig
from repro_torch.core.estimator import (CycleObservation, OnlineRefitter,
                                        PerfEstimator, predict_cycle)
from repro_torch.core.metadata import MetadataBuffer
from repro_torch.core.resource import ResourceManager
from repro_torch.core.scheduler import SchedulerConfig, SLOScheduler
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.models import transformer as T
from repro_torch.serving.request import Phase, Request, SLO


# ---------------------------------------------------------------------------
# step functions (the JAX package's jitted helpers)
# ---------------------------------------------------------------------------

def _decode_iteration(params, cache, tokens, pos, active, block_tables, *,
                      cfg: ModelConfig):
    """One continuous-batching decode iteration over all slots; inactive
    slots are masked out of the sampled tokens. ``block_tables`` (B, n_b)'s
    (bucketed) width is how many table columns the paged kernel may walk.
    The page pool is updated in place."""
    logits, _ = T.decode_step(params, cache, tokens, pos, cfg,
                              block_tables=block_tables)
    next_tokens = logits.argmax(dim=-1).to(torch.int32)
    return torch.where(active, next_tokens, 0)[:, None]


def _final_tokens(params, x, lengths, *, cfg: ModelConfig):
    """Greedy first token of each prompt in a finished prefill batch."""
    logits = T.last_token_logits(params, x, lengths, cfg)
    return logits.argmax(dim=-1).to(torch.int32)


def _scatter_group_pages(cache, entries, page_map, rep: int) -> None:
    """Scatter one layer group's prefill K/V into the pooled pages of
    repeat ``rep``, in place."""
    for j, (k_e, v_e) in enumerate(entries):
        T.scatter_prefill_pages(cache["blocks"][j]["k"], k_e, page_map, rep)
        T.scatter_prefill_pages(cache["blocks"][j]["v"], v_e, page_map, rep)


def _fused_step(params, cache, x, positions, page_map, tokens, pos, active,
                block_tables, *, cfg: ModelConfig, rep: int,
                decode_share: float):
    """One spatially-fused engine cycle (§3.5 co-execution): pattern-repeat
    group ``rep`` of the in-flight prefill AND one continuous-batching
    decode iteration. At repeat ``rep`` each layer's prefill and decode
    attention share one fused launch whose CTAs split the SMs by
    ``decode_share`` (the partition's ``m_i/M``). Inactive slots' sampled
    tokens are masked exactly like ``_decode_iteration``."""
    x_p, logits = T.fused_group_decode(
        params, cache, x, positions, page_map, tokens, pos, cfg,
        rep=rep, decode_share=decode_share, block_tables=block_tables)
    next_tokens = logits.argmax(dim=-1).to(torch.int32)
    return x_p, torch.where(active, next_tokens, 0)[:, None]


class FusedExecutable(NamedTuple):
    """One pre-built execution state of the resource manager's table
    (§3.4.2): the fused step with a PartitionConfig's decode_share bound.
    ``ResourceManager.switch`` selecting a different entry is the
    libsmctrl stream-swap analogue — a dict lookup, never a rebuild."""
    config_id: int
    decode_share: float
    fn: Callable


# ---------------------------------------------------------------------------

@dataclass
class EngineStats:
    prefill_cycles: int = 0
    decode_iterations: int = 0
    reconfigs: int = 0
    paused_cycles: int = 0
    migrated: int = 0
    preempted: int = 0
    fused_cycles: int = 0
    #: estimator refits applied (params actually swapped) vs. attempts the
    #: OnlineRefitter rejected on its hysteresis margin
    refits: int = 0
    refits_rejected: int = 0
    #: explicit / deadline cancels
    cancelled: int = 0
    #: tokens the prefill engine computed
    prefill_tokens: int = 0


class DecodeWork(NamedTuple):
    """What the most recent decode iteration actually executed — consumed
    by estimator feedback so the work charged is the work that ran.

    ``streamed`` is each running slot's share of the KV tokens the bucketed
    table spans: ``max_slots × bucket·ps`` apportioned over the ``batch``
    slots that ran, as in the JAX engine (the CUDA kernel itself reads
    only live pages)."""
    batch: int
    mean_context: int
    contexts: Tuple[int, ...]             # live context per slot that ran
    streamed: Tuple[int, ...] = ()        # charged KV tokens per ran slot


@dataclass
class PrefillTask:
    """Resumable prefill state for one prompt batch (paper §3.5): the
    activations after ``rep`` groups, persisted between layer-group
    launches so decode iterations — and new admissions — run between
    groups. KV is scattered into pooled pages as each group finishes
    (``page_map`` routes prompt blocks to physical pages)."""
    batch: List[Request]
    x: torch.Tensor                       # activations after `rep` groups
    positions: torch.Tensor
    lengths: torch.Tensor
    page_map: torch.Tensor                # (B, blocks) physical pages
    n_tokens: int = 0                     # total prompt tokens in the batch
    rep: int = 0                          # next pattern-repeat group to run


class BulletServer:
    """Single-host Bullet serving runtime over a PyTorch model."""

    def __init__(self, cfg: ModelConfig, params, *,
                 config: Optional[ServerConfig] = None,
                 device="cuda"):
        """``config`` groups the options (see :class:`ServerConfig`);
        ``params`` must live on ``device`` (``init_params(device=...)``).
        Only ``device="cpu"`` runs without a card, on the plain versions of
        the kernels."""
        if config is None:
            config = ServerConfig()
        if config.slo is None:
            raise TypeError("an SLO is required: pass "
                            "config=ServerConfig(slo=SLO(...))")
        if not T.supports_paged_cache(cfg):
            raise NotImplementedError(
                f"{cfg.name}: pattern {cfg.pattern} needs the dense slot "
                "cache, which comes with a later slice of the port")
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the server on {self.device}")
        if self.device.type == "cuda":
            # pinned fp32 matmul precision: no TF32 anywhere on the path
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = config
        slo: SLO = config.slo
        sched = config.control.sched or SchedulerConfig()
        dtype = config.dtype if config.dtype is not None else torch.float32
        fused = config.execution.fused
        refit = config.control.refit
        self.cfg = cfg
        self.params = params
        self.slo = slo
        self.est = config.est or PerfEstimator()
        self.buffer = MetadataBuffer()
        self.max_slots = config.max_slots
        self.max_len = config.max_len
        self.max_prefill_batch = config.max_prefill_batch
        self.stats = EngineStats()
        self.page_size = config.cache.page_size
        self.pool = PagedKVPool(self.max_slots * self.max_len,
                                block_size=self.page_size)
        # fused spatial prefill+decode execution (§3.5) by default; the
        # serial path stays as numerics reference
        self.fused = True if fused is None else fused
        sched = replace(sched, fused=self.fused)
        self.scheduler = SLOScheduler(cfg, self.est, slo, sched)
        # pre-build one fused launcher per tile partition (§3.4.2) so
        # _switch selects among real execution states, not just numbers;
        # built even when serial so set_fused(True) can switch at once
        self.rm = ResourceManager(self.est.hw, sched.unit_quantum,
                                  builder=self._build_fused_executable)
        self.scheduler.split_candidates = [
            (p.prefill_units, p.decode_units) for p in self.rm.tile_entries]
        # online estimator refit (§3.2.2 closed loop): refit=False pins
        # the offline params; True/None builds a default OnlineRefitter;
        # an OnlineRefitter instance is used as-is
        if refit is False:
            self.refitter: Optional[OnlineRefitter] = None
        elif isinstance(refit, OnlineRefitter):
            self.refitter = refit
        else:
            self.refitter = OnlineRefitter(cfg, self.est)
        self.refit_interval = config.control.refit_interval
        self._obs_since_refit = 0
        #: (kind, predicted, actual) per cycle with a recorded actual;
        #: bounded so a long-running server cannot leak
        self.pred_actual: Deque[Tuple[str, float, float]] = deque(
            maxlen=1 << 17)
        #: observation indices at which a refit was applied
        self.refit_log: List[int] = []
        # unified device page pool: PagedKVPool block ids address these
        # pages directly; the trailing trash page absorbs masked writes
        self.cache = T.init_paged_cache(cfg, self.pool.n_blocks,
                                        self.page_size, dtype, self.device)
        self.max_blocks = self.pool.blocks_for(self.max_len)
        self._trash_page = self.pool.n_blocks
        self._host_tables = np.full((self.max_slots, self.max_blocks),
                                    self._trash_page, np.int32)
        self._tables_dirty = False
        #: device copies of the (sliced) host table, keyed by bucket width
        #: — re-uploaded only when ownership changes
        self._dev_tables: Dict[int, torch.Tensor] = {}
        # slot bookkeeping on the host; uploaded per iteration
        self.slot_req: List[Optional[Request]] = [None] * self.max_slots
        self.tokens = np.zeros((self.max_slots, 1), np.int32)
        self.pos = np.zeros((self.max_slots,), np.int32)
        self.active = np.zeros((self.max_slots,), bool)
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self.outputs: Dict[int, List[int]] = {}
        #: in-flight resumable prefill (at most one batch at a time)
        self.ptask: Optional[PrefillTask] = None
        #: streaming hook: on_token(req, token, now) for every emitted token
        self.on_token: Optional[Callable[[Request, int, float], None]] = None
        #: what the most recent step() actually executed
        self.last_prefill_tokens: int = 0
        self.last_decode: Optional[DecodeWork] = None
        #: True when the last step ran the fused spatial cycle
        self.last_fused: bool = False
        #: config_id of the pre-built executable the last fused cycle ran
        self.last_fused_exec: Optional[int] = None

    def _build_fused_executable(self, part) -> FusedExecutable:
        """ResourceManager builder: one fused-step launcher per quantized
        PartitionConfig, its decode_share bound."""
        fn = functools.partial(_fused_step, cfg=self.cfg,
                               decode_share=round(part.decode_share, 6))
        return FusedExecutable(part.config_id, part.decode_share, fn)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # -- device block tables -------------------------------------------
    def _sync_tables(self) -> None:
        """Re-export the pool's block tables in slot order. Only
        DECODE-phase slots are mapped: a slot mid-prefill must stay on the
        trash page, or the decode iteration's unconditional per-slot KV
        write (driven by the slot's stale pos/tokens) would poison the
        pages its new occupant is concurrently scattering prompt KV into."""
        self._host_tables = self.pool.device_block_table(
            [r.rid if r is not None and r.phase == Phase.DECODE else None
             for r in self.slot_req],
            self.max_blocks, fill=self._trash_page)
        self._dev_tables.clear()
        self._tables_dirty = False

    def _device_tables(self, n_b: int) -> torch.Tensor:
        """The first ``n_b`` table columns on device, uploaded lazily and
        reused across iterations until ownership changes."""
        bt = self._dev_tables.get(n_b)
        if bt is None:
            bt = self._dev(np.ascontiguousarray(self._host_tables[:, :n_b]))
            self._dev_tables[n_b] = bt
        return bt

    def _decode_block_bucket(self, ctxs_ran: Tuple[int, ...]) -> int:
        """Max live page count across the slots that run, rounded up to a
        power of two: the table width the decode kernel is given."""
        need = -(-max(ctxs_ran) // self.page_size) if ctxs_ran else 1
        b = 1
        while b < need:
            b <<= 1
        return max(1, min(b, self.max_blocks))

    # -- request ingress ------------------------------------------------
    def submit(self, req: Request, prompt_tokens: np.ndarray):
        # a request's pool footprint (prompt + output) is invariant across
        # preemption/resume, so an oversized request is rejected here
        footprint = req.prompt_len + max(req.output_len, 1)
        if self.pool.blocks_for(footprint) > self.pool.n_blocks:
            raise ValueError(
                f"request {req.rid} needs {footprint} KV tokens; the pool "
                f"holds {self.pool.n_blocks * self.pool.block_size}")
        req.phase = Phase.QUEUED
        req._prompt = np.asarray(prompt_tokens, np.int32)   # type: ignore
        self.pending.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _pending_meta(self) -> List[Tuple[int, float, int]]:
        return [(r.rid, r.arrival, r.prompt_len) for r in self.pending]

    def _apply_reorder(self, order: Optional[List[int]]) -> None:
        """Honor the scheduler's Decision.reorder (slack-sorted rids)."""
        if not order or len(self.pending) < 2:
            return
        pos = {rid: i for i, rid in enumerate(order)}
        self.pending.sort(key=lambda r: pos.get(r.rid, len(pos)))

    def _switch(self, resources) -> None:
        """Swap partitions, counting only actual re-configurations."""
        if self.fused:
            # the split search is defined over the prebuilt executable
            # table; a proposal off it means scheduler and resource
            # manager have drifted apart
            assert self.rm.on_table(resources), (
                f"scheduler proposed off-table partition "
                f"({resources.prefill_units}, {resources.decode_units}); "
                f"table quantum={self.rm.quantum}")
        before = self.rm.current.config_id
        part = self.rm.switch(resources)
        if part.config_id != before:
            self.stats.reconfigs += 1
        self.buffer.write(lambda s: (
            setattr(s.resources, "prefill_units", part.prefill_units),
            setattr(s.resources, "decode_units", part.decode_units),
            setattr(s.resources, "config_id", part.config_id),
            setattr(s.resources, "granularity", part.granularity),
            setattr(s.resources, "prefill_chips", part.prefill_chips),
            setattr(s.resources, "decode_chips", part.decode_chips)))

    # -- prefill engine ---------------------------------------------------
    def _resume_len(self, r: Request) -> int:
        """Tokens the prefill must cover: prompt plus any prefix generated
        before a preemption (resumed requests recompute their KV over it)."""
        return r.prompt_len + len(self.outputs.get(r.rid, []))

    def _seq_tokens(self, r: Request) -> np.ndarray:
        """The token ids the prefill must cover (prompt + resume prefix)."""
        seq = r._prompt                                     # type: ignore
        prefix = self.outputs.get(r.rid)
        if prefix:
            seq = np.concatenate([seq, np.asarray(prefix, np.int32)])
        return seq

    def _need_tokens(self, r: Request) -> int:
        """Pool reservation for a request: the full prompt (+ resume
        prefix) and output footprint, reserved at admission so decode can
        never over-commit the pool mid-flight."""
        return self._resume_len(r) + max(r.output_len - r.generated, 1)

    def _preempt_candidates(self, req: Request) -> List[Request]:
        """Decode slots eligible for eviction: strictly younger arrivals
        (priority order prevents preemption cycles)."""
        return [r for r in self.slot_req
                if r is not None and r.phase == Phase.DECODE
                and r.arrival > req.arrival]

    def _preempt_for(self, req: Request, now: float) -> bool:
        """KV pressure (§3.5.2): evict the youngest strictly-younger decode
        slot, freeing its pool pages and requeueing it with its generated
        prefix."""
        victims = self._preempt_candidates(req)
        if not victims:
            return False
        victim = max(victims, key=lambda r: r.arrival)
        slot = victim._slot                                 # type: ignore
        self.pool.preempt(victim.rid)
        self._tables_dirty = True        # ownership moved back to the pool
        self.active[slot] = False
        self.slot_req[slot] = None
        victim.phase = Phase.QUEUED
        self.pending.append(victim)
        self.stats.preempted += 1
        D = self.buffer.state.decode
        if victim.rid in D.batch:
            D.batch.remove(victim.rid)
        self._drop_request_meta(victim.rid)
        return True

    def _admit_prefill(self, now: float) -> bool:
        """Form the next prompt batch from the pending queue, honoring the
        scheduler's slack-sorted reorder; on pool pressure, preempt before
        head-of-line blocking."""
        if self.ptask is not None or not self.pending:
            return False
        if self._free_slot() is None:        # saturated: skip the slack scan
            return False
        state = self.buffer.read()
        if len(self.pending) > 1:
            self._apply_reorder(
                self.scheduler.reorder_pending(state, now,
                                               self._pending_meta()))
        batch: List[Request] = []
        while (self.pending and len(batch) < self.max_prefill_batch
               and self._free_slot() is not None):
            r = self.pending[0]
            need = self._need_tokens(r)
            if not self.pool.can_admit(need):
                if batch:
                    break
                # evict only if the eligible victims' blocks actually
                # cover the shortfall — never waste decode progress
                reclaimable = sum(
                    self.pool.reclaimable_blocks(v.rid)
                    for v in self._preempt_candidates(r))
                if (self.pool.blocks_for(need)
                        > self.pool.available_blocks + reclaimable):
                    break
                while (not self.pool.can_admit(need)
                       and self._preempt_for(r, now)):
                    pass
                if not self.pool.can_admit(need):
                    break
            slot = self._free_slot()
            self.pool.allocate(r.rid, need)
            if r.prefill_start is None:
                r.prefill_start = now
            r.phase = Phase.PREFILL
            self.pending.pop(0)
            batch.append(r)
            self.slot_req[slot] = r
            r._slot = slot                                  # type: ignore
            self.buffer.state.prefill.queue_wait[r.rid] = now - r.arrival
        if not batch:
            return False

        lens = [self._resume_len(r) for r in batch]
        plen = max(lens)
        toks = np.zeros((len(batch), plen), np.int32)
        for i, r in enumerate(batch):
            toks[i, :lens[i]] = self._seq_tokens(r)
        x = T.embed_tokens(self.params, self._dev(toks), self.cfg)
        positions = torch.arange(plen, device=self.device)[None, :]
        # route each request's prompt blocks to its pooled pages so layer
        # groups scatter KV in place (no handoff copy)
        self._tables_dirty = True
        ps = self.page_size
        page_map = np.full((len(batch), -(-plen // ps)), self._trash_page,
                           np.int32)
        for i, r in enumerate(batch):
            blocks = self.pool.table(r.rid).blocks[:-(-lens[i] // ps)]
            page_map[i, :len(blocks)] = blocks
        self.ptask = PrefillTask(
            batch, x, positions, self._dev(np.asarray(lens, np.int32)),
            self._dev(page_map), n_tokens=int(sum(lens)))
        self.stats.prefill_tokens += self.ptask.n_tokens
        P = self.buffer.state.prefill
        P.active_rid = batch[0].rid
        P.started_at = now
        P.layers_done = 0
        P.total_layers = self.cfg.n_layers
        P.n_tokens = self.ptask.n_tokens
        P.n_waiting = len(self.pending)
        return True

    def _prefill_step(self, now: float) -> bool:
        """Launch ONE pattern-repeat group of the in-flight prefill, with a
        scheduling cycle before it (§3.3.1); migrate to decode when the
        last group completes. Decode iterations interleave between calls."""
        task = self.ptask
        if task is None:
            return False
        state = self.buffer.read()
        decision = self.scheduler.schedule(state, now, self._pending_meta())
        self._apply_reorder(decision.reorder)
        self._switch(decision.resources)
        self._launch_prefill_group(task, now)
        return True

    def _launch_prefill_group(self, task: PrefillTask, now: float) -> None:
        """Launch ONE pattern-repeat group of ``task`` (serial dispatch —
        the fused cycle launches its group inside the fused step instead)
        and migrate to decode when the last group completes."""
        task.x, entries = T.prefill_group(self.params, task.x,
                                          task.positions, task.rep, self.cfg)
        _scatter_group_pages(self.cache, entries, task.page_map, task.rep)
        self._prefill_group_done(task, now)

    def _prefill_group_done(self, task: PrefillTask, now: float) -> None:
        """Post-group bookkeeping shared by the serial and fused paths:
        advance the group cursor, publish progress, and migrate to decode
        when the last group completed."""
        task.rep += 1
        self.stats.prefill_cycles += 1
        self.last_prefill_tokens = task.n_tokens
        P = self.buffer.state.prefill
        P.layers_done = task.rep * len(self.cfg.pattern)
        for r in task.batch:
            r.prefill_done_layers = P.layers_done
        if task.rep >= self.cfg.n_pattern_repeats:
            self._finish_prefill(task, now)
            self.ptask = None

    def _finish_prefill(self, task: PrefillTask, now: float) -> None:
        """Migrate the finished batch to decode: the KV already sits in
        pooled pages, so the handoff is pure block-table ownership
        (pool.migrate) — no device copy. Requests cancelled mid-prefill
        (``cancel_reason`` set) are finalized here instead: pages freed,
        no token emitted."""
        first_tokens = _final_tokens(self.params, task.x, task.lengths,
                                     cfg=self.cfg).cpu().numpy()
        P = self.buffer.state.prefill
        # migrated slots flip PREFILL->DECODE: re-map their pages into the
        # device tables before the next decode iteration
        self._tables_dirty = True
        for i, r in enumerate(task.batch):
            slot = r._slot                                  # type: ignore
            if r.cancel_reason is not None:
                self.pool.free(r.rid)
                self.slot_req[slot] = None
                self._cancelled(r, now, r.cancel_reason)
                continue
            tok = int(first_tokens[i])
            prefix = self.outputs.get(r.rid)
            if prefix is None:
                self.outputs[r.rid] = [tok]
                r.first_token_time = now
            else:                         # resumed after preemption
                prefix.append(tok)
            r.generated = len(self.outputs[r.rid])
            r.token_times.append(now)
            r.phase = Phase.DECODE
            self.tokens[slot, 0] = tok
            self.pos[slot] = r.prompt_len + r.generated - 1
            self.active[slot] = True
            self.pool.migrate(r.rid)
            self.stats.migrated += 1
            self.buffer.write(lambda s, rid=r.rid: s.ready_for_decode.append(
                (rid, self.outputs[rid][-1])))
            if self.on_token is not None:
                self.on_token(r, tok, now)
            if (r.generated >= r.output_len
                    or r.prompt_len + r.generated >= self.max_len):
                self._finish_request(r, slot, now)
        # prefill engine is idle until the next admission
        P.active_rid = None
        P.layers_done = 0
        P.n_tokens = 0

    def _finish_request(self, r: Request, slot: int, now: float) -> None:
        r.phase = Phase.FINISHED
        r.finish_time = now
        self.finished.append(r)
        self.pool.free(r.rid)
        self._tables_dirty = True
        self.slot_req[slot] = None
        self.active[slot] = False
        self._drop_request_meta(r.rid)

    def _drop_request_meta(self, rid: int) -> None:
        """Prune per-request shared-buffer entries so a long-running online
        server does not grow without bound."""
        s = self.buffer.state
        s.prefill.queue_wait.pop(rid, None)
        s.decode.out_tokens.pop(rid, None)
        s.decode.decode_time.pop(rid, None)
        s.ready_for_decode = [e for e in s.ready_for_decode if e[0] != rid]

    def cancel_request(self, r: Request, now: float,
                       why: str = "deadline") -> None:
        """Cancel a live request: release its pool pages through the same
        table-ownership edits preemption uses and retire it with
        ``Phase.CANCELLED``. A request whose prefill batch is in flight is
        only *marked*; it is removed at the next layer-group boundary
        (``_finish_prefill``)."""
        if r.phase in (Phase.FINISHED, Phase.CANCELLED):
            return
        if r.phase == Phase.QUEUED:
            if r in self.pending:
                self.pending.remove(r)
        elif r.phase == Phase.PREFILL:
            r.cancel_reason = why
            return
        else:                                   # DECODE: live slot
            slot = r._slot                                  # type: ignore
            self.pool.free(r.rid)
            self._tables_dirty = True
            self.slot_req[slot] = None
            self.active[slot] = False
            D = self.buffer.state.decode
            if r.rid in D.batch:
                D.batch.remove(r.rid)
        self._cancelled(r, now, why)

    def _cancelled(self, r: Request, now: float, why: str) -> None:
        r.phase = Phase.CANCELLED
        r.cancel_reason = why
        r.finish_time = now
        self.stats.cancelled += 1
        self._drop_request_meta(r.rid)

    def set_fused(self, flag: bool) -> None:
        """Flip fused spatial co-execution on/off at a cycle boundary. The
        scheduler's contention model follows the execution mode."""
        if flag == self.fused:
            return
        self.fused = flag
        self.scheduler.sc = replace(self.scheduler.sc, fused=flag)

    def check_invariants(self) -> None:
        """Crash-on-corruption audit: pool block ownership is a partition
        of allocated pages; every pool owner is a live request; slot
        bookkeeping agrees with request phases."""
        self.pool.check_invariants()
        owners = set(self.pool.owners())
        holders = {r.rid for r in self.slot_req if r is not None}
        if self.ptask is not None:
            holders |= {r.rid for r in self.ptask.batch}
        leaked = owners - holders
        assert not leaked, (
            f"pool pages leaked: rids {sorted(leaked)} own blocks but are "
            f"neither in a slot nor in the prefill batch")
        for slot, r in enumerate(self.slot_req):
            if r is None:
                assert not bool(self.active[slot]), \
                    f"empty slot {slot} active"
                continue
            assert getattr(r, "_slot", None) == slot, \
                f"slot {slot} holds rid {r.rid} with _slot={r._slot}"
            assert r.phase in (Phase.PREFILL, Phase.DECODE), \
                f"slot {slot} rid {r.rid} in phase {r.phase}"
            assert r.rid in owners, \
                f"slot {slot} rid {r.rid} owns no pool pages"
            assert bool(self.active[slot]) == (r.phase == Phase.DECODE), (
                f"slot {slot} rid {r.rid}: active={bool(self.active[slot])}"
                f" but phase={r.phase}")

    # -- decode engine ----------------------------------------------------
    def _decode_inputs(self):
        """(ctxs_ran, n_b, streamed, device tensors) for one iteration."""
        ctxs_ran = tuple(int(p) + 1 for p, a in zip(self.pos, self.active)
                         if a)
        n_ran = len(ctxs_ran)
        if self._tables_dirty:
            self._sync_tables()
        n_b = self._decode_block_bucket(ctxs_ran)
        streamed = (n_b * self.page_size * self.max_slots
                    // max(n_ran, 1),) * n_ran
        dev = (self._dev(self.tokens), self._dev(self.pos),
               self._dev(self.active), self._device_tables(n_b))
        return ctxs_ran, streamed, dev

    def _decode_cycle(self, now: float) -> bool:
        if not self.active.any():
            return False
        state = self.buffer.read()
        decision = self.scheduler.schedule(state, now, self._pending_meta())
        self._apply_reorder(decision.reorder)
        if decision.pause_decode:
            self.stats.paused_cycles += 1
            self.buffer.state.decode.paused = True
            return False
        self.buffer.state.decode.paused = False
        self._switch(decision.resources)
        act_np = self.active.copy()
        ctxs_ran, streamed, (tokens, pos, active, bt) = self._decode_inputs()
        next_tokens = _decode_iteration(self.params, self.cache, tokens, pos,
                                        active, bt, cfg=self.cfg)
        self._finish_decode_iteration(next_tokens, act_np, ctxs_ran,
                                      streamed, now)
        return True

    def _finish_decode_iteration(self, next_tokens, act_np, ctxs_ran,
                                 streamed, now: float) -> None:
        """Post-iteration bookkeeping shared by the serial and fused
        paths: advance slot state, stream tokens, retire finished
        requests, publish DecodeStatus, and record what ran."""
        n_ran = len(ctxs_ran)
        self.tokens = next_tokens.cpu().numpy().astype(np.int32)
        self.pos = self.pos + act_np.astype(np.int32)
        self.stats.decode_iterations += 1
        nt = self.tokens[:, 0]

        D = self.buffer.state.decode
        for slot, r in enumerate(self.slot_req):
            if r is None or r.phase != Phase.DECODE:
                continue
            tok = int(nt[slot])
            self.outputs[r.rid].append(tok)
            r.generated += 1
            r.token_times.append(now)
            D.out_tokens[r.rid] = r.generated
            D.decode_time[r.rid] = now - (
                r.first_token_time if r.first_token_time is not None else now)
            if self.on_token is not None:
                self.on_token(r, tok, now)
            if (r.generated >= r.output_len
                    or r.prompt_len + r.generated >= self.max_len):
                self._finish_request(r, slot, now)
        live = [x for x in self.slot_req
                if x is not None and x.phase == Phase.DECODE]
        D.batch = [x.rid for x in live]
        D.ctx_tokens = int(sum(x.prompt_len + x.generated for x in live))
        D.mean_context = int(D.ctx_tokens / len(live)) if live else 0
        self.last_decode = DecodeWork(
            n_ran, max(int(sum(ctxs_ran) / max(n_ran, 1)), 1), ctxs_ran,
            streamed)

    # -- fused engine (spatial co-execution, §3.5) ------------------------
    def _fused_cycle(self, now: float) -> bool:
        """One fused engine cycle: the current prefill layer group and one
        decode iteration in one fused step whose attention launches split
        the SMs by the active partition's ``decode_share``. One scheduling
        cycle covers both phases; the §3.3.3 pause branch still borrows the
        whole machine for prefill alone (serial group launch)."""
        task = self.ptask
        state = self.buffer.read()
        decision = self.scheduler.schedule(state, now, self._pending_meta())
        self._apply_reorder(decision.reorder)
        self._switch(decision.resources)
        if decision.pause_decode:
            self.stats.paused_cycles += 1
            self.buffer.state.decode.paused = True
            self._launch_prefill_group(task, now)
            return True
        self.buffer.state.decode.paused = False
        ex = self.rm.executable()
        act_np = self.active.copy()
        ctxs_ran, streamed, (tokens, pos, active, bt) = self._decode_inputs()
        task.x, next_tokens = ex.fn(
            self.params, self.cache, task.x, task.positions, task.page_map,
            tokens, pos, active, bt, rep=task.rep)
        self.last_fused = True
        self.last_fused_exec = ex.config_id
        self.stats.fused_cycles += 1
        # decode-side bookkeeping first, prefill-side after: slots that
        # finish prefill this cycle take their first decode step next cycle
        self._finish_decode_iteration(next_tokens, act_np, ctxs_ran,
                                      streamed, now)
        self._prefill_group_done(task, now)
        return True

    # -- online estimator refit (§3.2.2 closed loop) ----------------------
    def last_cycle_observation(self) -> Optional[CycleObservation]:
        """What the most recent step() executed, as the estimator-facing
        CycleObservation. None when the step ran no device work."""
        w = self.last_decode
        if w is None and not self.last_prefill_tokens:
            return None
        R = self.buffer.state.resources
        if self.last_fused and w is not None and self.last_prefill_tokens:
            return CycleObservation(
                "fused", self.last_prefill_tokens,
                max(R.prefill_units, 1), max(R.decode_units, 1),
                max(w.batch, 1), max(w.mean_context, 1),
                tuple(w.streamed) or None)
        return CycleObservation(
            "serial", self.last_prefill_tokens,
            R.prefill_units, R.decode_units,
            w.batch if w is not None else 0,
            max(w.mean_context, 1) if w is not None else 1,
            (tuple(w.streamed) or None) if w is not None else None)

    def record_cycle_actual(self, actual_s: float) -> None:
        """Feed the measured duration of the cycle the last step() ran:
        logs one (kind, predicted, actual) pair and hands the observation
        to the OnlineRefitter; refits happen inside step()."""
        obs = self.last_cycle_observation()
        if obs is None or actual_s <= 0:
            return
        pred = predict_cycle(self.est, self.cfg, obs)
        self.pred_actual.append((obs.kind, pred, actual_s))
        if self.refitter is not None:
            self.refitter.observe(obs, actual_s)
            self._obs_since_refit += 1

    def _maybe_refit(self) -> None:
        """Every ``refit_interval`` recorded cycles, ask the refitter for
        better params and swap them into the engine AND the scheduler."""
        if (self.refitter is None
                or self._obs_since_refit < self.refit_interval):
            return
        self._obs_since_refit = 0
        new = self.refitter.refit()
        self.stats.refits_rejected = self.refitter.refits_rejected
        if new is not None:
            self.est = self.est.with_params(new)
            self.scheduler.est = self.est
            self.refitter.est = self.est
            self.stats.refits += 1
            self.refit_log.append(len(self.pred_actual))

    # -- main loop --------------------------------------------------------
    def step(self, now: float) -> bool:
        """One engine cycle at time ``now``: admit newly-pending prompts,
        launch one prefill layer group, run one decode iteration — as a
        single fused cycle when both phases are co-resident (and the
        engine runs fused), as serial back-to-back launches otherwise.
        Returns True if any engine did work."""
        self._maybe_refit()
        self.last_prefill_tokens = 0
        self.last_decode = None
        self.last_fused = False
        did_admit = self._admit_prefill(now)
        if self.fused and self.ptask is not None and self.active.any():
            return self._fused_cycle(now) or did_admit
        did_p = self._prefill_step(now)
        did_d = self._decode_cycle(now)
        return did_admit or did_p or did_d

    @property
    def idle(self) -> bool:
        """No queued, in-flight, or decoding work remains."""
        return (not self.pending and self.ptask is None
                and all(r is None for r in self.slot_req))

    def run(self, max_cycles: int = 10_000) -> Dict[int, List[int]]:
        """Drive both engines until all submitted requests finish."""
        t0 = time.perf_counter()
        cycles = 0
        while cycles < max_cycles:
            cycles += 1
            now = time.perf_counter() - t0
            if not self.step(now) and self.idle:
                break
        self.pool.check_invariants()
        return self.outputs
