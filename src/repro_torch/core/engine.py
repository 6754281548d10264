"""Concurrent execution engine (paper §3.5) on PyTorch: the Bullet path at
both of §3.4's granularities.

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
- Chip granularity (``ExecConfig(partition="chip"|"auto", devices=...)``,
  docs/PARTITIONS.md) carves a device group into disjoint (prefill side,
  decode side) splits (``launch/submesh.py``). A chip-pinned task runs
  every layer group on the prefill side's lead device and stream,
  scattering its K/V into a staging page pool there (``cache_p``),
  while the decode iteration runs on the decode side's device and stream
  over the decode pool; when the prompt finishes, exactly its written
  pages are copied across (``kvcache.paged.transfer_pages``), with
  retries, an abort and the guard's chip→tile rung behind it. Under
  ``"auto"`` the scheduler's combined-table argmin pins each task to
  chip or tile at admission. A group may name one card twice: the sides
  then share the card, each on its own stream and pool. Tile and serial
  cycles run on the group's first entry, the server's device.

Preempt / resume / migrate move block ownership in the table; pages never
move on the device. The dense fixed-slot cache ((R, slots, S, K, D), one
``max_len`` row per slot) is the reference layout the SLO guard's
paged→dense rung falls back to (``set_cache_mode``): prefill fills a
per-batch cache and migration copies each request's row into its slot,
and decode reads the rows through the dense decode kernel. It is also the
only layout of a model with recurrent blocks (Mamba-2): there a slot holds
each SSD layer's conv window and state, which prefill computes at every
request's own length, and the engine runs serial (``paged=None`` and
``fused=None`` resolve to False, as in the JAX engine). The
observability (``obs``), fault-injection (``faults``) and SLO-guard
(``guard``) seams are the JAX engine's, gated the same way. The
module-level step functions are the torch counterparts of the JAX
package's jitted helpers; where those donated a cache, these write it in
place, so every fault seam fires before its cycle's first in-place write.

On the card the engine's steps replay as CUDA graphs (``core/graphs.py``),
one per static shape, all in one ``StepGraphs`` and its shared pool:

- the serial decode iteration, ``("paged", n_b)`` per table bucket and
  ``("dense",)`` for the slot cache;
- the fused cycle in segments whose keys repeat on every cycle: the
  decode tokens' embedding ``("d_embed",)``, each decode pattern repeat
  but the fused one ``("d_rep", r, n_b)``, and the head ``("d_head",)``
  (final norm, logits, argmax, the active mask). The fused repeat ``rep``
  runs eagerly between them: its shapes follow the prompt and its launch
  bakes the partition's ``decode_share``, so it is the one part of the
  step the pre-built ``FusedExecutable`` of a partition binds; the graphs
  bake no share and serve every partition;
- the paged prefill groups ``("p_group", rep, Bp, Sp)`` and the prompts'
  first tokens ``("p_final", Bp, Sp)``, ``Sp`` the batch's padded length:
  a prompt batch is padded to a length bucket (``prefill_bucket``), so
  the keys repeat across prompts;
- a chip task's prefill groups ``("c_group", rep, Bp, Sp)`` and first
  tokens ``("c_final", Bp, Sp)`` over the staging pool, in a StepGraphs
  of their own (``graphs_p``, its own pool), as they replay on the
  prefill side's stream while the decode side's graphs replay; the chip
  decode iteration replays the serial decode's ``("paged", n_b)``.

Inputs live in persistent buffers the graphs read in place (tokens, pos,
active, one block table per bucket copied again whenever ownership
changes, the decode activations ``x_d``, and per (Bp, Sp) the prefill
activations, positions, lengths and page map, written at each
admission); the segments write their results into those buffers. The
graphs are dropped before their cache is. The dense path's prefill
groups stay eager (each batch fills a cache of its own), and so do the
shared-prefix suffix groups (``share_prefix``, docs/KV_SHARING.md: their
shapes follow each batch's prefix and suffix lengths); both write the
pool the graphs hold in place, so no graph is left reading a dead pool.
CPU tensors run every step eagerly, through the same calls.

A MoE model's prefill groups route each request's own tokens: the prefill
lengths reach every prefill step (the graphs read them in their persistent
buffer), so a prompt's capacity does not depend on its bucket's padding
(``models/moe.py``); decode passes route the slot array as the JAX engine
does. ``BulletServer.moe_stats`` sums the prefill side's metrics.

With ``share_prefix`` a prompt batch is all hits or all misses of the
pool's prefix index. A miss batch runs the path above; a hit batch
prefills only each request's unshared suffix, padded to the batch's
longest suffix, attending the prefix K/V gathered from the shared pages
(``T.prefill_group_shared``) and splicing its own K/V in at each row's
in-page offset (``T.scatter_suffix_group_pages``), after the copy-on-write
tails are copied (``T.copy_pages``); it always runs serially. The tenancy
seam (``ServerConfig.tenancy``, docs/MULTITENANCY.md) biases admission
order and the preemption victim by tenant credit.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MOE, ModelConfig
from repro_torch.core import analytics
from repro_torch.core.config import ServerConfig
from repro_torch.core.estimator import (CycleObservation, HardwareSpec,
                                        OnlineRefitter, PerfEstimator,
                                        predict_cycle)
from repro_torch.core.graphs import StepGraphs
from repro_torch.core.metadata import MetadataBuffer
from repro_torch.core.resource import ResourceManager
from repro_torch.core.scheduler import SchedulerConfig, SLOScheduler
from repro_torch.kvcache.paged import PagedKVPool, on_stream, transfer_pages
from repro_torch.launch.submesh import (HandoffPolicy, SubMeshSplit,
                                        carve_submeshes, find_split)
from repro_torch.models import transformer as T
from repro_torch.models.moe import MoEStats
from repro_torch.models.sharding import (submesh_cache_sharding,
                                         submesh_param_sharding)
from repro_torch.obs import NULL_OBS, CycleEvent
from repro_torch.resilience.faults import (NULL_FAULTS, DispatchError,
                                           HandoffError)
from repro_torch.serving.request import Phase, Request, SLO
from repro_torch.training.tree import tree_map


# ---------------------------------------------------------------------------
# step functions (the JAX package's jitted helpers)
# ---------------------------------------------------------------------------

def _decode_iteration(params, cache, tokens, pos, active, block_tables=None,
                      *, cfg: ModelConfig):
    """One continuous-batching decode iteration over all slots; inactive
    slots are masked out of the sampled tokens. ``block_tables`` (B, n_b)
    selects the block-paged cache, its (bucketed) width how many table
    columns the paged kernel may walk; without it ``cache`` is the dense
    slot cache. The cache is updated in place. Returns (next tokens (B,
    1), logits (B, V))."""
    logits, _ = T.decode_step(params, cache, tokens, pos, cfg,
                              block_tables=block_tables)
    next_tokens = logits.argmax(dim=-1).to(torch.int32)
    return torch.where(active, next_tokens, 0)[:, None], logits


def _final_tokens(params, x, lengths, *, cfg: ModelConfig):
    """Greedy first token of each prompt in a finished prefill batch."""
    logits = T.last_token_logits(params, x, lengths, cfg)
    return logits.argmax(dim=-1).to(torch.int32)


def _prefill_group(params, x, positions, tmp_cache, lengths, *,
                   cfg: ModelConfig, rep: int, stats=None):
    """Dense path: pattern-repeat group ``rep`` over the prompt batch; each
    layer's entry (KV padded to the cache row length, or an SSD block's
    conv window and state at each request's own length) is written into
    repeat ``rep`` of the batch's own cache ``tmp_cache``, in place. A MoE
    block routes each request's own tokens (its metrics to ``stats``).
    Returns the activations."""
    x, entries = T.prefill_group(params, x, positions, rep, cfg, lengths,
                                 stats)
    T.write_dense_entries(tmp_cache, entries, cfg, lengths, rep)
    return x


def _prefill_group_paged(params, cache, x, positions, page_map, lengths=None,
                         *, cfg: ModelConfig, rep: int, stats=None):
    """Paged path: pattern-repeat group ``rep`` over the prompt batch
    ``x`` (Bp, Sp, D) of ``lengths`` (Bp,) tokens a row, its K/V scattered
    into the pooled pages that ``page_map`` names; the activations are
    written back into ``x`` in place (the step a ``("p_group", rep, Bp,
    Sp)`` graph replays, reading the lengths in place; a MoE block routes
    each row's own tokens, its metrics added to ``stats``)."""
    y, entries = T.prefill_group(params, x, positions, rep, cfg, lengths,
                                 stats)
    T.scatter_group_pages(cache, entries, page_map, rep)
    x.copy_(y)
    return x


#: prompt-length buckets: a prefill batch is padded to the next multiple of
#: PREFILL_STEP tokens up to PREFILL_LINEAR, past it to the next power of
#: two, and never past ``max_len`` rounded up to the page size
PREFILL_STEP, PREFILL_LINEAR = 128, 1024


def prefill_bucket(n: int, max_len: int, page_size: int) -> int:
    """The padded length of a prefill batch whose longest sequence has
    ``n`` tokens: at most 8 buckets up to 1024 and one per power of two
    beyond, so the prefill graphs' keys repeat across prompts. A multiple
    of the page size; padded rows' K/V go to the trash page."""
    if n <= PREFILL_LINEAR:
        b = -(-n // PREFILL_STEP) * PREFILL_STEP
    else:
        b = 1 << (n - 1).bit_length()
    b = min(b, -(-max_len // page_size) * page_size)
    return max(page_size, -(-b // page_size) * page_size)


def _embed_into(params, tokens, x_d, *, cfg: ModelConfig):
    """The decode tokens' embedding, written into ``x_d`` (B, 1, D) in
    place (the ``("d_embed",)`` segment of a fused cycle)."""
    x_d.copy_(T.embed_tokens(params, tokens, cfg))
    return x_d


def _decode_repeat_into(params, cache, x_d, pos, block_tables, *,
                        cfg: ModelConfig, rep: int):
    """Decode pattern repeat ``rep`` over the page pool, ``x_d`` updated
    in place (the ``("d_rep", rep, n_b)`` segment)."""
    x_d.copy_(T.decode_repeat(params, cache, x_d, pos, rep, cfg,
                              block_tables))
    return x_d


def _decode_head(params, x_d, active, *, cfg: ModelConfig):
    """Final norm, logits, greedy tokens with inactive slots masked, as in
    ``_decode_iteration`` (the ``("d_head",)`` segment). Returns (next
    tokens (B, 1), logits (B, V))."""
    logits = T.decode_logits(params, x_d, cfg)
    next_tokens = logits.argmax(dim=-1).to(torch.int32)
    return torch.where(active, next_tokens, 0)[:, None], logits


def _fused_repeat(params, cache, x_p, positions, page_map, x_d, pos,
                  block_tables, *, cfg: ModelConfig, rep: int,
                  decode_share: float, lengths=None, stats=None) -> None:
    """The fused repeat of a fused cycle, eagerly: prefill group ``rep``
    (prompts of ``lengths`` tokens) and the decode pass's repeat ``rep``,
    each layer's attention one fused launch split by ``decode_share``;
    ``x_p`` and ``x_d`` updated in place."""
    y_p, y_d = T.fused_repeat(params, cache, x_p, x_d, positions, page_map,
                              pos, rep, cfg, decode_share=decode_share,
                              block_tables=block_tables, lengths=lengths,
                              stats=stats)
    x_p.copy_(y_p)
    x_d.copy_(y_d)


def _fused_step(graphs: StepGraphs, params, cache, x_p, positions, page_map,
                x_d, tokens, pos, active, block_tables, *, cfg: ModelConfig,
                rep: int, decode_share: float, fused_repeat=_fused_repeat,
                lengths=None, stats=None):
    """One spatially-fused engine cycle (§3.5 co-execution): pattern-repeat
    group ``rep`` of the in-flight prefill AND one continuous-batching
    decode iteration, op for op ``T.fused_group_decode``. At repeat ``rep``
    each layer's prefill and decode attention share one fused launch whose
    CTAs split the SMs by ``decode_share`` (the partition's ``m_i/M``);
    inactive slots' sampled tokens are masked exactly like
    ``_decode_iteration``. In segments: the embedding, every other decode
    repeat and the head through ``graphs`` (replays on the card), the
    fused repeat eagerly (``fused_repeat``, given the prefill side's
    ``lengths`` and MoE ``stats``). ``x_p`` (the prefill activations) and
    ``x_d`` (B, 1, D) are updated in place. Returns (next
    tokens (B, 1), logits (B, V))."""
    n_b = block_tables.shape[1]
    graphs(("d_embed",), functools.partial(_embed_into, params, cfg=cfg),
           tokens, x_d)
    for r in range(cfg.n_pattern_repeats):
        if r == rep:
            fused_repeat(params, cache, x_p, positions, page_map, x_d, pos,
                         block_tables, cfg=cfg, rep=rep,
                         decode_share=decode_share, lengths=lengths,
                         stats=stats)
        else:
            graphs(("d_rep", r, n_b), functools.partial(
                _decode_repeat_into, params, cache, cfg=cfg, rep=r),
                x_d, pos, block_tables)
    return graphs(("d_head",), functools.partial(_decode_head, params,
                                                 cfg=cfg), x_d, active)


class FusedExecutable(NamedTuple):
    """One pre-built execution state of the resource manager's table
    (§3.4.2): the fused step with a PartitionConfig's decode_share bound
    (it reaches the one eager repeat; the graphs serve every partition).
    ``ResourceManager.switch`` selecting a different entry is the
    libsmctrl stream-swap analogue — a dict lookup, never a rebuild."""
    config_id: int
    decode_share: float
    fn: Callable


class ChipExecutable(NamedTuple):
    """One chip-granular execution state of the resource manager's table
    (§3.4.2, second granularity), bound to a disjoint (prefill side,
    decode side) split of the device group: each side's placement (its
    lead device, where one copy of the params computes) and, on the card,
    a CUDA stream of its own, so the two sides overlap as the JAX
    package's two meshes do under async dispatch. The prefill side runs
    layer groups (``("c_group", rep, Bp, S)`` graphs over the staging
    page pool) and the prompts' first tokens (``("c_final", Bp, S)``),
    the decode side continuous-batching iterations (the serial decode's
    ``("paged", n_b)`` graphs) on the decode pool; the two only meet at
    the KV handoff (kvcache.paged.transfer_pages) when a prompt finishes
    and at the host's read of the decode tokens. Switching entries is a
    dict lookup, as for FusedExecutable."""
    config_id: int
    split: SubMeshSplit
    p_placement: torch.device
    d_placement: torch.device
    p_stream: Optional[torch.cuda.Stream]     # None on the CPU
    d_stream: Optional[torch.cuda.Stream]


def _canon(d) -> torch.device:
    """``d`` as a ``torch.device`` with its card index (``cuda`` names the
    current card), so that placements compare by identity of device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def device_group(devices, device) -> List[torch.device]:
    """The device group chip granularity carves: ``devices`` as given (a
    card may be named more than once, only here), else every visible card
    for a server on ``cuda`` and the one CPU for a server on ``cpu``."""
    if devices is not None:
        return [_canon(d) for d in devices]
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _at(device: torch.device):
    """The context that makes ``device`` the current card (none on the
    CPU), so a graph of that card replays on its stream."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _to(tree, device: torch.device):
    """Every tensor of a tree of dicts and tuples on ``device``."""
    return tree_map(lambda t: t.to(device), tree)


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
    #: chip-granular cycles (disjoint-side dispatches) and KV handoffs
    #: (requests whose pages were copied from the prefill side's pool)
    chip_cycles: int = 0
    handoffs: int = 0
    #: resilience counters (docs/RESILIENCE.md): deadline/explicit
    #: cancels, backpressure sheds, transient-handoff retries, unwound
    #: prefill batches, dispatch failures absorbed, and guard lattice
    #: transitions
    cancelled: int = 0
    shed: int = 0
    handoff_retries: int = 0
    prefill_aborts: int = 0
    dispatch_failures: int = 0
    degrades: int = 0
    restores: int = 0
    #: tokens the prefill engine computed
    prefill_tokens: int = 0
    #: shared-prefix reuse (docs/KV_SHARING.md): tokens served from shared
    #: pages instead of prefilled, and admissions that hit the prefix index
    reused_prefill_tokens: int = 0
    prefix_hits: int = 0


class DecodeWork(NamedTuple):
    """What the most recent decode iteration actually executed — consumed
    by estimator feedback so the work charged is the work that ran.

    ``streamed`` is each running slot's share of the KV tokens the cache
    stream spans: ``max_slots × bucket·ps`` (paged, the bucketed table) or
    ``max_slots × max_len`` (dense, every slot's row), apportioned over the
    ``batch`` slots that ran, as in the JAX engine (the CUDA kernels
    themselves read only attended rows)."""
    batch: int
    mean_context: int
    contexts: Tuple[int, ...]             # live context per slot that ran
    streamed: Tuple[int, ...] = ()        # charged KV tokens per ran slot


@dataclass
class PrefillTask:
    """Resumable prefill state for one prompt batch (paper §3.5), padded
    to its length bucket: the activations after ``rep`` groups, persisted
    between layer-group launches so decode iterations — and new
    admissions — run between groups. Paged: KV is scattered into pooled
    pages as each group finishes (``page_map`` routes prompt blocks to
    physical pages). Dense: each group's KV lands in the batch's own
    ``tmp_cache``, copied row by row into the decode slots at migration."""
    batch: List[Request]
    x: torch.Tensor                       # activations after `rep` groups
    positions: torch.Tensor
    lengths: torch.Tensor
    page_map: Optional[torch.Tensor]      # (B, blocks) physical pages
    # x, positions, lengths and page_map are the persistent buffers of the
    # batch's (B, padded length): see BulletServer._prefill_buffers
    tmp_cache: Optional[dict] = None      # dense: (R, B, max_len, K, D)
    n_tokens: int = 0                     # total prompt tokens in the batch
    rep: int = 0                          # next pattern-repeat group to run
    #: partition granularity pinned at admission: "tile" runs the fused
    #: (or serial) co-located path, "chip" runs every layer group on the
    #: current chip entry's prefill side with a KV handoff at migration.
    #: Pinned for the task's lifetime, so pages scatter into one pool.
    granularity: str = "tile"
    #: shared-prefix reuse (docs/KV_SHARING.md): when set, ``x``,
    #: ``positions`` (B, S) and ``lengths`` cover only each request's
    #: unshared suffix (fresh tensors: the task runs eagerly), prefix_map
    #: (B, Lp) gathers the reused pages (the copy-on-write tail included),
    #: prefix_lens (B,) the reused token counts, scatter_offsets (B,) the
    #: in-page slot of each row's first suffix token
    prefix_map: Optional[torch.Tensor] = None
    prefix_lens: Optional[torch.Tensor] = None
    scatter_offsets: Optional[torch.Tensor] = None
    reused_tokens: int = 0                # sum of prefix_lens


class PrefillBuffers(NamedTuple):
    """The persistent inputs of a prompt batch of one (B, padded length)."""
    x: torch.Tensor                       # (B, S, D) activations
    positions: torch.Tensor               # (1, S) int64
    lengths: torch.Tensor                 # (B,) int32 tokens per prompt
    page_map: torch.Tensor                # (B, S / ps) int32 pages


class BulletServer:
    """Single-host Bullet serving runtime over a PyTorch model."""

    #: the eager fused repeat of a fused cycle (an attribute, so that an
    #: audit can time it apart)
    _fused_repeat = staticmethod(_fused_repeat)

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
        if cfg.pattern_tail or cfg.cross_attention:
            raise NotImplementedError(
                f"{cfg.name}: BulletServer's layer-group loop does not "
                "handle pattern_tail or cross-attention configs; use a "
                "homogeneous-pattern model")
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the server on {self.device}")
        self.device = _canon(self.device)
        if self.device.type == "cuda":
            # pinned fp32 matmul precision: no TF32 anywhere on the path
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = config
        slo: SLO = config.slo
        sched = config.control.sched or SchedulerConfig()
        dtype = config.dtype if config.dtype is not None else torch.float32
        paged = config.cache.paged
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
        #: observability sink (docs/OBSERVABILITY.md); NULL_OBS (disabled)
        #: by default: every hook is gated on ``self.obs.enabled``
        self.obs = config.obs if config.obs is not None else NULL_OBS
        #: fault-injection seam (docs/RESILIENCE.md); NULL_FAULTS by
        #: default, every seam gated on ``self.faults.enabled``
        self.faults = config.faults if config.faults is not None \
            else NULL_FAULTS
        #: retry-with-backoff policy for transient handoff failures; an
        #: attached SLOGuard installs its own
        self.handoff_policy = HandoffPolicy()
        #: the cycle event awaiting its measured duration
        self._open_cycle: Optional[CycleEvent] = None
        self.page_size = config.cache.page_size
        share_prefix = config.cache.share_prefix
        self.pool = PagedKVPool(self.max_slots * self.max_len,
                                block_size=self.page_size,
                                share_prefix=share_prefix)
        #: block-paged pool (default wherever the model can use it) or the
        #: dense fixed-slot cache
        if paged is None:
            paged = T.supports_paged_cache(cfg)
        elif paged and not T.supports_paged_cache(cfg):
            raise ValueError(f"{cfg.name}: pattern {cfg.pattern} cannot use "
                             "the block-paged cache (needs pure ATTN)")
        if share_prefix:
            if not paged:
                raise ValueError(
                    "share_prefix reuses pages of the block-paged pool; "
                    "needs paged=True (docs/KV_SHARING.md)")
            if config.execution.partition != "tile":
                raise ValueError(
                    "share_prefix requires partition='tile': chip-granular "
                    "tasks stage prompt KV in a separate per-mesh pool, "
                    "which would leave shared pages pointing at garbage")
        self.share_prefix = share_prefix
        self.paged = paged
        # fused spatial prefill+decode execution (§3.5) by default wherever
        # the cache is paged; the serial path stays as numerics reference
        if fused is None:
            fused = self.paged
        elif fused and not self.paged:
            raise ValueError(
                f"{cfg.name}: fused spatial execution streams decode KV "
                "from the block-paged pool; needs paged=True")
        self.fused = fused
        # chip-granular partitions (§3.4 second granularity,
        # docs/PARTITIONS.md): "chip" forces every prefill task onto a
        # disjoint (prefill side, decode side) split of the device group
        # with a KV handoff at migration; "auto" lets the scheduler's
        # combined-table argmin pick per task; "tile" (default) keeps the
        # one-card fused/serial paths untouched
        partition = config.execution.partition
        if partition not in ("tile", "chip", "auto"):
            raise ValueError(f"partition={partition!r}: want tile|chip|auto")
        self.partition = partition
        splits: List[SubMeshSplit] = []
        if partition in ("chip", "auto"):
            if not self.paged and partition == "chip":
                raise ValueError(
                    f"{cfg.name}: chip-granular partitions hand KV off "
                    "through the block-paged pool; needs paged=True")
            devs = device_group(config.execution.devices, self.device)
            splits = carve_submeshes(devs) if self.paged else []
            if partition == "chip" and not splits:
                raise ValueError(
                    "partition='chip' needs >= 2 devices to carve "
                    f"sub-meshes from (have {len(devs)}); pass devices= "
                    "with two or more entries (a card may be listed "
                    "twice) or use partition='auto' to fall back to tile")
        self._chip_enabled = bool(splits)
        if self._chip_enabled:
            if devs[0] != self.device:
                raise ValueError(
                    f"the device group starts at {devs[0]}, the server "
                    f"runs on {self.device}: tile and serial cycles run on "
                    "the group's first entry")
            # the estimator prices the group: a chip entry's units are
            # U * k / n_chips (core/resource.py)
            if config.est is None:
                self.est = PerfEstimator(HardwareSpec(n_chips=len(devs)))
            elif self.est.hw.n_chips != len(devs):
                raise ValueError(
                    f"the estimator's spec has n_chips="
                    f"{self.est.hw.n_chips}, the device group "
                    f"{len(devs)} entries")
        sched = replace(sched, fused=self.fused)
        self.scheduler = SLOScheduler(cfg, self.est, slo, sched)
        self.scheduler.obs = self.obs
        # pre-build one execution state per partition (§3.4.2) so _switch
        # selects among real execution states, not just numbers: fused
        # launchers for the tile half (built even when serial so
        # set_fused(True) can switch at once), stream pairs for the chip
        # half
        self.rm = ResourceManager(
            self.est.hw, sched.unit_quantum,
            builder=self._build_fused_executable,
            chip_splits=[sp.key for sp in splits],
            chip_builder=(functools.partial(self._build_chip_executable,
                                            splits=splits)
                          if splits else None))
        self.scheduler.split_candidates = [
            (p.prefill_units, p.decode_units) for p in self.rm.tile_entries]
        if self._chip_enabled:
            # the combined table: the fused-objective search prices chip
            # entries (no co-location contention + handoff) against tile
            # entries (Eq. 2 contention): disaggregation against sharing
            # as a table argmin
            self.scheduler.partition_table = self.rm.partitions
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
        self.dtype = dtype
        #: the engine steps' CUDA graphs, by static shape
        self.graphs = StepGraphs()
        #: the chip prefill side's graphs (``("c_group", ...)``,
        #: ``("c_final", ...)``): a pool of their own, as they replay on
        #: the prefill side's stream while the decode side's replay
        self.graphs_p = StepGraphs()
        #: where the decode-side state (page pool, slot buffers) lives and
        #: the params it computes with: the server's device, or under
        #: chip-enabled serving the last chip entry's decode side
        self._decode_placement = self.device
        self._d_params = params
        #: params copied to a side's placement other than the server's
        #: device, by placement
        self._side_params: Dict[torch.device, dict] = {}
        #: the prefill side's MoE metrics, summed on the device (every
        #: prefill group adds to them, its graphs on every replay); None
        #: without MoE blocks
        self.moe_stats = (MoEStats(self.device) if cfg.has_ff(MOE)
                          else None)
        self._alloc_cache()
        if self._chip_enabled:
            #: the prefill side's staging page pool: chip tasks scatter
            #: prompt KV here; transfer_pages copies the written pages into
            #: self.cache at migration
            self.cache_p = T.init_paged_cache(cfg, self.pool.n_blocks,
                                              self.page_size, dtype,
                                              self.device)
        #: the activations' dtype (the params'; ``dtype`` is the cache's)
        self._act_dtype = params["embed"].dtype
        #: the fused cycle's decode activations, updated in place
        self._x_d = torch.zeros((self.max_slots, 1, cfg.d_model),
                                dtype=self._act_dtype, device=self.device)
        #: the prefill inputs' persistent buffers, per (B, padded length)
        self._pbufs: Dict[Tuple[int, int], PrefillBuffers] = {}
        # slot bookkeeping on the host; staged into persistent device
        # buffers per iteration
        self.slot_req: List[Optional[Request]] = [None] * self.max_slots
        self.tokens = np.zeros((self.max_slots, 1), np.int32)
        self.pos = np.zeros((self.max_slots,), np.int32)
        self.active = np.zeros((self.max_slots,), bool)
        self._dev_tokens = torch.zeros((self.max_slots, 1), dtype=torch.int32,
                                       device=self.device)
        self._dev_pos = torch.zeros((self.max_slots,), dtype=torch.int32,
                                    device=self.device)
        self._dev_active = torch.zeros((self.max_slots,), dtype=torch.bool,
                                       device=self.device)
        self.graphs.keep(self._dev_tokens, self._dev_pos, self._dev_active,
                         self._x_d)
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self.outputs: Dict[int, List[int]] = {}
        #: in-flight resumable prefill (at most one batch at a time)
        self.ptask: Optional[PrefillTask] = None
        #: streaming hook: on_token(req, token, now) for every emitted token
        self.on_token: Optional[Callable[[Request, int, float], None]] = None
        #: what the most recent step() actually executed
        self.last_prefill_tokens: int = 0
        #: of which, tokens served from shared prefix pages (the cycle's
        #: prefill started at this context offset: estimator charging)
        self.last_reused_tokens: int = 0
        self.last_decode: Optional[DecodeWork] = None
        #: True when the last step ran the fused spatial cycle
        self.last_fused: bool = False
        #: config_id of the pre-built executable the last fused cycle ran
        self.last_fused_exec: Optional[int] = None
        #: True when the last step ran a chip-granular (disjoint-side)
        #: cycle; handoff_tokens > 0 on the cycle whose finished prefill
        #: copied its pages to the decode side
        self.last_chip: bool = False
        self.last_handoff_tokens: int = 0
        #: SLO watchdog (resilience.guard.SLOGuard), consulted in step();
        #: None runs ungoverned
        self.guard = config.guard
        if self.guard is not None:
            self.guard.attach(self)
        #: tenant layer (serving.tenancy.TenancyController,
        #: docs/MULTITENANCY.md): the frontend gates admissions through
        #: it, the scheduler's slack sort gains a credit-tier bias, and
        #: preemption picks its victim within the lowest-credit tenant.
        #: None keeps every path byte-identical to the single-tenant one.
        self.tenancy = config.tenancy
        if self.tenancy is not None:
            self.tenancy.attach(self)
            if self.tenancy.credit_enabled:
                self.scheduler.priority = self.tenancy.tier

    def _alloc_cache(self) -> None:
        """Allocate the device cache of the current layout. Paged: the
        unified page pool, whose PagedKVPool block ids address the pages
        directly (the trailing trash page absorbs masked writes), and the
        host block tables. Dense: one ``max_len`` row per slot. The graphs
        of the old cache go first."""
        self.graphs.drop()
        if self.paged:
            self.cache = T.init_paged_cache(self.cfg, self.pool.n_blocks,
                                            self.page_size, self.dtype,
                                            self.device)
            self.max_blocks = self.pool.blocks_for(self.max_len)
            self._trash_page = self.pool.n_blocks
            self._host_tables = np.full((self.max_slots, self.max_blocks),
                                        self._trash_page, np.int32)
            self._tables_dirty = False
            #: persistent device copies of the (sliced) host table, one per
            #: bucket width in use; copied again when ownership changes
            self._dev_tables: Dict[int, torch.Tensor] = {}
        else:
            self.cache = T.init_cache(self.cfg, self.max_slots, self.max_len,
                                      self.dtype, self.device)

    def _build_fused_executable(self, part) -> FusedExecutable:
        """ResourceManager builder: one fused-step launcher per quantized
        PartitionConfig, its decode_share bound."""
        fn = functools.partial(_fused_step, cfg=self.cfg,
                               decode_share=round(part.decode_share, 6))
        return FusedExecutable(part.config_id, part.decode_share, fn)

    def _build_chip_executable(self, part, *, splits) -> ChipExecutable:
        """ResourceManager chip builder: one execution state per chip
        split, its sides' placements and (on the card) a stream for each
        side, made once. Switching entries never rebuilds one."""
        split = find_split(splits, part.prefill_chips, part.decode_chips)
        assert split is not None, part
        p_dev = submesh_param_sharding(split.prefill_mesh)
        d_dev = submesh_cache_sharding(split.decode_mesh)
        # split k's prefill side is devices[:k], led by the group's first
        # entry, the server's device: a prefill task is built there and
        # never moves (what the JAX engine's _home_task re-homes between
        # meshes stays put)
        assert p_dev == self.device, (p_dev, self.device)
        cuda = self.device.type == "cuda"
        return ChipExecutable(
            part.config_id, split, p_dev, d_dev,
            torch.cuda.Stream(p_dev) if cuda else None,
            torch.cuda.Stream(d_dev) if cuda else None)

    # -- side placement (chip-enabled serving only) ---------------------
    def _params_for(self, device: torch.device):
        """The params on ``device``: the server's own there, else a copy
        made once per placement (the resident copies of the
        pre-configured execution states)."""
        if device == self.device:
            return self.params
        p = self._side_params.get(device)
        if p is None:
            p = self._side_params[device] = _to(self.params, device)
        return p

    def _home_decode(self, device: torch.device) -> None:
        """Re-home the decode-side state (page pool, slot buffers, block
        tables) onto ``device``: the decode side of the current chip entry,
        or the server's device for tile-granular and serial cycles. A no-op
        where it already lives, so on a group that names one card twice
        nothing moves. A move leaves every graph of ``self.graphs`` reading
        the old tensors: they are dropped (``StepGraphs.dropped`` counts
        them) and captured again on first use."""
        if not self._chip_enabled or self._decode_placement == device:
            return
        self.graphs.drop()
        if self.cache is not None:
            self.cache = _to(self.cache, device)
        self._dev_tokens = self._dev_tokens.to(device)
        self._dev_pos = self._dev_pos.to(device)
        self._dev_active = self._dev_active.to(device)
        self.graphs.keep(self._dev_tokens, self._dev_pos, self._dev_active)
        self._dev_tables = {}
        self._d_params = self._params_for(device)
        self._decode_placement = device

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
        for n_b, bt in self._dev_tables.items():
            bt.copy_(torch.from_numpy(self._host_tables[:, :n_b]))
        self._tables_dirty = False

    def _device_tables(self, n_b: int) -> torch.Tensor:
        """The persistent device buffer of the first ``n_b`` table
        columns (a graph of bucket ``n_b`` reads it), made on first use;
        ``_sync_tables`` keeps every one current."""
        bt = self._dev_tables.get(n_b)
        if bt is None:
            bt = torch.as_tensor(np.ascontiguousarray(
                self._host_tables[:, :n_b])).to(self._decode_placement)
            self._dev_tables[n_b] = bt
            self.graphs.keep(bt)
        return bt

    def _prefill_buffers(self, b: int, s: int) -> PrefillBuffers:
        """The persistent prefill buffers of a batch of ``b`` prompts
        padded to ``s`` tokens, made on first use: the graphs of that shape
        read them in place, and each admission of that shape writes them
        anew (the page map from the batch's own block tables)."""
        bufs = self._pbufs.get((b, s))
        if bufs is None:
            dev = self.device
            bufs = PrefillBuffers(
                torch.zeros((b, s, self.cfg.d_model), dtype=self._act_dtype,
                            device=dev),
                torch.arange(s, device=dev)[None, :],
                torch.zeros((b,), dtype=torch.int32, device=dev),
                torch.zeros((b, -(-s // self.page_size)), dtype=torch.int32,
                            device=dev))
            self._pbufs[(b, s)] = bufs
            self.graphs.keep(*bufs)
            self.graphs_p.keep(*bufs)
        return bufs

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
        if self.tenancy is not None:
            self.tenancy.track(req)
        if self.obs.enabled:
            self.obs.requests_submitted.inc()
            self.obs.spans.mark(req.rid, "submit", req.arrival,
                                prompt_len=req.prompt_len,
                                output_len=req.output_len)

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
            # table (both granularities); a proposal off it means
            # scheduler and resource manager have drifted apart
            assert self.rm.on_table(resources), (
                f"scheduler proposed off-table partition "
                f"({resources.granularity}: {resources.prefill_units}, "
                f"{resources.decode_units}, chips "
                f"{resources.prefill_chips}+{resources.decode_chips}); "
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

    def _written_tokens(self, r: Request) -> np.ndarray:
        """The token ids whose KV actually sits in ``r``'s pages: prompt +
        generated output minus the last sampled token (its KV is written
        by the *next* decode iteration)."""
        out = self.outputs.get(r.rid) or []
        if not out:
            return np.asarray(r._prompt, np.int32)          # type: ignore
        return np.concatenate(
            [r._prompt, np.asarray(out[:-1], np.int32)])    # type: ignore

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
        prefix. With a credit-scoring tenancy layer attached, the victim is
        the youngest *within the lowest-credit tenant* among the
        candidates (docs/MULTITENANCY.md)."""
        victims = self._preempt_candidates(req)
        if not victims:
            return False
        if self.tenancy is not None and self.tenancy.credit_enabled:
            lo = min(self.tenancy.credit_of(v) for v in victims)
            victims = [v for v in victims
                       if self.tenancy.credit_of(v) <= lo + 1e-12]
        victim = max(victims, key=lambda r: r.arrival)
        self._unwind_request(victim, now, "preempt",
                             generated=float(victim.generated))
        if self.paged:
            self._tables_dirty = True    # ownership moved back to the pool
        self.stats.preempted += 1
        return True

    def _admit_prefill(self, now: float) -> bool:
        """Form the next prompt batch from the pending queue, honoring the
        scheduler's slack-sorted reorder; on pool pressure, preempt before
        head-of-line blocking. With ``share_prefix`` a batch is all prefix
        hits (a suffix task, ``_build_shared_task``) or all misses."""
        if self.ptask is not None or not self.pending:
            return False
        if self._free_slot() is None:        # saturated: skip the slack scan
            return False
        state = self.buffer.read()
        if len(self.pending) > 1:
            self._apply_reorder(
                self.scheduler.reorder_pending(state, now,
                                               self._pending_meta()))
        share = self.paged and self.share_prefix
        batch: List[Request] = []
        batch_hit: Optional[bool] = None
        while (self.pending and len(batch) < self.max_prefill_batch
               and self._free_slot() is not None):
            r = self.pending[0]
            need = self._need_tokens(r)
            if share:
                # homogeneous batches only: hits take the suffix path,
                # misses the plain one; mixing them would pad misses to
                # hit geometry (and vice versa), perturbing the numerics
                # they must match with sharing off
                _, m_toks, cow = self.pool.match_prefix(
                    self._seq_tokens(r))
                hit = (m_toks + (cow[1] if cow else 0)) > 0
                if batch_hit is not None and hit != batch_hit:
                    break
            if not self.pool.can_admit(need):
                if batch:
                    break
                # evict only if the eligible victims' blocks actually
                # cover the shortfall — never waste decode progress (a
                # victim's shared pages survive its preemption, so only
                # sole-referenced blocks count)
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
            self.pool.allocate(r.rid, need,
                               prompt_tokens=(self._seq_tokens(r)
                                              if share else None))
            if share and batch_hit is None:
                batch_hit = hit
            if r.prefill_start is None:
                r.prefill_start = now
            r.phase = Phase.PREFILL
            self.pending.pop(0)
            batch.append(r)
            self.slot_req[slot] = r
            r._slot = slot                                  # type: ignore
            self.buffer.state.prefill.queue_wait[r.rid] = now - r.arrival
            if self.obs.enabled:
                # a request with a generated prefix re-enters after a
                # preemption: its span resumes instead of re-admitting
                self.obs.spans.mark(
                    r.rid,
                    "resume" if self.outputs.get(r.rid) else "admit",
                    now, queue_s=max(0.0, now - r.arrival))
        if not batch:
            return False

        lens = [self._resume_len(r) for r in batch]
        if share and batch_hit:
            self.ptask = self._build_shared_task(batch, lens)
        else:
            self.ptask = self._build_task(batch, lens)
        task = self.ptask
        self.stats.prefill_tokens += task.n_tokens
        self.stats.reused_prefill_tokens += task.reused_tokens
        if task.reused_tokens:
            self.stats.prefix_hits += len(batch)
            if self.obs.enabled:
                self.obs.prefix_hits.inc(len(batch))
                self.obs.prefix_reused_tokens.inc(task.reused_tokens)
        P = self.buffer.state.prefill
        P.active_rid = batch[0].rid
        P.started_at = now
        P.layers_done = 0
        P.total_layers = self.cfg.n_layers
        P.n_tokens = self.ptask.n_tokens
        P.n_waiting = len(self.pending)
        if self.obs.enabled:
            for r in batch:
                t = self.pool.table(r.rid)
                if t is not None and t.shared_tokens:
                    self.obs.spans.mark(r.rid, "prefix_hit", now,
                                        reused=float(t.shared_tokens))
        if self._chip_enabled and self.partition != "tile":
            # pin the task's granularity for its lifetime (pages scatter
            # into one pool consistently): forced under partition="chip",
            # the scheduler's combined-table argmin under "auto". A guard
            # degraded to partition="tile" keeps new tasks off the chip
            # path though the split table stays built.
            task.granularity = (
                "chip" if self.partition == "chip"
                else self.scheduler.preferred_granularity(self.buffer.state))
        return True

    def _build_task(self, batch: List[Request],
                    lens: List[int]) -> PrefillTask:
        """The PrefillTask of a batch prefilled from its first token, in
        the persistent buffers of its (B, length bucket)."""
        plen = prefill_bucket(max(lens), self.max_len, self.page_size)
        toks = np.zeros((len(batch), plen), np.int32)
        for i, r in enumerate(batch):
            toks[i, :lens[i]] = self._seq_tokens(r)
        bufs = self._prefill_buffers(len(batch), plen)
        bufs.x.copy_(T.embed_tokens(self.params, self._dev(toks), self.cfg))
        bufs.lengths.copy_(torch.from_numpy(np.asarray(lens, np.int32)))
        page_map = tmp_cache = None
        if self.paged:
            # route each request's prompt blocks to its pooled pages so
            # layer groups scatter KV in place (no handoff copy)
            self._tables_dirty = True
            ps = self.page_size
            pm = np.full(tuple(bufs.page_map.shape), self._trash_page,
                         np.int32)
            for i, r in enumerate(batch):
                blocks = self.pool.table(r.rid).blocks[:-(-lens[i] // ps)]
                pm[i, :len(blocks)] = blocks
            page_map = bufs.page_map
            page_map.copy_(torch.from_numpy(pm))
        else:
            # temporary per-batch cache (copied slot-wise at migration)
            tmp_cache = T.init_cache(self.cfg, len(batch), self.max_len,
                                     self.dtype, self.device)
        return PrefillTask(batch, bufs.x, bufs.positions, bufs.lengths,
                           page_map, tmp_cache, n_tokens=int(sum(lens)))

    def _build_shared_task(self, batch: List[Request],
                           lens: List[int]) -> PrefillTask:
        """The PrefillTask of a batch whose every row hit the prefix index
        (docs/KV_SHARING.md): activations cover only each request's
        unshared suffix, padded to the longest one, positions start at the
        reuse boundary, and the page maps split into a read-only prefix
        gather and a suffix scatter that starts mid-page, after the
        copy-on-write tail, which is copied in place here, before any
        group launches."""
        ps = self.page_size
        self._tables_dirty = True
        tables = [self.pool.table(r.rid) for r in batch]
        reused = [t.shared_tokens for t in tables]
        s_lens = [ln - ru for ln, ru in zip(lens, reused)]
        assert all(s > 0 for s in s_lens), (s_lens, reused)
        n, sp = len(batch), max(s_lens)
        toks = np.zeros((n, sp), np.int32)
        positions = np.zeros((n, sp), np.int64)
        offsets = np.zeros((n,), np.int32)
        lp = max(-(-ru // ps) for ru in reused)
        prefix_map = np.full((n, lp), self._trash_page, np.int32)
        n_sc = max(-(-((ru % ps) + sp) // ps) for ru in reused)
        page_map = np.full((n, n_sc), self._trash_page, np.int32)
        cow_src: List[int] = []
        cow_dst: List[int] = []
        for i, r in enumerate(batch):
            ru = reused[i]
            toks[i, :s_lens[i]] = self._seq_tokens(r)[ru:]
            positions[i] = ru + np.arange(sp)
            offsets[i] = ru % ps
            blocks = tables[i].blocks
            prefix_map[i, :-(-ru // ps)] = blocks[:-(-ru // ps)]
            row = blocks[ru // ps:ru // ps + n_sc]
            page_map[i, :len(row)] = row
            for s_b, d_b in tables[i].cow_pairs:
                cow_src.append(s_b)
                cow_dst.append(d_b)
        if cow_src:
            T.copy_pages(self.cache, self._dev(np.asarray(cow_src, np.int64)),
                         self._dev(np.asarray(cow_dst, np.int64)))
        return PrefillTask(
            batch, T.embed_tokens(self.params, self._dev(toks), self.cfg),
            self._dev(positions), self._dev(np.asarray(s_lens, np.int32)),
            self._dev(page_map), n_tokens=int(sum(s_lens)),
            prefix_map=self._dev(prefix_map),
            prefix_lens=self._dev(np.asarray(reused, np.int32)),
            scatter_offsets=self._dev(offsets),
            reused_tokens=int(sum(reused)))

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
        if self.faults.enabled:
            self.faults.dispatch("prefill")
        # serial launches own the whole group: tile semantics, on the
        # server's device (the pool they scatter into lives there too)
        self._home_decode(self.device)
        if task.prefix_map is not None:
            # shared-prefix suffix group, eagerly: gather the reused prefix
            # K/V, attend prefix and suffix, splice the suffix K/V in at
            # each row's in-page offset, the pool written in place
            task.x, entries = T.prefill_group_shared(
                self.params, self.cache, task.x, task.positions,
                task.prefix_map, task.prefix_lens, task.rep, self.cfg,
                task.lengths, self.moe_stats)
            T.scatter_suffix_group_pages(self.cache, entries, task.page_map,
                                         task.scatter_offsets, task.rep)
        elif self.paged:
            b, s = task.x.shape[:2]
            self.graphs(("p_group", task.rep, b, s), functools.partial(
                _prefill_group_paged, self.params, self.cache, cfg=self.cfg,
                rep=task.rep, stats=self.moe_stats), task.x, task.positions,
                task.page_map, task.lengths)
        else:
            task.x.copy_(_prefill_group(self.params, task.x, task.positions,
                                        task.tmp_cache, task.lengths,
                                        cfg=self.cfg, rep=task.rep,
                                        stats=self.moe_stats))
        self._prefill_group_done(task, now)

    def _prefill_group_done(self, task: PrefillTask, now: float) -> None:
        """Post-group bookkeeping shared by the serial and fused paths:
        advance the group cursor, publish progress, and migrate to decode
        when the last group completed."""
        task.rep += 1
        self.stats.prefill_cycles += 1
        self.last_prefill_tokens = task.n_tokens
        self.last_reused_tokens = task.reused_tokens
        P = self.buffer.state.prefill
        P.layers_done = task.rep * len(self.cfg.pattern)
        for r in task.batch:
            r.prefill_done_layers = P.layers_done
            if self.obs.enabled:
                self.obs.spans.mark(r.rid, "prefill_group", now,
                                    rep=float(task.rep - 1))
        if task.rep >= self.cfg.n_pattern_repeats:
            self._finish_prefill(task, now)
            self.ptask = None

    def _finish_prefill(self, task: PrefillTask, now: float) -> None:
        """Migrate the finished batch to decode. Paged: the KV already
        sits in pooled pages, so the handoff is pure block-table ownership
        (pool.migrate) — no device copy. Chip-granular tasks first copy the
        written pages from the prefill side's staging pool into the decode
        side's (``_handoff``). Dense: copy each request's ``max_len`` row
        of the batch cache into its decode slot, in place. Requests
        cancelled mid-prefill (``cancel_reason`` set) are finalized here
        instead: pages freed, no token emitted, no page handed off."""
        b, s = task.x.shape[:2]
        if task.granularity == "chip" and self._chip_enabled:
            ex = self.rm.executable()
            assert isinstance(ex, ChipExecutable), type(ex).__name__
            with on_stream(ex.p_stream):
                first_tokens = self.graphs_p(
                    ("c_final", b, s), functools.partial(
                        _final_tokens, self.params, cfg=self.cfg),
                    task.x, task.lengths).cpu().numpy()
            if not self._handoff(task, ex, now):
                return
        elif task.prefix_map is not None:
            first_tokens = _final_tokens(
                self.params, task.x, task.lengths,
                cfg=self.cfg).cpu().numpy()
        else:
            first_tokens = self.graphs(
                ("p_final", b, s), functools.partial(
                    _final_tokens, self.params, cfg=self.cfg),
                task.x, task.lengths).cpu().numpy()
        P = self.buffer.state.prefill
        if self.paged:
            # migrated slots flip PREFILL->DECODE: re-map their pages into
            # the device tables before the next decode iteration
            self._tables_dirty = True
        for i, r in enumerate(task.batch):
            slot = r._slot                                  # type: ignore
            if r.cancel_reason is not None:
                self.pool.free(r.rid)
                self.slot_req[slot] = None
                self._cancelled(r, now, r.cancel_reason)
                continue
            if not self.paged:
                for leaf, src in zip(self.cache["blocks"],
                                     task.tmp_cache["blocks"]):
                    for key in leaf:
                        leaf[key][:, slot].copy_(src[key][:, i])
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
            if self.share_prefix and self.paged:
                # index the freshly written pages so concurrent prompts
                # can share them before this request even finishes
                self.pool.register_prefix(r.rid, self._written_tokens(r))
            self.stats.migrated += 1
            if self.obs.enabled:
                self.obs.spans.mark(r.rid, "migrate", now)
                if prefix is None:
                    self.obs.spans.mark(r.rid, "first_token", now)
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

    def _handoff(self, task: PrefillTask, ex: ChipExecutable,
                 now: float) -> bool:
        """Copy a finished chip task's written pages (its live requests')
        from the staging pool into the decode pool, on ``ex``'s streams:
        the KV handoff the estimator charges at ``ici_bw``. A transient
        failure retries with backoff (the fault hook raises before any page
        moves, so a retry re-attempts the identical transfer); an exhausted
        budget unwinds the whole batch back to the queue and lets the guard
        leave the chip rung, and returns False."""
        live = [r for r in task.batch if r.cancel_reason is None]
        blocks: List[int] = []
        for r in live:
            blocks.extend(self.pool.written_blocks(r.rid,
                                                   self._resume_len(r)))
        fault = self.faults.handoff_hook() if self.faults.enabled else None
        attempt = 0
        while True:
            try:
                transfer_pages(self.cache_p, self.cache, blocks,
                               self._decode_placement, fault=fault,
                               streams=(ex.p_stream, ex.d_stream))
                break
            except HandoffError:
                attempt += 1
                self.stats.handoff_retries += 1
                if attempt > self.handoff_policy.max_retries:
                    self._abort_prefill_task(task, now)
                    # clear before notifying: the guard's chip degrade
                    # aborts any live chip task, and this one is torn down
                    self.ptask = None
                    if self.guard is not None:
                        self.guard.on_handoff_exhausted(self, now)
                    return False
                self.faults.charge_delay(
                    self.handoff_policy.backoff(attempt))
        self.stats.handoffs += len(live)
        self.last_handoff_tokens += sum(self._resume_len(r) for r in live)
        if self.obs.enabled:
            for r in live:
                self.obs.spans.mark(r.rid, "handoff", now,
                                    tokens=float(self._resume_len(r)))
        return True

    def _finish_request(self, r: Request, slot: int, now: float) -> None:
        r.phase = Phase.FINISHED
        r.finish_time = now
        self.finished.append(r)
        if self.tenancy is not None:
            # recompute the tenant's credit from this outcome (SLO
            # violation + TTFT tail EWMAs, docs/MULTITENANCY.md)
            self.tenancy.on_finish(r, self.slo)
        if self.obs.enabled:
            self.obs.requests_finished.inc()
            self.obs.spans.mark(r.rid, "finish", now,
                                generated=float(r.generated))
        if self.share_prefix and self.paged:
            # extend the prefix index over the decode-written pages before
            # releasing them (ref-0 indexed pages stay cached for hits)
            self.pool.register_prefix(r.rid, self._written_tokens(r))
        self.pool.free(r.rid)
        if self.paged:
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
            if self.paged:
                self._tables_dirty = True
            self.slot_req[slot] = None
            self.active[slot] = False
            D = self.buffer.state.decode
            if r.rid in D.batch:
                D.batch.remove(r.rid)
        self._cancelled(r, now, why)

    def _cancelled(self, r: Request, now: float, why: str) -> None:
        """Terminal cancel bookkeeping shared by the immediate and the
        deferred (mid-prefill) paths."""
        r.phase = Phase.CANCELLED
        r.cancel_reason = why
        r.finish_time = now
        self.stats.cancelled += 1
        if self.tenancy is not None:
            self.tenancy.on_cancel(r, why)
        if self.obs.enabled:
            self.obs.requests_cancelled.labels(why=why).inc()
            self.obs.spans.mark(r.rid, "cancel", now, why=why)
        self._drop_request_meta(r.rid)

    def _unwind_request(self, r: Request, now: float, event: str,
                        **span) -> None:
        """Return a live request to the pending queue: its pool blocks go
        back to the allocator (it re-prefills from scratch, generated
        prefix included), its slot empties."""
        self.pool.preempt(r.rid)
        slot = r._slot                                      # type: ignore
        self.slot_req[slot] = None
        self.active[slot] = False
        r.phase = Phase.QUEUED
        self.pending.append(r)
        if self.obs.enabled:
            self.obs.spans.mark(r.rid, event, now, **span)
        D = self.buffer.state.decode
        if r.rid in D.batch:
            D.batch.remove(r.rid)
        self._drop_request_meta(r.rid)

    def _abort_prefill_task(self, task: PrefillTask, now: float) -> None:
        """Unwind an in-flight prefill batch without migrating: release
        every request's pages and requeue the survivors (they re-prefill
        from scratch deterministically, like a preemption); requests
        already marked for cancellation end here. The caller clears
        ``self.ptask``."""
        for r in task.batch:
            if r.cancel_reason is not None:
                slot = r._slot                              # type: ignore
                self.slot_req[slot] = None
                self.active[slot] = False
                self.pool.free(r.rid)
                self._cancelled(r, now, r.cancel_reason)
                continue
            self._unwind_request(r, now, "abort", rep=float(task.rep))
        self.stats.prefill_aborts += 1
        if self.paged:
            self._tables_dirty = True
        P = self.buffer.state.prefill
        P.active_rid = None
        P.layers_done = 0
        P.n_tokens = 0

    def set_fused(self, flag: bool) -> None:
        """Flip fused spatial co-execution on/off at a cycle boundary (the
        guard's fused→serial rung). The scheduler's contention model
        follows the execution mode."""
        if flag == self.fused:
            return
        if flag and not self.paged:
            raise ValueError("fused execution needs the paged cache")
        self.fused = flag
        self.scheduler.sc = replace(self.scheduler.sc, fused=flag)

    def set_cache_mode(self, paged: bool, now: float) -> None:
        """Swap between the block-paged pool and the dense fixed-slot
        layout (the guard's paged→dense rung, and its restore). The two
        layouts share no device state, so all in-flight work is unwound
        first: the prefill batch aborts back to the queue and every decode
        slot is preempted with its generated prefix; both re-enter through
        normal admission and re-prefill deterministically. The old cache is
        released before the new one is allocated, so the two never sit on
        the card at once."""
        if paged == self.paged:
            return
        assert not self.fused, "degrade fused→serial before paged→dense"
        if paged and not T.supports_paged_cache(self.cfg):
            raise ValueError(f"{self.cfg.name}: cannot restore the paged "
                             "cache (pattern needs pure ATTN)")
        if self.ptask is not None:
            self._abort_prefill_task(self.ptask, now)
            self.ptask = None
        for r in self.slot_req:
            if r is None:
                continue
            self._unwind_request(r, now, "preempt",
                                 generated=float(r.generated))
            self.stats.preempted += 1
        if self.share_prefix:
            # the pages behind the prefix index are about to be
            # reinitialized: drop the index and the cached pages. Every
            # table was just unwound, so no page has several live readers
            # (flush_shared refuses otherwise)
            self.pool.flush_shared()
        self.paged = paged
        self.graphs.drop()
        self.cache = None
        self._dev_tables = {}
        # the new cache is allocated on the server's device: the slot
        # buffers go home with it
        self._home_decode(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._alloc_cache()

    def check_invariants(self) -> None:
        """Crash-on-corruption audit, run by chaos replays after every
        cycle: pool block ownership is a partition of allocated pages;
        every pool owner is a live request (fault-injected pool-squeeze
        phantoms are accounted); slot bookkeeping agrees with request
        phases; live spans are well-ordered."""
        self.pool.check_invariants()
        owners = set(self.pool.owners())
        holders = {r.rid for r in self.slot_req if r is not None}
        if self.ptask is not None:
            holders |= {r.rid for r in self.ptask.batch}
        phantoms = self.faults.phantom_rids() if self.faults.enabled \
            else set()
        leaked = owners - holders - phantoms
        assert not leaked, (
            f"pool pages leaked: rids {sorted(leaked)} own blocks but are "
            f"neither in a slot, the prefill batch, nor fault phantoms")
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
        if self.obs.enabled:
            self.obs.spans.check_invariants()

    # -- decode engine ----------------------------------------------------
    def _decode_inputs(self):
        """(ctxs_ran, streamed, device tensors) for one iteration: the live
        context of each slot that runs, the KV tokens charged to each, and
        tokens, pos, active and (paged) the bucketed block tables — None
        for the dense cache — staged in the persistent buffers."""
        ctxs_ran = tuple(int(p) + 1 for p, a in zip(self.pos, self.active)
                         if a)
        n_ran = len(ctxs_ran)
        if self.paged:
            if self._tables_dirty:
                self._sync_tables()
            n_b = self._decode_block_bucket(ctxs_ran)
            span = n_b * self.page_size
            bt = self._device_tables(n_b)
        else:
            span, bt = self.max_len, None
        streamed = (span * self.max_slots // max(n_ran, 1),) * n_ran
        self._dev_tokens.copy_(torch.from_numpy(self.tokens))
        self._dev_pos.copy_(torch.from_numpy(self.pos))
        self._dev_active.copy_(torch.from_numpy(self.active))
        dev = (self._dev_tokens, self._dev_pos, self._dev_active, bt)
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
        if self.faults.enabled:
            self.faults.dispatch("decode")
        # decode-only cycles run wherever the decode state already lives
        # (the server's device at first, the last chip entry's decode side
        # between chip tasks): re-homing is left to the cycle kinds that
        # need a placement, so the page pool never ping-pongs between
        # sides across task boundaries, traffic the estimator's handoff
        # charge does not cover
        with _at(self._decode_placement):
            self._run_decode(now)
        return True

    def _run_decode(self, now: float) -> None:
        """One decode iteration on the current stream, through the graph of
        its table bucket (or the dense cache's), and its bookkeeping."""
        act_np = self.active.copy()
        ctxs_ran, streamed, (tokens, pos, active, bt) = self._decode_inputs()
        if bt is None:
            next_tokens, _ = self.graphs(("dense",), self._decode_step,
                                         tokens, pos, active)
        else:
            next_tokens, _ = self.graphs(("paged", bt.shape[1]),
                                         self._decode_step, tokens, pos,
                                         active, bt)
        self._finish_decode_iteration(next_tokens, act_np, ctxs_ran,
                                      streamed, now)

    def _decode_step(self, tokens, pos, active, block_tables=None):
        """``_decode_iteration`` on the decode side's params and the
        current cache: the step the server's graphs capture."""
        return _decode_iteration(self._d_params, self.cache, tokens, pos,
                                 active, block_tables, cfg=self.cfg)

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
        if self.faults.enabled:
            self.faults.dispatch("fused")
        # tile-granular fused cycle: both phases on the server's device
        self._home_decode(self.device)
        act_np = self.active.copy()
        ctxs_ran, streamed, (tokens, pos, active, bt) = self._decode_inputs()
        next_tokens, _ = ex.fn(
            self.graphs, self.params, self.cache, task.x, task.positions,
            task.page_map, self._x_d, tokens, pos, active, bt, rep=task.rep,
            fused_repeat=self._fused_repeat, lengths=task.lengths,
            stats=self.moe_stats)
        self.last_fused = True
        self.last_fused_exec = ex.config_id
        self.stats.fused_cycles += 1
        # decode-side bookkeeping first, prefill-side after: slots that
        # finish prefill this cycle take their first decode step next cycle
        self._finish_decode_iteration(next_tokens, act_np, ctxs_ran,
                                      streamed, now)
        self._prefill_group_done(task, now)
        return True

    # -- chip engine (disjoint-side co-execution, §3.4) -------------------
    @contextlib.contextmanager
    def _sides(self, ex: ChipExecutable):
        """Bracket a chip cycle's work on ``ex``'s side streams: each
        starts after the work already queued on its card's current stream,
        and that stream waits for both before any later work (a tile cycle,
        the next admission's writes, the next chip cycle's sides). No host
        synchronization: within the cycle the two sides overlap."""
        pairs = [(st, torch.cuda.current_stream(st.device))
                 for st in (ex.p_stream, ex.d_stream) if st is not None]
        for st, cur in pairs:
            st.wait_stream(cur)
        try:
            yield
        finally:
            for st, cur in pairs:
                cur.wait_stream(st)

    def _chip_cycle(self, now: float) -> bool:
        """One chip-granular engine cycle: the prefill layer group and the
        decode iteration run on DISJOINT sides of the device group, each
        on its own stream, so they overlap (the estimator charges the max
        of the sides). One scheduling cycle covers both phases, restricted
        to the chip half of the table; the §3.3.3 pause never fires (decode
        owns its side: nothing to borrow). Prefill scatters prompt KV into
        the staging pool; a finished prompt's pages are copied to the
        decode side in ``_finish_prefill``. Only the handoff and the host's
        read of the decode tokens wait on the sides."""
        task = self.ptask
        state = self.buffer.read()
        decision = self.scheduler.schedule(state, now, self._pending_meta(),
                                           granularity="chip")
        self._apply_reorder(decision.reorder)
        self._switch(decision.resources)
        ex = self.rm.executable()
        assert isinstance(ex, ChipExecutable), (
            f"chip task but executable {type(ex).__name__} for config "
            f"{self.rm.current}")
        # both chip seams fire before any device work: the prefill group
        # advances task.x, so a later raise would apply the group twice
        # when the cycle retries at the same ``rep``
        did_decode = bool(self.active.any())
        if self.faults.enabled:
            self.faults.dispatch("chip_prefill")
            if did_decode:
                self.faults.dispatch("chip_decode")
        # the decode side's placement first: a move is queued on the
        # current stream, which the sides wait for
        self._home_decode(ex.d_placement)
        with self._sides(ex):
            b, s = task.x.shape[:2]
            with on_stream(ex.p_stream):
                self.graphs_p(("c_group", task.rep, b, s), functools.partial(
                    _prefill_group_paged, self.params, self.cache_p,
                    cfg=self.cfg, rep=task.rep, stats=self.moe_stats),
                    task.x, task.positions, task.page_map, task.lengths)
            self.last_chip = True
            self.stats.chip_cycles += 1
            if did_decode:
                # the host's read of the tokens waits for this side alone
                with on_stream(ex.d_stream):
                    self._run_decode(now)
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
        if self.last_chip:
            return CycleObservation(
                "chip", self.last_prefill_tokens,
                max(R.prefill_units, 1), max(R.decode_units, 1),
                w.batch if w is not None else 0,
                max(w.mean_context, 1) if w is not None else 1,
                (tuple(w.streamed) or None) if w is not None else None,
                handoff_tokens=self.last_handoff_tokens)
        if self.last_fused and w is not None and self.last_prefill_tokens:
            return CycleObservation(
                "fused", self.last_prefill_tokens,
                max(R.prefill_units, 1), max(R.decode_units, 1),
                max(w.batch, 1), max(w.mean_context, 1),
                tuple(w.streamed) or None,
                reused_tokens=self.last_reused_tokens)
        return CycleObservation(
            "serial", self.last_prefill_tokens,
            R.prefill_units, R.decode_units,
            w.batch if w is not None else 0,
            max(w.mean_context, 1) if w is not None else 1,
            (tuple(w.streamed) or None) if w is not None else None,
            reused_tokens=self.last_reused_tokens)

    def record_cycle_actual(self, actual_s: float) -> None:
        """Feed the measured duration of the cycle the last step() ran:
        logs one (kind, predicted, actual) pair and hands the observation
        to the OnlineRefitter; refits happen inside step()."""
        obs = self.last_cycle_observation()
        if obs is None or actual_s <= 0:
            return
        pred = predict_cycle(self.est, self.cfg, obs)
        self.pred_actual.append((obs.kind, pred, actual_s))
        if self.guard is not None:
            self.guard.on_cycle_actual(self, obs.kind, pred, actual_s)
        if self.obs.enabled and self._open_cycle is not None:
            self.obs.complete_cycle(self._open_cycle, actual_s)
            self._open_cycle = None
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

    # -- observability (docs/OBSERVABILITY.md) ----------------------------
    def _record_cycle_event(self, now: float) -> None:
        """Append the cycle that step() just executed to the structured
        trace: kind, the partition that ran, predicted duration (the
        actual arrives via record_cycle_actual), handoff bytes, KV-pool
        occupancy and the scheduler's rationale. No-op when the step ran
        no device work."""
        self._open_cycle = None
        rec = self.last_cycle_observation()
        if rec is None:
            return
        R = self.buffer.state.resources
        d = self.scheduler.last_decision
        ev = CycleEvent(
            t=now, kind=rec.kind,
            predicted_s=predict_cycle(self.est, self.cfg, rec),
            config_id=R.config_id, granularity=R.granularity,
            prefill_units=R.prefill_units, decode_units=R.decode_units,
            prefill_chips=R.prefill_chips, decode_chips=R.decode_chips,
            prefill_tokens=self.last_prefill_tokens,
            decode_batch=(self.last_decode.batch
                          if self.last_decode is not None else 0),
            handoff_tokens=self.last_handoff_tokens,
            handoff_bytes=int(analytics.kv_transfer_bytes(
                self.cfg, self.last_handoff_tokens))
            if self.last_handoff_tokens else 0,
            kv_used_blocks=self.pool.allocated_blocks,
            kv_total_blocks=self.pool.n_blocks,
            kv_occupancy=self.pool.occupancy(),
            kv_fragmentation=self.pool.fragmentation(),
            paused=self.buffer.state.decode.paused,
            reason=d.reason if d is not None else "")
        self.obs.record_cycle(ev)
        self._open_cycle = ev

    # -- main loop --------------------------------------------------------
    def step(self, now: float) -> bool:
        """One engine cycle at time ``now``: admit newly-pending prompts,
        launch one prefill layer group, run one decode iteration — as a
        single fused cycle when both phases are co-resident (and the
        engine runs fused), as serial back-to-back launches otherwise.
        Returns True if any engine did work."""
        if self.guard is not None:
            self.guard.before_step(self, now)
        try:
            did = self._step_inner(now)
        except DispatchError as e:
            if self.guard is None:
                raise
            # the cycle's work is lost, but the seam raised before the
            # cycle's first launch or in-place write of that kind; the
            # guard counts the failure and degrades once failures persist
            self.guard.on_dispatch_failure(self, e, now)
            did = True
        if self.obs.enabled:
            self._record_cycle_event(now)
        return did

    def _step_inner(self, now: float) -> bool:
        self._maybe_refit()
        if self.faults.enabled:
            self.faults.begin_cycle(self)
        self.last_prefill_tokens = 0
        self.last_reused_tokens = 0
        self.last_decode = None
        self.last_fused = False
        self.last_chip = False
        self.last_handoff_tokens = 0
        did_admit = self._admit_prefill(now)
        if self.ptask is not None and self.ptask.granularity == "chip":
            # chip-pinned task: every layer group runs on its prefill
            # side, with the decode iteration concurrent on the other
            return self._chip_cycle(now) or did_admit
        # a shared-prefix suffix task always runs serially
        if (self.fused and self.ptask is not None
                and self.ptask.prefix_map is None and self.active.any()):
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
