"""Sharding: the policy that maps a ModelConfig onto a mesh (the JAX
package's ``models/sharding.py``, as plain data) and the runtime that
places each leaf by its spec and computes over the mesh's ranks (the
``shard_map`` half, ROADMAP §1 item 8d).

The rules are the JAX package's:

- activations: batch over data axes ("pod","data"); hidden replicated
  unless a tensor-parallel op's output (then over "model").
- attention: heads over "model" iff divisible; otherwise attention
  weights replicated on "model" (Megatron divisibility fallback).
- GQA KV heads: shard over "model" iff divisible; else the decode KV
  cache is sharded over the *sequence* dim on "model" (sequence-parallel
  decode).
- MLP: d_ff over "model".
- MoE: experts over "model" iff divisible, else per-expert d_ff over
  "model".
- vocab: over "model" iff divisible, else replicated.

A partition spec is a :class:`Spec`: one entry per dim of its leaf, a
mesh axis name, a tuple of names or None (replicated). A policy's mesh is
a shape (``launch/mesh.MeshShape``: the dry-run's residency) or a running
mesh (``launch/mesh.RankMesh``: one rank of a ``torch.distributed``
group).

The runtime. Every rank computes on plain local tensors (the kernels are
``ctypes`` calls on raw pointers, which DTensor cannot dispatch), so the
collectives GSPMD inserts are explicit here, all in this module:

- placement: :func:`shard_tree` cuts each leaf over the mesh axes its spec
  names (a tuple of axes as one split, in the group order of
  ``RankMesh.coord``), so a rank holds ``launch/specs.sharded_resident_gb``'s
  bytes; :func:`gather_tree` reassembles the full tree. A packed leaf is
  split section by section, so each rank holds the same columns of every
  section: the gated MLP's ``wi`` (D, 2F) = gate | up, the shared
  expert's ``shared_wi``, MoE ``w_in`` (E, D, 2F) and RG-LRU ``w_in`` (D,
  2W) = branch | gate; SSD's ``in_proj`` (D, 2·di + 2N + H) = z | x | B |
  C | dt and its ``conv`` (K, di + 2N) and conv state = x | B | C. Every
  section is split, B and C too: they are shared by every head, so each
  rank all-gathers them after its local columns (and its local conv
  channels); nothing is held twice.
- the collectives of ``jax.lax`` over a named axis or a tuple of axes:
  :func:`psum`, :func:`pmax`, :func:`pmean`, :func:`all_gather`,
  :func:`axis_index`; and, for the gradients, the Megatron autograd
  functions: :func:`copy_to` (identity forward, all-reduce backward: a
  replicated tensor entering rank-local work), :func:`reduce_from`
  (all-reduce forward, identity backward: rank-local partial sums whose
  result every rank uses alike), :func:`psum_shared` (all-reduce both
  ways: a sum whose result each rank uses on its own shard),
  :func:`gather_from` (all-gather forward, slice backward),
  :func:`gather_sum` (all-gather forward, reduce-scatter backward: FSDP's
  weights and gathered activations each rank uses on its own shard) and
  :func:`split_to` (slice forward, all-gather backward). A group of one
  rank is skipped. Those backwards are the model axis's, where every rank
  computes the same loss. Over the data axes each rank's loss is its rows'
  share of the whole and its gradients are shares, summed over the data
  axes at the end of the step (``training/trainer.py``); there the
  backwards are the collectives' transposes: a sum's gradient is summed,
  a gather's reduce-scattered, a split's padded with zeros, and a
  replicated tensor's passes unchanged.
- the matmul rule (:func:`tp_matmul`): a weight split on its contraction
  dim gives a partial product, summed by ``psum`` (row parallel); a weight
  split on its output dim gives local output columns, all-gathered where
  the next op needs them whole (column parallel).
- accounting: each collective adds its bytes by type to
  :data:`COLLECTIVES` (always) and to the roofline counter while one runs
  (``kernels/cost.COUNTER``: ``collective_bytes`` and
  ``collective_count``, the JAX report's fields; an all-reduce moves twice
  its bytes, an all-gather its output's, a reduce-scatter its input's).
  Under gloo a card's tensor is copied to the host and back around each
  call, and :data:`COLLECTIVES` counts every staged copy.

The per-sub-mesh placements of chip granularity
(``submesh_param_sharding``, ``submesh_cache_sharding``) place a side's
whole copy on one device.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import SSD, ModelConfig
from repro_torch.kernels import cost
from repro_torch.launch.mesh import axis_tuple


class Spec(tuple):
    """A leaf's partition spec, the counterpart of
    ``jax.sharding.PartitionSpec``: ``Spec(None, "model")`` shards a
    matrix's columns over the "model" axis. A tuple, so a tree of specs
    marks its leaves by type. A one-name tuple entry is that name, as
    ``PartitionSpec`` canonicalizes it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple)
                                     and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def map_specs(fn: Callable[[Spec], Any], tree) -> Any:
    """``fn`` over the :class:`Spec` leaves of a tree of dicts, tuples and
    named tuples, the tree's structure kept."""
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def spec_leaves(tree) -> List[Spec]:
    """The :class:`Spec` leaves of a tree in ``jax.tree_util``'s flatten
    order (dict keys sorted, sequence items in order), the order of
    ``training/tree.leaves`` over the matching tensor tree."""
    if isinstance(tree, Spec):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    return [s for v in tree for s in spec_leaves(v)]


@dataclass(frozen=True)
class ShardingPolicy:
    mesh: object                        # launch/mesh.MeshShape or RankMesh
    data_axes: Tuple[str, ...]          # e.g. ("pod", "data") or ("data",)
    model_axis: Optional[str]           # "model" or None
    shard_heads: bool
    shard_kv_heads: bool
    shard_experts: bool
    shard_vocab: bool
    seq_parallel_decode: bool           # KV-cache sequence sharded on model axis
    shard_batch: bool                   # batch divisible by prod(data axes)
    fsdp: bool = False                  # additionally shard params over "data"
    #: token-parallel MoE dispatch (serving); training takes the einsum
    #: path, as in the JAX package
    moe_token_shard_map: bool = True
    #: 2D expert-weight sharding (experts over model, d_ff over data): the
    #: serving-decode default for MoE archs in the JAX dry-run
    moe_2d_weights: bool = False

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model_axis] if self.model_axis else 1

    @property
    def data_size(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= self.mesh.shape[a]
        return n


def make_policy(cfg: ModelConfig, mesh, *, global_batch: int = 0,
                fsdp: bool = False, moe_token_shard_map: bool = True,
                moe_2d_weights: bool = False) -> ShardingPolicy:
    axis_names = mesh.axis_names
    model_axis = "model" if "model" in axis_names else None
    data_axes = tuple(a for a in ("pod", "data") if a in axis_names)
    m = mesh.shape[model_axis] if model_axis else 1
    dsz = 1
    for a in data_axes:
        dsz *= mesh.shape[a]

    shard_heads = bool(cfg.n_heads) and cfg.n_heads % m == 0
    shard_kv = bool(cfg.n_kv_heads) and cfg.n_kv_heads % m == 0
    # sequence-parallel decode when KV heads cannot span the model axis
    seq_par = bool(cfg.n_kv_heads) and not shard_kv and m > 1
    shard_experts = cfg.n_experts > 0 and cfg.n_experts % m == 0
    shard_vocab = cfg.vocab_padded % m == 0
    shard_batch = global_batch == 0 or (global_batch % dsz == 0
                                        and global_batch >= dsz)

    return ShardingPolicy(
        mesh=mesh,
        data_axes=data_axes,
        model_axis=model_axis,
        shard_heads=shard_heads,
        shard_kv_heads=shard_kv,
        shard_experts=shard_experts,
        shard_vocab=shard_vocab,
        seq_parallel_decode=seq_par,
        shard_batch=shard_batch,
        fsdp=fsdp,
        moe_token_shard_map=moe_token_shard_map,
        moe_2d_weights=moe_2d_weights,
    )


# ---------------------------------------------------------------------------
# Per-sub-mesh placements (chip-granular partitions, launch/submesh.py)
# ---------------------------------------------------------------------------

def submesh_param_sharding(mesh: Sequence[Any]):
    """Parameter placement for one side of a chip-granular split: the
    side's lead device, its first entry. The JAX package replicates the
    params over every device of the side and each computes the same
    values; here one copy on the lead device computes them, so the
    results, and the token streams, are the same. Each side runs its
    phase with its own resident copy (the pre-configured execution state
    of §3.4.2: no cross-side traffic but the explicit KV handoff)."""
    return torch.device(mesh[0])


def submesh_cache_sharding(mesh: Sequence[Any]):
    """KV-page-pool placement on a side: its lead device, like the
    params. Copying pages from the prefill side's pool onto the decode
    side's placement is the handoff (kvcache/paged.py ``transfer_pages``)
    charged to the interconnect. (The same placement as the params today;
    kept apart so placing the pool differently within a side stays a
    one-function change.)"""
    return torch.device(mesh[0])


def with_fsdp(spec: Spec, policy: ShardingPolicy) -> Spec:
    """Try to additionally shard the first unsharded dim over data axes."""
    if not policy.fsdp or not policy.data_axes:
        return spec
    parts = list(spec)
    for i, p in enumerate(parts):
        if p is None:
            parts[i] = policy.data_axes
            return Spec(*parts)
    return spec


# ---------------------------------------------------------------------------
# The runtime: collectives over a RankMesh's named axes
# ---------------------------------------------------------------------------

def axis_size(mesh, axes) -> int:
    """The ranks along ``axes`` (1 for none, with or without a mesh)."""
    return math.prod(mesh.shape[a] for a in axis_tuple(axes))


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes``: ``jax.lax.axis_index`` (a tuple of
    axes counts as one, in its group's order; 0 for none)."""
    axes = axis_tuple(axes)
    return mesh.coord(axes) if axes else 0


class CollectiveStats:
    """Bytes and calls of every collective this process ran, by type (the
    roofline's traffic: twice an all-reduce's bytes, an all-gather's
    output, a reduce-scatter's input), and the host copies a gloo group on
    a card staged (bytes and copies, both ways)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.staged_bytes = 0
        self.staged_copies = 0

    def read(self) -> dict:
        return {"bytes": dict(self.bytes), "count": dict(self.count),
                "staged_bytes": self.staged_bytes,
                "staged_copies": self.staged_copies}


#: this process's collectives (reset by the caller)
COLLECTIVES = CollectiveStats()

_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(kind: str, x: torch.Tensor, mesh, axes,
                op: str = "sum") -> torch.Tensor:
    """One collective over the group of ``axes`` on dim 0 of ``x``, out of
    place: ``all-reduce``, ``all-gather`` (the ranks' blocks in group
    order) or ``reduce-scatter`` (this rank's block of the sum). A gloo
    group on a card stages ``x`` and the result through the host."""
    n = axis_size(mesh, axes)
    group = mesh.group(axis_tuple(axes))
    x = x.detach().contiguous()
    shape = tuple(x.shape)
    if kind == "all-gather":
        shape = (n * shape[0],) + shape[1:]
    elif kind == "reduce-scatter":
        shape = (shape[0] // n,) + shape[1:]
    out_bytes = math.prod(shape) * x.element_size()
    traffic = {"all-reduce": 2 * out_bytes, "all-gather": out_bytes,
               "reduce-scatter": _nbytes(x)}[kind]
    COLLECTIVES.bytes[kind] = COLLECTIVES.bytes.get(kind, 0) + traffic
    COLLECTIVES.count[kind] = COLLECTIVES.count.get(kind, 0) + 1
    counter = cost.COUNTER
    with (counter.collective(kind, traffic, _nbytes(x) + out_bytes)
          if counter is not None else contextlib.nullcontext()):
        src = x.cpu() if mesh.staged else x
        if kind == "all-reduce":
            buf = src.clone() if src is x else src
            dist.all_reduce(buf, _OPS[op], group=group)
        else:
            buf = src.new_empty(shape)
            if kind == "all-gather":
                _ALL_GATHER(buf, src, group=group)
            else:
                dist.reduce_scatter_tensor(buf, src, _OPS[op], group=group)
        if mesh.staged:
            buf = buf.to(x.device)
            COLLECTIVES.staged_bytes += _nbytes(x) + out_bytes
            COLLECTIVES.staged_copies += 2
    return buf


def _on_dim(kind: str, x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """An all-gather or reduce-scatter along ``dim``."""
    dim = dim % x.dim()
    y = _collective(kind, x.movedim(dim, 0), mesh, axes)
    return y.movedim(0, dim)


def _reduce(x, mesh, axes, op: str = "sum"):
    return _collective("all-reduce", x, mesh, axes, op)


def _reduce_any(x, mesh, axes, op: str = "sum"):
    """An all-reduce over ``axes``; over one axis after another when the
    mesh has no group for the tuple."""
    axes = axis_tuple(axes)
    if axis_size(mesh, axes) == 1:
        return x
    if len(axes) > 1 and not mesh.has_group(axes):
        for a in axes:
            x = _reduce_any(x, mesh, (a,), op)
        return x
    return _reduce(x, mesh, axes, op)


def psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (no gradient)."""
    return _reduce_any(x, mesh, axes)


def pmax(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axes``."""
    return _reduce_any(x, mesh, axes, "max")


def pmean(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axes`` (no gradient)."""
    n = axis_size(mesh, axes)
    return x if n == 1 else _reduce_any(x, mesh, axes) / n


def all_gather(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """The ranks' ``x`` of ``axes`` concatenated along ``dim`` in group
    order (no gradient)."""
    if axis_size(mesh, axes) == 1:
        return x
    return _on_dim("all-gather", x, dim, mesh, axes)


def _local(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes``."""
    n = axis_size(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * size, size)


#: the mesh axes a batch is split over; every other axis (the model axis)
#: splits a tensor's own dims
DATA_AXES = ("pod", "data")


def _split_axes(axes):
    """(the model part, the data part) of ``axes``."""
    axes = axis_tuple(axes)
    return (tuple(a for a in axes if a not in DATA_AXES),
            tuple(a for a in axes if a in DATA_AXES))


def _sum_over(g, mesh, axes):
    return g if axis_size(mesh, axes) == 1 else _reduce(g, mesh, axes)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, _split_axes(axes)[0]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, _split_axes(axes)[1]
        return _reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.mesh, ctx.axes), None, None


class _PsumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, scatter):
        ctx.dim, ctx.mesh, ctx.axes, ctx.scatter = dim, mesh, axes, scatter
        return _on_dim("all-gather", x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            out = _on_dim("reduce-scatter", g, ctx.dim, ctx.mesh, ctx.axes)
        else:
            out = _local(g, ctx.dim, ctx.mesh, ctx.axes).contiguous()
        return out, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, pad):
        ctx.dim, ctx.mesh, ctx.axes, ctx.pad = dim, mesh, axes, pad
        ctx.size = x.shape[dim]
        return _local(x, dim, mesh, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.pad:
            out = g.new_zeros(g.shape[:ctx.dim % g.dim()] + (ctx.size,)
                              + g.shape[ctx.dim % g.dim() + 1:])
            _local(out, ctx.dim, ctx.mesh, ctx.axes).copy_(g)
        else:
            out = _on_dim("all-gather", g, ctx.dim, ctx.mesh, ctx.axes)
        return out, None, None, None, None


def _pure(axes) -> bool:
    """Whether ``axes`` are all data axes (else all model axes)."""
    model, data = _split_axes(axes)
    if model and data:
        raise ValueError(f"{axes}: a gather or split over model and data "
                         "axes at once")
    return bool(data)


def copy_to(x, axes, mesh):
    """Identity; the gradient is summed over the model axes of ``axes`` (a
    replicated tensor entering each rank's own work)."""
    return x if axis_size(mesh, axes) == 1 else _CopyTo.apply(x, mesh, axes)


def reduce_from(x, axes, mesh):
    """The sum over ``axes`` of each rank's partial ``x``. The gradient
    passes unchanged over the model axes (every rank of them uses the sum
    alike) and is summed over the data axes (each data rank's gradient is
    its own rows' share)."""
    return x if axis_size(mesh, axes) == 1 else _ReduceFrom.apply(x, mesh,
                                                                  axes)


def psum_shared(x, axes, mesh):
    """The sum over ``axes``, its gradient summed too (each rank of the
    model axes uses the sum on its own shard)."""
    return x if axis_size(mesh, axes) == 1 else _PsumShared.apply(x, mesh,
                                                                  axes)


def gather_from(x, dim: int, axes, mesh):
    """All-gather along ``dim``. Over the model axis the gradient is this
    rank's block (every rank uses the whole alike); over the data axes it
    is reduce-scattered (each data rank's gradient is its share)."""
    if axis_size(mesh, axes) == 1:
        return x
    return _Gather.apply(x, dim, mesh, axes, _pure(axes))


def gather_sum(x, dim: int, axes, mesh):
    """All-gather along ``dim``, the gradient reduce-scattered: FSDP's
    weights, and a gathered activation each rank of the model axis uses
    for its own shard (SSD's B and C, the RG-LRU branch)."""
    if axis_size(mesh, axes) == 1:
        return x
    return _Gather.apply(x, dim, mesh, axes, True)


def split_to(x, dim: int, axes, mesh):
    """This rank's block along ``dim`` of a replicated ``x``. Over the
    model axis the gradient is all-gathered; over the data axes it is
    zero outside the block (each data rank's gradient is its share)."""
    if axis_size(mesh, axes) == 1:
        return x
    return _Split.apply(x, dim, mesh, axes, _pure(axes))


# ---------------------------------------------------------------------------
# A sharded call's view of its policy, and the matmul rule
# ---------------------------------------------------------------------------

class TP:
    """What a sharded model call reads of its policy: the model axis (None
    when it has one rank), its size ``m`` and this rank's index ``r`` on
    it, the data axes and their size, and the batch axes (the data axes
    when the batch is sharded)."""

    def __init__(self, policy: ShardingPolicy):
        mesh = policy.mesh
        self.policy = policy
        self.mesh = mesh
        self.m = policy.model_size
        self.model = policy.model_axis if self.m > 1 else None
        self.r = axis_index(mesh, self.model)
        self.data = tuple(policy.data_axes)
        self.dsz = policy.data_size
        self.bax = self.data if policy.shard_batch else ()

    @staticmethod
    def of(policy: Optional[ShardingPolicy]) -> Optional["TP"]:
        """None unless ``policy`` runs over more than one rank (the JAX
        conditions' ``policy.mesh.size > 1``). A mesh's shape alone
        (``MeshShape``) runs nothing, and a call given one raises rather
        than compute unsharded."""
        if policy is None or policy.mesh is None or policy.mesh.size == 1:
            return None
        if not hasattr(policy.mesh, "group"):
            raise ValueError(f"a {policy.mesh.name} mesh shape runs no "
                             "ranks: make the policy on a RankMesh "
                             "(launch/mesh.run_on_mesh)")
        return TP(policy)

    # -- shortcuts over the model axis ----------------------------------
    def copy(self, x):
        return copy_to(x, self.model, self.mesh)

    def reduce(self, x):
        return reduce_from(x, self.model, self.mesh)

    def gather(self, x, dim: int = -1):
        return gather_from(x, dim, self.model, self.mesh)

    def gather_sum(self, x, dim: int = -1):
        return gather_sum(x, dim, self.model, self.mesh)

    def split(self, x, dim: int = -1):
        return split_to(x, dim, self.model, self.mesh)


def tp_matmul(x, w, tp: Optional[TP], split: Optional[str], *,
              x_local: bool = False, gather: bool = False):
    """``x @ w`` by the matmul rule. ``split``: the dim of ``w`` that is
    split over the model axis, ``"out"`` (column parallel: local output
    columns, all-gathered when ``gather``) or ``"in"`` (row parallel: the
    partial product over this rank's rows of ``w``, summed; ``x_local``:
    ``x`` holds this rank's columns already, else its block is taken), or
    None (``w`` whole)."""
    if tp is None or tp.model is None or split is None:
        return x @ w
    if split == "out":
        y = tp.copy(x) @ w
        return tp.gather(y) if gather else y
    xs = x if x_local else tp.split(x)
    return tp.reduce(xs @ w)


# ---------------------------------------------------------------------------
# Placement: a tree's leaves cut by their specs, and put back together
# ---------------------------------------------------------------------------

def leaf_sections(cfg: ModelConfig, name: str, n: int) -> Tuple[int, ...]:
    """The sections of a leaf's last dim of size ``n``, by the leaf's name:
    the halves of a fused gate | up (``wi``, ``shared_wi``, MoE and RG-LRU
    ``w_in``), SSD's z | x | B | C | dt (``in_proj``) and x | B | C
    (``conv``, the weight and the conv state); one section otherwise."""
    if name in ("wi", "shared_wi", "w_in"):
        return (n // 2, n // 2)
    if cfg is not None and cfg.has_mixer(SSD):
        di, ns, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
        if name == "in_proj" and n == 2 * di + 2 * ns + h:
            return (di, di, ns, ns, h)
        if name == "conv" and n == di + 2 * ns:
            return (di, ns, ns)
    return (n,)


def _split_dim(t, dim: int, n: int, idx: int, sections) -> torch.Tensor:
    if any(s % n for s in sections):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} (sections "
                         f"{sections}) does not split over {n} ranks")
    parts, off = [], 0
    for s in sections:
        parts.append(t.narrow(dim, off + idx * (s // n), s // n))
        off += s
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def shard_leaf(t: torch.Tensor, spec: Spec, mesh,
               sections=None) -> torch.Tensor:
    """This rank's shard of the full leaf ``t`` under ``spec`` (a view
    where one exists); the last dim cut section by section."""
    for dim, part in enumerate(spec):
        n = axis_size(mesh, part)
        if n == 1:
            continue
        secs = (sections if sections and dim == t.dim() - 1
                else (t.shape[dim],))
        t = _split_dim(t, dim, n, axis_index(mesh, part), secs)
    return t


def gather_leaf(t: torch.Tensor, spec: Spec, mesh,
                sections=None) -> torch.Tensor:
    """The full leaf from every rank's shard ``t`` (the inverse of
    :func:`shard_leaf`; a collective: every rank calls it)."""
    for dim, part in enumerate(spec):
        n = axis_size(mesh, part)
        if n == 1:
            continue
        full = all_gather(t, dim, part, mesh)
        if sections and dim == t.dim() - 1 and len(sections) > 1:
            pieces = full.chunk(n, dim)
            cols = [p.split([s // n for s in sections], dim) for p in pieces]
            full = torch.cat([torch.cat([c[i] for c in cols], dim)
                              for i in range(len(sections))], dim)
        t = full
    return t


def _walk(tree, specs, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(tree[k], specs[k], fn, path + (k,)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(v, s, fn, path + (i,)) for i, (v, s)
                            in enumerate(zip(tree, specs))))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, s, fn, path + (i,)) for i, (v, s)
                          in enumerate(zip(tree, specs)))
    return fn(path, tree, specs)


def _leaf_name(path) -> str:
    names = [k for k in path if isinstance(k, str)]
    return names[-1] if names else ""


def shard_tree(tree, specs, mesh, cfg: Optional[ModelConfig] = None):
    """Each rank's local tree: every leaf of ``tree`` (params, a cache, a
    train state, inputs) cut by its spec in ``specs`` (same structure),
    packed leaves section by section (:func:`leaf_sections` of ``cfg``),
    each shard copied out of the full leaf."""
    def cut(path, t, spec):
        secs = leaf_sections(cfg, _leaf_name(path), t.shape[-1]) \
            if t.dim() else None
        return shard_leaf(t, spec, mesh, secs).clone()
    return _walk(tree, specs, cut)


def gather_tree(tree, specs, mesh, cfg: Optional[ModelConfig] = None):
    """The full tree from each rank's local ``tree`` (every rank calls it;
    each gets the whole)."""
    def join(path, t, spec):
        secs = None
        if t.dim():
            last = spec[t.dim() - 1] if len(spec) >= t.dim() else None
            secs = leaf_sections(cfg, _leaf_name(path),
                                 t.shape[-1] * axis_size(mesh, last))
        return gather_leaf(t, spec, mesh, secs)
    return _walk(tree, specs, join)


def spec_at(specs, path):
    """The spec of the leaf at ``path`` (dict keys and sequence indices)."""
    for k in path:
        specs = specs[k]
    return specs
