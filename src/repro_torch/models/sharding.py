"""Sharding policy: maps a ModelConfig onto a mesh shape (the policy half
of the JAX package's ``models/sharding.py``, as plain data).

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

A mesh here is its shape alone (``launch/mesh.MeshShape``: axis names and
sizes), and a partition spec is a :class:`Spec`: one entry per dim of its
leaf, a mesh axis name, a tuple of names or None (replicated). Nothing
places a tensor on several devices yet: the sharded runtime (DTensor, the
collectives, the sequence-parallel decode and the sharded MoE) comes with
ROADMAP §1 item 8d. The per-sub-mesh placements of chip granularity
(``submesh_param_sharding``, ``submesh_cache_sharding``) place a side's
whole copy on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig


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
    mesh: object                        # launch/mesh.MeshShape
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
