"""Param trees (nested dicts and tuples of tensors) walked in the order
``jax.tree_util`` flattens them: dict keys sorted, tuple and list items in
order. A leaf's path is a tuple of dict keys (str) and sequence indices
(int), so the port names each leaf as the JAX package does: its
checkpoint key (``blocks/0/wq``) and the path string that its weight-decay
mask reads (``blocks/[0]/wq``)."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_paths(tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` (in flatten
    order)."""
    return _build(like, iter(new_leaves))


def _build(t, it):
    # a module-level function: a recursive closure would reference itself
    # through its cell, and that cycle would keep the iterator, and so
    # every leaf (a step's gradients), alive until the garbage collector ran
    if isinstance(t, dict):
        out = {k: _build(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}          # keep the caller's key order
    if isinstance(t, (tuple, list)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure)."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])


def checkpoint_key(path: Path) -> str:
    """The JAX checkpoint's key of a leaf: every path entry's key or
    index, joined by ``/``."""
    return "/".join(str(k) for k in path)


def mask_name(path: Path) -> str:
    """The string the JAX optimizer's ``_wd_mask`` builds from a path:
    dict keys as they are, a sequence index as ``jax.tree_util``'s
    ``SequenceKey`` prints it (``[0]``), joined by ``/``."""
    return "/".join(k if isinstance(k, str) else f"[{k}]" for k in path)
