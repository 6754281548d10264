"""Checkpointing: a flat ``.npz`` with tree-path keys, the JAX package's
``training/checkpoint.py`` format, so a checkpoint either package writes
loads in the other.

Each leaf is stored under its path's key (``blocks/0/wq``:
``tree.checkpoint_key``) beside ``__meta__``, a JSON string with the
step, the caller's ``extra`` and the sorted keys. The arrays are the
leaves' values on the host in their dtype; a bf16 leaf (numpy has no
bf16) is stored as float32, which holds it exactly, and is rounded back
to the dtype of the tree it is loaded into.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.training.tree import (checkpoint_key, leaves_with_paths,
                                       unflatten)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {checkpoint_key(path): _host(leaf)
            for path, leaf in leaves_with_paths(tree)}


def save_checkpoint(path: str, params, step: int = 0, extra: dict = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(params)
    meta = {"step": step, "extra": extra or {},
            "keys": sorted(flat)}
    np.savez(path, __meta__=json.dumps(meta), **flat)


def load_checkpoint(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (from ``init_params``): each
    leaf on its ``like`` leaf's device, in its dtype. Returns (tree,
    step)."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        restored = []
        for leaf_path, leaf in leaves_with_paths(like):
            key = checkpoint_key(leaf_path)
            arr = data[key]
            assert arr.shape == tuple(leaf.shape), (key, arr.shape,
                                                    tuple(leaf.shape))
            restored.append(torch.from_numpy(arr).to(device=leaf.device,
                                                      dtype=leaf.dtype))
    return unflatten(like, restored), meta["step"]
