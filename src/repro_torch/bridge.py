"""Bridge the JAX package's parameter and page-pool trees into the port.

Both sides use the same tree: ``{"embed", "final_norm", ["lm_head"],
"blocks": ({name: (R, ...)}, ...)}`` for params and ``{"blocks": ({"k",
"v"}: (R, P+1, ps, K, D), ...)}`` for the page pool. The caller converts
the JAX tree to numpy first (``jax.tree.map(np.asarray, tree)``), so this
module imports no JAX; nesting and the stacked repeat axis R are kept.
"""

from __future__ import annotations

import numpy as np
import torch


def _tree_to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_to_torch(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_tree, device="cpu", dtype=torch.float32):
    """The JAX param tree (numpy leaves) as the port's params."""
    return _tree_to_torch(np_tree, device, dtype)


def cache_from_jax(np_tree, device="cpu", dtype=torch.float32):
    """The JAX block-paged pool (numpy leaves) as the port's page pool."""
    return _tree_to_torch(np_tree, device, dtype)
