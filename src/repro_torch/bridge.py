"""Bridge the JAX package's parameter and cache trees into the port.

Both sides use the same tree: ``{"embed", "final_norm", ["lm_head"],
["frontend_proj"], "blocks": ({name: (R, ...)}, ...), ["tail_blocks":
({name: (...)}, ...)], ["encoder": {name: (n_encoder_layers, ...)},
"encoder_norm"]}`` for params, ``{"blocks": ({"k", "v"}: (R, P+1, ps, K,
D), ...)}`` for the page pool and ``{"blocks": ({"k", "v"}: (R, B, S, K,
D) | {"conv", "ssm"} | {"conv", "hidden"}, ...), ["tail": (... without
R)], ["cross": {"k", "v"}: (R, B, Se, K, D)]}`` for the dense slot cache
(``cross``: an encoder-decoder model's encoder K/V per repeat). The caller converts the JAX tree to numpy first
(``jax.tree.map(np.asarray, tree)``), so this module imports no JAX;
nesting and the stacked repeat axis R are kept. Each leaf gets the dtype
the port's ``init_params`` / ``init_cache`` give it: ``dtype``, or fp32
for the leaves named in ``FP32_PARAMS`` / ``FP32_CACHE``: Mamba-2's
``A_log`` and RG-LRU's ``lambda``, whose decays compound their rounding
along the sequence (the gates read both in fp32), and the recurrent
states ``ssm`` and ``hidden``, which the JAX cache holds in fp32 too.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import FP32_CACHE, FP32_PARAMS


def _tree_to_torch(tree, device, dtype, fp32_keys, key=None):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype, fp32_keys, k)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_to_torch(v, device, dtype, fp32_keys, key)
                          for v in tree)
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    return t.to(device=device,
                dtype=torch.float32 if key in fp32_keys else dtype)


def params_from_jax(np_tree, device="cuda", dtype=torch.float32):
    """The JAX param tree (numpy leaves) as the port's params, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return _tree_to_torch(np_tree, device, dtype, FP32_PARAMS)


def cache_from_jax(np_tree, device="cuda", dtype=torch.float32):
    """A JAX cache tree (numpy leaves), the block-paged pool or the dense
    slot cache, as the port's, on ``device`` (the card unless the caller
    asks for the CPU)."""
    return _tree_to_torch(np_tree, device, dtype, FP32_CACHE)
