"""Model registry of the PyTorch port: the ``ModelConfig`` system copied
from the JAX package, with the models the port serves registered: the
dense pure-attention ones of the paged Bullet path (``qwen3-1.7b``,
``llama3.1-8b``, and the multi-head ``qwen1.5-4b`` and ``codeqwen1.5-7b``),
the mixture-of-experts ``llama4-maverick-400b-a17b`` (paged) and
``mixtral-8x22b`` (sliding window, so on the dense slot cache), the
attention-free ``mamba2-2.7b`` on the dense slot cache, and the RG-LRU /
sliding-window hybrid ``recurrentgemma-2b``, which, as in the JAX package,
only the models-level ``prefill`` / ``decode_step`` serve
(``BulletServer`` refuses its ``pattern_tail``); ``granite-3-2b`` (head dim
64, paged), the encoder-decoder ``seamless-m4t-large-v2`` (which
``BulletServer`` refuses, as it does cross-attention) and the VLM
``internvl2-76b``, whose stub frontend the models-level ``prefill`` and
``forward`` prepend. Every config of the JAX package is registered."""

from repro_torch.configs.base import (
    ATTN, SWA, RGLRU, SSD, MLP, MOE,
    BlockSpec, InputShape, ModelConfig, INPUT_SHAPES,
    get_config, list_configs, register,
)
