"""Model registry of the PyTorch port: the ``ModelConfig`` system copied
from the JAX package, with the models the port serves registered: the
dense pure-attention ones of the paged Bullet path (``qwen3-1.7b``,
``llama3.1-8b``), the attention-free ``mamba2-2.7b`` on the dense slot
cache, and the RG-LRU / sliding-window hybrid ``recurrentgemma-2b``, which,
as in the JAX package, only the models-level ``prefill`` / ``decode_step``
serve (``BulletServer`` refuses its ``pattern_tail``)."""

from repro_torch.configs.base import (
    ATTN, SWA, RGLRU, SSD, MLP, MOE,
    BlockSpec, InputShape, ModelConfig, INPUT_SHAPES,
    get_config, list_configs, register,
)
