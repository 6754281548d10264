"""Model registry of the PyTorch port: the ``ModelConfig`` system copied
from the JAX package, with the dense pure-attention models the paged
Bullet path serves registered (``qwen3-1.7b``, ``llama3.1-8b``)."""

from repro_torch.configs.base import (
    ATTN, SWA, RGLRU, SSD, MLP, MOE,
    BlockSpec, InputShape, ModelConfig, INPUT_SHAPES,
    get_config, list_configs, register,
)
