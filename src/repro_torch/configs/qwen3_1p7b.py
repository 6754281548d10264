"""Qwen3-1.7B — dense GQA with qk_norm.

[hf:Qwen/Qwen3-8B arch family] 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936.
"""

from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    pattern=(BlockSpec(mixer=ATTN, ff=MLP),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    long_context_window=8192,
    citation="hf:Qwen/Qwen3-8B (1.7B config)",
))
