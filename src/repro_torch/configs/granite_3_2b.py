"""Granite-3.0-2B — dense GQA.

[hf:ibm-granite/granite-3.0-2b-base] 40L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=49155.
"""

from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    pattern=(BlockSpec(mixer=ATTN, ff=MLP),),
    tie_embeddings=True,
    rope_theta=10_000.0,
    long_context_window=8192,
    citation="hf:ibm-granite/granite-3.0-2b-base",
))
