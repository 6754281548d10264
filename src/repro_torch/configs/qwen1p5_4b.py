"""Qwen1.5-4B — dense MHA with QKV bias.

[hf:Qwen/Qwen1.5-0.5B arch family] 40L d_model=2560 20H (GQA kv=20)
d_ff=6912 vocab=151936.
"""

from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    pattern=(BlockSpec(mixer=ATTN, ff=MLP),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    long_context_window=8192,
    citation="hf:Qwen/Qwen1.5-0.5B (4B config)",
))
