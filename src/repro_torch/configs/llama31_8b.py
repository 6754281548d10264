"""Llama-3.1-8B — the paper's own evaluation model (Bullet §4.1).

[arXiv:2407.21783] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
Used for the paper-faithful baselines and the serving benchmarks.
"""

from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.1-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    pattern=(BlockSpec(mixer=ATTN, ff=MLP),),
    rope_theta=500_000.0,
    long_context_window=8192,
    citation="arXiv:2407.21783 (Llama 3.1); Bullet paper §4.1",
))
