"""Mixtral-8x22B — MoE, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
8 experts top-2. SWA per the Mistral lineage.
"""

from repro_torch.configs.base import MOE, SWA, BlockSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=32_768,
    pattern=(BlockSpec(mixer=SWA, ff=MOE),),
    n_experts=8,
    n_experts_per_token=2,
    moe_capacity_factor=1.25,
    sliding_window=4096,
    long_context_window=4096,
    rope_theta=1_000_000.0,
    citation="arXiv:2401.04088 (Mixtral)",
))
