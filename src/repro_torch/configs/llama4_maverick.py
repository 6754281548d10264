"""Llama-4 Maverick 400B-A17B — interleaved MoE, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E family] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + 1 shared expert, MoE on every
other layer (interleave_moe_layer_step=2), dense MLP (d_ff=16384) otherwise.
"""

from repro_torch.configs.base import ATTN, MLP, MOE, BlockSpec, ModelConfig, register

_DENSE = BlockSpec(mixer=ATTN, ff=MLP)
_MOE = BlockSpec(mixer=ATTN, ff=MOE)

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                     # per-expert hidden
    vocab_size=202_048,
    pattern=(_DENSE, _MOE),        # interleaved MoE every other layer
    n_experts=128,
    n_experts_per_token=1,         # top-1 routing
    n_shared_experts=1,
    moe_capacity_factor=1.25,
    qkv_bias=False,
    rope_theta=500_000.0,
    long_context_window=8192,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E (Maverick variant)",
))
