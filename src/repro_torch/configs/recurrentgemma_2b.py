"""RecurrentGemma-2B — Griffin-style hybrid: RG-LRU + local attention.

[arXiv:2402.19427] 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
Layout: the Griffin 2:1 recurrent-to-local-attention pattern (R, R, L)
repeated 8 times plus the truncated final period (R, R) — exactly the
released 26-layer model.
"""

from repro_torch.configs.base import MLP, SWA, RGLRU, BlockSpec, ModelConfig, register

_R = BlockSpec(mixer=RGLRU, ff=MLP)
_L = BlockSpec(mixer=SWA, ff=MLP)

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    pattern=(_R, _R, _L),          # 2:1 recurrent:local, x8
    pattern_tail=(_R, _R),         # truncated final period -> 26 layers
    sliding_window=2048,           # local attention window (paper: 2k)
    long_context_window=2048,
    rglru_lru_width=2560,
    rglru_conv_width=4,
    rope_theta=10_000.0,
    tie_embeddings=True,
    citation="arXiv:2402.19427 (RecurrentGemma / Griffin)",
))
