"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 64L d_model=2560, d_ff=0 (the SSD block subsumes the MLP),
vocab=50280, ssm_state=128, expand=2, head_dim=64.
"""

from repro_torch.configs.base import SSD, BlockSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    pattern=(BlockSpec(mixer=SSD, ff="none"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    citation="arXiv:2405.21060 (Mamba-2 / SSD)",
))
