"""InternVL2-76B — VLM: InternViT vision encoder (STUB) + InternLM2-like LM.

[arXiv:2404.16821] LM backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. Vision frontend (InternViT-6B + MLP projector) is a STUB per
spec: input_specs() provides precomputed patch embeddings prepended to the
token sequence.
"""

from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    pattern=(BlockSpec(mixer=ATTN, ff=MLP),),
    frontend_embed_len=256,        # stubbed ViT patch embeddings per image
    frontend_embed_dim=3200,       # InternViT-6B output dim (projector -> d_model)
    rope_theta=1_000_000.0,
    long_context_window=8192,
    citation="arXiv:2404.16821 (InternVL2)",
))
