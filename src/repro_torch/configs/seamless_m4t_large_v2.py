"""SeamlessM4T-Large v2 — encoder-decoder multimodal (audio backbone).

[arXiv:2308.11596] 24L (decoder) d_model=1024 16H (kv=16, i.e. MHA)
d_ff=8192 vocab=256206. Speech frontend (mel + conformer feature extractor)
is a STUB per spec: input_specs() provides precomputed frame embeddings; the
transformer encoder consumes them, the text decoder cross-attends.
"""

from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                   # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    pattern=(BlockSpec(mixer=ATTN, ff=MLP),),
    cross_attention=True,
    encoder_seq_len=1024,          # stubbed speech-frame embedding length
    frontend_embed_len=1024,
    frontend_embed_dim=1024,
    long_context_window=8192,
    citation="arXiv:2308.11596 (SeamlessM4T v2)",
))
