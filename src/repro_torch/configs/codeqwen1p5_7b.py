"""CodeQwen1.5-7B — dense, qwen1.5 architecture (QKV bias, MHA kv=32).

[hf:Qwen/CodeQwen1.5-7B] 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416.
"""

from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13_440,
    vocab_size=92_416,
    pattern=(BlockSpec(mixer=ATTN, ff=MLP),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    long_context_window=8192,
    citation="hf:Qwen/CodeQwen1.5-7B",
))
