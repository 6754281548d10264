"""Hand-written CUDA kernels for the attention of the Bullet serving path
(prefill flash attention, paged decode attention, and the fused bullet
launch that splits the SMs between them), with their wrappers, launch
counters and plain PyTorch versions. ``build.py`` compiles ``csrc/`` with
``nvcc`` on first use; nothing here builds or imports CUDA at import."""
