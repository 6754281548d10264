"""Hand-written CUDA kernels for the attention of the Bullet serving path
(prefill flash attention, decode attention over the page pool and over a
dense per-slot cache, and the fused bullet launches that split the SMs
between prefill and either decode) and for the recurrent scans (Mamba-2's
SSD chunk scan, the RG-LRU linear recurrence), with their wrappers, launch
counters and plain PyTorch versions, and the backward of the flash prefill
(a ``torch.autograd.Function``; the other wrappers refuse a gradient on
the card). ``build.py`` compiles ``csrc/`` with ``nvcc``
on first use; nothing here builds or imports CUDA at import."""
