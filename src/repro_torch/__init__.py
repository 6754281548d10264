"""PyTorch/CUDA port of the Bullet serving system for one NVIDIA H100.

Mirrors the layout of the JAX package (``configs/``, ``core/``,
``kvcache/``, ``models/``, ``kernels/``, ``serving/``, ``launch/``) and
imports neither JAX nor anything of that package. The attention kernels
on the serving path are hand-written CUDA C++ for ``sm_90a``
(``kernels/csrc/``); a wrapper launches its kernel for CUDA tensors and
takes the plain PyTorch version only for CPU tensors.
"""
