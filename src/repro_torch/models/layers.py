"""Shared building blocks: norms, RoPE, gated MLP, initializers.

Numerics follow the JAX package's ``models/layers.py`` op for op: RMSNorm
scales by ``(1 + scale)`` in fp32, RoPE rotates split halves in fp32."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding.

    x: (..., S, H, D); positions: broadcastable to (..., S) integer.
    """
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, x.device)             # (D/2,)
    ang = positions.float()[..., None] * inv_freq               # (..., S, D/2)
    ang = ang[..., None, :]                                     # (..., S, 1, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gated_mlp(x: torch.Tensor, wi: torch.Tensor,
              wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP; wi: (D, 2F) fused gate|up, wo: (F, D)."""
    h = x @ wi
    gate, up = h.chunk(2, dim=-1)
    return (F.silu(gate) * up) @ wo


# ---------------------------------------------------------------------------
# Initializers: the same distributions as the JAX package (normal, fp32,
# then cast), drawn from an explicit torch.Generator — no bit parity with
# jax.random, so parity tests bridge the JAX params instead.
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    fan_in = fan_in or shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)
