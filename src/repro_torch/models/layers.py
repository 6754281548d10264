"""Shared building blocks: norms, RoPE, gated MLP, causal conv and the conv
state at each row's length, initializers.

Numerics follow the JAX package's ``models/layers.py`` op for op: RMSNorm
scales by ``(1 + scale)`` in fp32, RoPE rotates split halves in fp32."""

from __future__ import annotations

import itertools
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


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv followed by SiLU.

    x: (B, S, C), w: (K, C). If ``state`` (B, K-1, C) is given, it is the
    left context (decode); returns (y, new_state), ``new_state`` the last
    K-1 rows of the left context and ``x``."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                    # (B, S+K-1, C)
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, s:] if k > 1 else state
    return F.silu(y), new_state


def conv_state_at(x: torch.Tensor, lengths: torch.Tensor, k: int,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K-1, C): the K-1 conv inputs ending at each row's last token
    (position ``lengths[b] - 1`` of ``x`` (B, S, C)), with ``state`` (B,
    K-1, C) as the left context before position 0 (zeros without it): the
    conv state of a padded prefill batch, row by row at its own length
    (shared by the SSD and RG-LRU blocks)."""
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)        # (B, K-1+S, C)
    idx = lengths.long()[:, None] + torch.arange(k - 1, device=x.device)
    return torch.gather(xp, 1, idx[..., None].expand(-1, -1, x.shape[2]))


# ---------------------------------------------------------------------------
# Initializers: the same distributions as the JAX package (normal, fp32,
# then cast), drawn from an explicit torch.Generator — no bit parity with
# jax.random, so parity tests bridge the JAX params instead.
# ---------------------------------------------------------------------------

#: a leaf of more elements than this is drawn one leading slice at a time
#: (one expert of a full-width MoE weight: Llama-4 Maverick's ``w_in`` of
#: 128 experts would otherwise take a 43 GB fp32 temporary beside its 21.5
#: GB bf16 self); every smaller leaf is drawn whole, as before
DRAW_LIMIT = 1 << 31


def _normal(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    shape = tuple(shape)
    if math.prod(shape) <= DRAW_LIMIT:
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (w * std).to(dtype)
    lead = 1
    while math.prod(shape[lead:]) > DRAW_LIMIT:
        lead += 1
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for idx in itertools.product(*map(range, shape[:lead])):
        out[idx] = _normal(gen, shape[lead:], dtype, std)
    return out


def dense_init(gen: torch.Generator, shape, dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    fan_in = fan_in or shape[0]
    return _normal(gen, shape, dtype, 1.0 / math.sqrt(fan_in))


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return _normal(gen, shape, dtype, 0.02)
