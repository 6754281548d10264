"""Mamba-2 SSD (state-space duality) block.

Chunked formulation (arXiv:2405.21060 §6): the sequence is split into chunks
of length Q; within-chunk outputs use the quadratic "attention" form with a
causal decay mask, across-chunk contributions flow through the recurrent
state h ∈ (B, H, P, N). Prefill runs it through ``ops.ssd_scan_op``, so on
the card every prefill group goes through the hand-written SSD kernel; a
chunk of a prompt (chunked prefill) continues from the state the chunks
before it left, the kernel's starting state.

Decode is the pure recurrence: h ← da·h + dt·(B ⊗ x); y = C·h + D·x, in
plain PyTorch (the JAX package has no kernel for it either).

A padded prompt batch (``lengths``) gets each row's state at its own
length: ``dt`` is 0 at padded positions, so the scan carries the state
through the padding unchanged, and the conv state is the K-1 conv inputs
ending at the row's last token. The JAX package's prefill returns the state
after the padded tail instead (ROADMAP §3).

Sharded (``tp``, ROADMAP §1 item 8d): ``in_proj`` and ``conv`` hold this
rank's columns of every section (``models/sharding.py``), so z, x and dt
are its own heads' and B and C its block of the state dim, all-gathered
after the (depthwise) conv; kernel 6 runs on the rank's heads with the
whole B and C, the gated norm's mean square is summed over the ranks,
and ``out_proj`` is row parallel. Every section must split evenly, the
heads too (the JAX package's condition for splitting them): a leaf that
does not is refused when it is placed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import ssd_scan_op
from repro_torch.models import sharding as SH
from repro_torch.models.layers import causal_conv1d, conv_state_at


class SSDState(NamedTuple):
    conv: torch.Tensor       # (B, K-1, d_conv_channels)
    ssm: torch.Tensor        # (B, H, P, N) fp32


def ssd_chunked(x, dt, A, B_, C, D, *, chunk: int, state0=None):
    """Chunked SSD scan from ``state0`` (B,H,P,N) (zeros without it).

    x:  (B, S, H, P)   values (post-conv)
    dt: (B, S, H)      positive step sizes (post-softplus)
    A:  (H,)           negative decay rates
    B_: (B, S, N)      input projections (shared across heads, n_groups=1)
    C:  (B, S, N)      output projections
    D:  (H,)           skip
    Returns (y (B,S,H,P), final_state (B,H,P,N) fp32)."""
    return ssd_scan_op(x, dt, A, B_, C, D, chunk=chunk, state0=state0)


def ssd_decode_step(x, dt, A, B_, C, D, state):
    """Single-token recurrence.

    x: (B,1,H,P), dt: (B,1,H), B_/C: (B,1,N), state: (B,H,P,N) fp32."""
    da = torch.exp(dt[:, 0] * A[None, :])                    # (B,H)
    xw = x[:, 0] * dt[:, 0][..., None]                       # (B,H,P)
    upd = torch.einsum("bhp,bn->bhpn", xw.float(), B_[:, 0].float())
    new_state = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C[:, 0].float())
    y = y + x[:, 0].float() * D[None, :, None]
    return y[:, None].to(x.dtype), new_state


def ssd_block(x, params, cfg, *, state: Optional[SSDState] = None,
              decode: bool = False, lengths=None, tp=None):
    """Full Mamba-2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    x: (B, S, D). Returns (y, new_state). ``state`` starts the conv and the
    scan from a given state (decode, or a chunk of a prompt that continues
    one: chunked prefill). ``lengths`` (B,) marks a padded prefill batch:
    each row's returned state is the state after its own ``lengths[b]``
    tokens. ``tp`` (``models/sharding.TP``): this rank's shards (the
    module docstring); the state is its shard too.
    params: in_proj (D, 2*di + 2*N + H), conv (K, di+2N), A_log (H,),
            D (H,), dt_bias (H,), norm (di,), out_proj (di, D)."""
    sharded = tp is not None and tp.model is not None
    m = tp.m if sharded else 1
    b, s, _ = x.shape
    di = cfg.ssm_d_inner
    n = cfg.ssm_state
    h = cfg.ssm_n_heads
    p = cfg.ssm_head_dim

    zxbcdt = (tp.copy(x) if sharded else x) @ params["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di // m, (di + 2 * n) // m, h // m],
                             dim=-1)
    conv_state = state.conv if state is not None else None
    xbc_in = xbc
    xbc, new_conv = causal_conv1d(xbc, params["conv"], conv_state)
    xs, B_, C = torch.split(xbc, [di // m, n // m, n // m], dim=-1)
    if sharded:
        # each rank's own heads read the whole B and C
        B_, C = tp.gather_sum(B_), tp.gather_sum(C)
    hl = h // m
    dt = F.softplus(dt.float() + params["dt_bias"].float()[None, None, :])
    A = -torch.exp(params["A_log"].float())                  # (H,) negative
    xs = xs.reshape(b, s, hl, p)
    D = params["D"].float()

    if decode:
        assert state is not None
        y, new_ssm = ssd_decode_step(xs, dt, A, B_, C, D, state.ssm)
    else:
        if lengths is not None:
            # dt = 0 past each row's length: the scan carries the state
            # through the padding unchanged
            valid = (torch.arange(s, device=x.device)[None, :]
                     < lengths.to(x.device)[:, None])
            dt = torch.where(valid[..., None], dt, 0.0)
            new_conv = conv_state_at(xbc_in, lengths.to(x.device),
                                     params["conv"].shape[0], conv_state)
        y, new_ssm = ssd_chunked(xs, dt, A, B_, C, D, chunk=cfg.ssm_chunk,
                                 state0=None if state is None
                                 else state.ssm)

    y = y.reshape(b, s, hl * p)
    # gated RMSNorm (mamba2); split heads sum their mean square over ranks
    yf = y.float() * F.silu(z.float())
    if sharded:
        var = SH.psum_shared(yf.square().sum(dim=-1, keepdim=True),
                             tp.model, tp.mesh) / di
    else:
        var = yf.square().mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + cfg.rmsnorm_eps)
    yf = yf * (1.0 + params["norm"].float())
    out = SH.tp_matmul(yf.to(x.dtype), params["out_proj"], tp, "in",
                       x_local=True)
    return out, SSDState(new_conv, new_ssm)
