"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)              recurrence gate
    i_t = sigmoid(W_x x_t + b_x)              input gate
    a_t = exp(-c * softplus(Lambda) * r_t)    (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates run in fp32, as in the JAX package. Prefill runs the linear
recurrence h_t = a_t h_{t-1} + b_t through ``ops.rglru_scan_op``, so on the
card every RG-LRU prefill goes through the hand-written scan kernel, which
also returns the fp32 final state; decode is one elementwise step in plain
PyTorch (the JAX package has no kernel for it either). The full block is
conv1d + RG-LRU inside a GeGLU-style gate, with the tanh approximation of
GELU that ``jax.nn.gelu`` defaults to.

A padded prompt batch (``lengths``) gets each row's state at its own
length: a_t = 1 and b_t = 0 past the length, so the scan carries the state
through the padding unchanged, and the conv state is the K-1 conv inputs
ending at the row's last token. The JAX block ignores lengths and returns
the state after the padded tail (ROADMAP §3).

Sharded (``tp``, ROADMAP §1 item 8d): the width W is split over the model
axis (``_rglru_specs``): ``w_in`` holds this rank's columns of the branch
and of the gate, ``conv`` its channels, ``w_a`` / ``w_x`` its output
columns; the branch is all-gathered for the two gate products, the
recurrence (kernel 7) runs on the rank's channels, and ``w_out`` is row
parallel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import rglru_scan_op
from repro_torch.models import sharding as SH
from repro_torch.models.layers import causal_conv1d, conv_state_at

_C = 8.0   # Griffin's fixed exponent scale


class RGLRUState(NamedTuple):
    conv: torch.Tensor       # (B, K-1, W)
    hidden: torch.Tensor     # (B, W) fp32


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    switch to the identity above a threshold (``F.softplus`` has one)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(x, params, x_all=None):
    """x: (B,S,W) -> a (B,S,W) fp32, gated input b (B,S,W) fp32.
    ``x_all``: the whole width, the gate products' input, when ``x`` is
    this rank's channels (sharded)."""
    xf = x.float()
    xa = xf if x_all is None else x_all.float()
    r = torch.sigmoid(xa @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(xa @ params["w_x"].float() + params["b_x"].float())
    log_a = -_C * r * _softplus(params["lambda"].float())
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated_x


def rglru_scan(x, params, h0: Optional[torch.Tensor] = None, lengths=None,
               x_all=None):
    """Linear-recurrence scan. x: (B,S,W). Returns (y (B,S,W) in x's dtype,
    h_T (B,W) fp32). With ``lengths`` (B,) row b's h_T is its state after
    ``lengths[b]`` steps (a = 1, b = 0 past it)."""
    a, b = _gates(x, params, x_all)
    if lengths is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])[..., None]
        a = torch.where(valid, a, 1.0)
        b = torch.where(valid, b, 0.0)
    y, h_t = rglru_scan_op(a, b, h0)
    return y.to(x.dtype), h_t


def rglru_step(x, params, h0, x_all=None):
    """Single decode step. x: (B,1,W), h0: (B,W) fp32."""
    a, b = _gates(x, params, x_all)
    h = a[:, 0] * h0 + b[:, 0]
    return h[:, None].to(x.dtype), h


def rglru_block(x, params, cfg, *, state: Optional[RGLRUState] = None,
                decode: bool = False, lengths=None, tp=None):
    """Full Griffin recurrent block.

    x: (B,S,D) (already layer-normed). params: w_in (D, 2W), conv (K, W),
    w_a/w_x (W,W), b_a/b_x (W,), lambda (W,), w_out (W, D). ``state``
    starts the recurrence and the conv from a given state (decode, or a
    prefill that continues one); ``lengths`` (B,) marks a padded prefill
    batch, whose returned state is each row's at its own length. ``tp``
    (``models/sharding.TP``): this rank's shards and state (the module
    docstring).
    Returns (y (B,S,D), new_state)."""
    sharded = tp is not None and tp.model is not None
    h = (tp.copy(x) if sharded else x) @ params["w_in"]
    branch, gate = h.chunk(2, dim=-1)
    conv_state = state.conv if state is not None else None
    branch_in = branch
    branch, new_conv = causal_conv1d(branch, params["conv"], conv_state)
    x_all = tp.gather_sum(branch) if sharded else None
    if decode:
        assert state is not None
        y, h_t = rglru_step(branch, params, state.hidden, x_all)
    else:
        h0 = state.hidden if state is not None else None
        y, h_t = rglru_scan(branch, params, h0, lengths, x_all)
        if lengths is not None:
            new_conv = conv_state_at(branch_in, lengths.to(x.device),
                                     params["conv"].shape[0], conv_state)
    y = y * F.gelu(gate, approximate="tanh")
    out = SH.tp_matmul(y, params["w_out"], tp, "in", x_local=True)
    return out, RGLRUState(new_conv, h_t)
