"""Routed mixture-of-experts (GShard-style capacity dispatch), the port of
the JAX package's ``models/moe.py``, op for op: a fp32 softmax over the
router logits, top-k, renormalized weights; per routing slot ``kk`` a
one-hot ``cumsum`` rank of each token within its expert, tokens past the
capacity dropped, the rest scattered into an (E·C + 1, D) buffer whose
last row is the drop bin; the expert products ``ecd,edf->ecf`` and
``ecf,efd->ecd`` around ``silu(gate)·up`` as batched matmuls (the JAX
package runs them as XLA einsums, outside any Pallas kernel), gathered
back and accumulated in fp32 by the routing weight; then the shared
expert. The token-parallel ``moe_ffn_sharded`` is tensor/data parallelism
and comes with ROADMAP port item 'training and the rest'.

The padding contract. The JAX ``moe_ffn`` counts every row of its (B, S,
D) input, padding included, in the capacity and the ranks, so its result
for a prompt depends on how its batch was padded. ``valid`` (B, S) names
the rows that are tokens: invalid rows take no capacity, rank after no
one and get no routed output (the shared expert still applies to them),
and the capacity is that of the ``n_valid`` tokens. For the valid rows the
result equals the JAX ``moe_ffn`` on the valid tokens compacted into one
(1, n_valid, D) row in row-major order; ``valid=None`` is the JAX function
itself. Shapes stay static for CUDA graphs: the buffer is sized from all
B·S rows, the limit is ``_capacity`` of the device count ``n_valid``
computed on the device by the same IEEE double operations as JAX's Python
expression (``capacity_on_device``), and no op reads a value back to the
host, so a graph holds nothing but its own inputs and outputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import gated_mlp


class MoEMetrics(NamedTuple):
    load_balance_loss: torch.Tensor   # scalar aux loss (Switch-style)
    dropped_fraction: torch.Tensor    # fraction of tokens over capacity


def _capacity(n_tokens: int, n_experts: int, k: int, factor: float) -> int:
    cap = int(n_tokens * k * factor / n_experts)
    return max(8, -(-cap // 8) * 8)   # round up to 8 for TPU lane alignment


def capacity_on_device(n_tokens: torch.Tensor, n_experts: int, k: int,
                       factor: float) -> torch.Tensor:
    """``_capacity`` of the int64 count ``n_tokens`` (>= 0) on its device:
    ``n·k`` times ``factor`` over ``n_experts`` in float64, truncated,
    rounded up to 8 and at least 8. The divisor is a tensor, so the
    division is IEEE's (a divisor given as a Python number may be taken as
    a multiply by its reciprocal)."""
    e = torch.full((), n_experts, dtype=torch.float64,
                   device=n_tokens.device)
    cap = torch.floor((n_tokens * k).double() * factor / e).long()
    return torch.clamp((cap + 7) // 8 * 8, min=8)


def route_topk(router_logits: torch.Tensor, k: int):
    """router_logits: (T, E) -> (weights (T, k), experts (T, k) int64,
    probs (T, E)). Ties go to the lower expert index, as ``jax.lax.top_k``
    breaks them (a stable sort; ``torch.topk`` promises no order)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    idx = torch.sort(-probs, dim=-1, stable=True).indices[:, :k]
    w = probs.gather(1, idx)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    return w, idx, probs


class MoEStats:
    """Running sums of the MoE layers' metrics on the device: calls, the
    dropped fractions, calls that dropped a token, the load-balance
    losses. ``add`` is one in-place device op, so a CUDA graph captured
    with it adds on every replay. The model's ``stats`` arguments take
    any object with ``add(MoEMetrics)``: a list whose ``add`` appends
    keeps each eager call's metrics in order."""

    def __init__(self, device):
        self.sums = torch.zeros(4, dtype=torch.float32, device=device)

    def add(self, m: MoEMetrics) -> None:
        d = m.dropped_fraction
        self.sums.add_(torch.stack([torch.ones_like(d), d, (d > 0).float(),
                                    m.load_balance_loss]))

    def read(self) -> dict:
        """The sums on the host (waits for the device)."""
        calls, dropped, dropping, lb = self.sums.tolist()
        return {"calls": int(calls), "dropping_calls": int(dropping),
                "mean_dropped_fraction": dropped / max(calls, 1.0),
                "load_balance_loss": lb}


def moe_ffn(x: torch.Tensor, params: dict, *, n_experts: int, k: int,
            capacity_factor: float, valid: Optional[torch.Tensor] = None):
    """x: (B, S, D). params: router (D, E), w_in (E, D, 2F), w_out (E, F,
    D), optional shared_wi / shared_wo. ``valid`` (B, S) bool: see the
    module docstring. Returns (y, MoEMetrics)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    logits = xf @ params["router"]                       # (T, E)
    weights, experts, probs = route_topk(logits, k)
    cap = _capacity(t, n_experts, k, capacity_factor)    # buffer rows
    eids = torch.arange(n_experts, device=x.device)
    top1 = (experts[:, :1] == eids).float()              # (T, E)
    if valid is None:
        limit = cap
        me, ce = probs.mean(0), top1.mean(0)
    else:
        vmask = valid.reshape(t)
        vi = vmask.long()
        n_valid = vi.sum()
        limit = capacity_on_device(n_valid, n_experts, k, capacity_factor)
        denom = n_valid.clamp(min=1).float()
        me = (probs * vmask[:, None]).sum(0) / denom
        ce = (top1 * vmask[:, None]).sum(0) / denom
    # Switch-transformer load-balance loss
    lb_loss = n_experts * torch.sum(me * ce)

    ybuf = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    for kk in range(k):                                  # small static k
        e_idx = experts[:, kk]                           # (T,)
        onehot = (e_idx[:, None] == eids).long()         # (T, E)
        if valid is not None:
            onehot = onehot * vi[:, None]
        rank = torch.cumsum(onehot, dim=0) - 1           # position in expert
        pos = rank.gather(1, e_idx[:, None])[:, 0]
        keep = pos < limit
        if valid is None:
            dropped = dropped + (1.0 - keep.float().mean()) / k
        else:
            keep = keep & vmask
            dropped = dropped + (1.0 - keep.sum() / denom) / k
        dest = torch.where(keep, e_idx * cap + pos, n_experts * cap)
        # scatter tokens -> (E*C+1, D); the last row is the drop bin, the
        # only index that repeats
        buf = x.new_zeros((n_experts * cap + 1, d))
        buf.index_copy_(0, dest, xf)
        ebuf = buf[:-1].reshape(n_experts, cap, d)       # (E, C, D)
        h = torch.bmm(ebuf, params["w_in"])              # (E, C, 2F)
        gate, up = h.chunk(2, dim=-1)
        h = torch.nn.functional.silu(gate) * up
        eout = torch.bmm(h, params["w_out"])             # (E, C, D)
        flat = torch.cat([eout.reshape(n_experts * cap, d),
                          eout.new_zeros((1, d))], dim=0)
        gathered = flat.index_select(0, dest)            # (T, D)
        ybuf = ybuf + gathered.float() * weights[:, kk:kk + 1]

    y = ybuf.to(x.dtype)
    if "shared_wi" in params:
        y = y + gated_mlp(xf, params["shared_wi"], params["shared_wo"])
    return y.reshape(b, s, d), MoEMetrics(lb_loss, dropped)
