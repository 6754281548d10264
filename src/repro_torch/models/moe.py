"""Routed mixture-of-experts (GShard-style capacity dispatch), the port of
the JAX package's ``models/moe.py``, op for op: a fp32 softmax over the
router logits, top-k, renormalized weights; per routing slot ``kk`` a
one-hot ``cumsum`` rank of each token within its expert, tokens past the
capacity dropped, the rest scattered into an (E·C + 1, D) buffer whose
last row is the drop bin; the expert products ``ecd,edf->ecf`` and
``ecf,efd->ecd`` around ``silu(gate)·up`` as batched matmuls (the JAX
package runs them as XLA einsums, outside any Pallas kernel), gathered
back and accumulated in fp32 by the routing weight; then the shared
expert.

Sharded (``moe_ffn_sharded``, ROADMAP §1 item 8d): each rank holds its
experts (over "model" when they divide it) and its columns of every
expert's d_ff (over "model" when the experts do not divide it, and over
the data axes under the 2D layout), and computes the dispatch of the
tokens it is given into the full (E, C, D) buffer, its experts' products
over its d_ff columns, the partial sums over d_ff ``psum``med (the 2D
layout's small (E_loc, C, D) activations), and its experts' share of
``y`` ``psum``med over "model". Token-parallel (the JAX ``shard_map`` over
the data axes, the serving default): each data shard dispatches its own
tokens into its own capacity, counting its own valid tokens, and the
metrics are ``pmean``ed over the data axes. The 2D layout and the
unsharded-dispatch default (the JAX GSPMD einsum path, which training
takes) dispatch the whole batch: the tokens are all-gathered over the
data axes, every rank routes all of them, and each keeps its rows of
``y``.

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

from repro_torch.models import sharding as SH
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
    y, m = _routed_experts(x, params, n_experts=n_experts, k=k,
                      capacity_factor=capacity_factor, valid=valid,
                      mesh=None, e_axes=None, f_axes=None, model=None)
    return y.reshape(b, s, d), m


def _routed_experts(x, params, *, n_experts: int, k: int, capacity_factor: float,
               valid, mesh, e_axes, f_axes, model, c_axes=None, rows=None):
    """The routed experts of the tokens ``x`` (B, S, D), the same on every
    rank of ``e_axes``, ``f_axes`` and ``c_axes``, on this rank's experts
    (split over ``e_axes``), d_ff columns (over ``f_axes``) and capacity
    rows (over ``c_axes``): the routing, capacity and metrics of the
    module docstring, the partial products summed over ``f_axes``, the
    capacity rows all-gathered over ``c_axes``, the experts' shares
    summed over ``e_axes``; the shared expert's d_ff over ``model``.
    Without axes (``mesh`` None) it is ``moe_ffn`` itself. Returns the
    output of the flat token rows ``rows`` (a slice; all by default) as
    (n_rows, D), and the metrics."""
    b, s, d = x.shape
    t = b * s
    rows = slice(0, t) if rows is None else rows
    xf = x.reshape(t, d)
    logits = xf @ params["router"]
    weights, experts, probs = route_topk(logits, k)
    cap = _capacity(t, n_experts, k, capacity_factor)
    eids = torch.arange(n_experts, device=x.device)
    top1 = (experts[:, :1] == eids).float()
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
    lb_loss = n_experts * torch.sum(me * ce)

    work = tuple(SH.axis_tuple(e_axes)) + tuple(SH.axis_tuple(f_axes))
    el = n_experts // SH.axis_size(mesh, e_axes)
    e0 = SH.axis_index(mesh, e_axes) * el
    nc = SH.axis_size(mesh, c_axes)
    cl = -(-cap // nc)                     # this rank's capacity rows
    cpad = cl * nc                         # the buffer's, a multiple of nc
    c0 = SH.axis_index(mesh, c_axes) * cl
    xin = SH.copy_to(xf, work, mesh)
    wts = SH.copy_to(weights[rows], e_axes, mesh)
    n_out = len(range(t)[rows])
    ybuf = torch.zeros((n_out, d), dtype=torch.float32, device=x.device)
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    for kk in range(k):
        e_idx = experts[:, kk]
        onehot = (e_idx[:, None] == eids).long()
        if valid is not None:
            onehot = onehot * vi[:, None]
        rank = torch.cumsum(onehot, dim=0) - 1
        pos = rank.gather(1, e_idx[:, None])[:, 0]
        keep = pos < limit
        if valid is None:
            dropped = dropped + (1.0 - keep.float().mean()) / k
        else:
            keep = keep & vmask
            dropped = dropped + (1.0 - keep.sum() / denom) / k
        dest = torch.where(keep, e_idx * cpad + pos, n_experts * cpad)
        buf = x.new_zeros((n_experts * cpad + 1, d))
        buf.index_copy_(0, dest, xin)
        ebuf = buf[:-1].reshape(n_experts, cpad, d)[e0:e0 + el, c0:c0 + cl]
        h = torch.bmm(ebuf, params["w_in"])            # (E_loc, C_loc, 2F_loc)
        gate, up = h.chunk(2, dim=-1)
        h = torch.nn.functional.silu(gate) * up
        eout = SH.reduce_from(torch.bmm(h, params["w_out"]), f_axes, mesh)
        eout = SH.gather_from(eout, 1, c_axes, mesh)   # (E_loc, C_pad, D)
        # this rank's experts' rows; every other destination reads zeros
        ldest = dest[rows] - e0 * cpad
        ldest = torch.where((ldest >= 0) & (ldest < el * cpad), ldest,
                            el * cpad)
        flat = torch.cat([eout.reshape(el * cpad, d),
                          eout.new_zeros((1, d))], dim=0)
        gathered = flat.index_select(0, ldest)
        ybuf = ybuf + gathered.float() * wts[:, kk:kk + 1]
    y = SH.reduce_from(ybuf, e_axes, mesh).to(x.dtype)
    if "shared_wi" in params:
        hs = SH.copy_to(xf[rows], model, mesh) @ params["shared_wi"]
        gate, up = hs.chunk(2, dim=-1)
        y = y + SH.reduce_from(
            (torch.nn.functional.silu(gate) * up) @ params["shared_wo"],
            model, mesh)
    return y, MoEMetrics(lb_loss, dropped)


def moe_ffn_sharded(x: torch.Tensor, params: dict, *, n_experts: int, k: int,
                    capacity_factor: float, policy,
                    valid: Optional[torch.Tensor] = None,
                    token_parallel: bool = True):
    """``moe_ffn`` over a mesh (see the module docstring): ``x`` (B_loc, S,
    D) and ``valid`` are this rank's rows (the batch over the data axes
    when ``policy.shard_batch``), ``params`` its shards under the policy's
    specs (FSDP's already gathered). ``token_parallel``: each data shard
    dispatches its own tokens (the JAX ``moe_ffn_sharded``); else the
    whole batch is dispatched at once (the 2D layout, and the JAX einsum
    path, whose expert products each data rank computes for its block of
    the capacity rows). Returns (this rank's rows of y, MoEMetrics)."""
    mesh = policy.mesh
    model = policy.model_axis if policy.model_size > 1 else None
    bax = tuple(policy.data_axes) if policy.shard_batch else ()
    e_axes = model if policy.shard_experts else None
    if policy.moe_2d_weights:
        f_axes = tuple(policy.data_axes)
        if not policy.shard_experts and policy.model_axis:
            f_axes = (policy.model_axis,) + f_axes
    else:
        f_axes = None if policy.shard_experts else model
    kw = dict(n_experts=n_experts, k=k, capacity_factor=capacity_factor,
              mesh=mesh, e_axes=e_axes, f_axes=f_axes, model=model)
    b, s, d = x.shape
    if token_parallel and not policy.moe_2d_weights:
        y, m = _routed_experts(x, params, valid=valid, **kw)
        n = SH.axis_size(mesh, bax)
        if n > 1:
            m = MoEMetrics(SH.reduce_from(m.load_balance_loss, bax, mesh) / n,
                           SH.pmean(m.dropped_fraction, bax, mesh))
        return y.reshape(b, s, d), m
    xg = SH.gather_from(x, 0, bax, mesh)
    vg = None
    if valid is not None:
        vg = SH.all_gather(valid.to(torch.uint8), 0, bax, mesh).bool()
    first = SH.axis_index(mesh, bax) * b * s
    y, m = _routed_experts(xg, params, valid=vg, rows=slice(first, first + b * s),
                      c_axes=None if policy.moe_2d_weights else bax, **kw)
    return y.reshape(b, s, d), m
