"""Optimizers (hand-rolled, as in the JAX package's
``training/optimizer.py``): AdamW and Adafactor, as ``(init, update)``
pairs of plain functions over param trees.

The arithmetic is the JAX module's, op for op, in fp32: AdamW with bias
correction, decoupled weight decay on the leaves ``_wd_mask`` picks and a
warmup-then-cosine learning rate; Adafactor with its second moment
factored over the last two axes of every leaf of two or more dims (a
stacked (R, ...) leaf keeps one factor pair per repeat), no first moment,
update clipping and a warmup learning rate. The step counter is a 0-dim
int32 tensor on the params' device and the schedules are computed there,
so a step reads nothing back to the host.

One difference from the JAX module: ``update`` writes the new params and
moments into the tensors it is given and returns them (the JAX update
returns new trees). The old values are not needed again, and overwriting
them keeps one copy of the params and moments on the card, not two.

Sharded (``specs``, ``mesh``: each leaf's partition spec in flatten order
and the rank's mesh, ROADMAP §1 item 8d): the params, gradients and
moments are this rank's shards. AdamW is elementwise and needs nothing
more; Adafactor's means over a leaf's last two dims, the row moment's
mean and the update's mean square sum over the mesh axes that split the
dims they reduce, so each rank's update is its block of the whole's.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.models import sharding as SH
from repro_torch.training.tree import (leaves, leaves_with_paths, mask_name,
                                       tree_map)


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-dim int32
    m: Any
    v: Any


class AdafactorState(NamedTuple):
    step: torch.Tensor      # 0-dim int32
    vr: Any                 # row second moment (or full, for < 2-D leaves)
    vc: Any                 # column second moment ((1,) for < 2-D leaves)


def _wd_mask(path) -> bool:
    """No weight decay on norms / biases / 1-D params: the JAX mask, on
    the same path string (``tree.mask_name``)."""
    name = mask_name(path)
    return not any(t in name for t in ("norm", "ln", "b_a", "b_x", "bias",
                                       "lambda", "A_log", "dt_bias"))


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)


def _write(p: torch.Tensor, delta: torch.Tensor) -> None:
    """p <- p - delta (delta fp32, p in its own dtype), in place."""
    if p.dtype == torch.float32:
        p.sub_(delta)
    else:
        p.copy_((p.float() - delta).to(p.dtype))


def make_adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.1,
               warmup: int = 100, total_steps: int = 10_000):
    def schedule(step):
        s = step.float()
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0, 1)
        return lr * w * 0.5 * (1 + torch.cos(math.pi * prog))

    def init(params) -> AdamWState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        return AdamWState(_step0(params), zeros,
                          tree_map(torch.clone, zeros))

    def update(grads, state: AdamWState, params):
        step = state.step + 1
        lr_t = schedule(step)
        sf = step.float()
        bc1, bc2 = 1 - b1 ** sf, 1 - b2 ** sf
        for (path, p), g, m, v in zip(leaves_with_paths(params),
                                      leaves(grads), leaves(state.m),
                                      leaves(state.v)):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            if weight_decay and _wd_mask(path):
                delta.add_(weight_decay * p.float())
            _write(p, delta.mul_(lr_t))
        return params, AdamWState(step, state.m, state.v)

    return init, update


def make_adafactor(lr: float = 1e-3, decay: float = 0.8,
                   eps: float = 1e-30, clip: float = 1.0,
                   warmup: int = 100, specs=None, mesh=None):
    def schedule(step):
        return lr * torch.clamp(step.float() / max(warmup, 1), max=1.0)

    def mean(t, dims, spec, keepdim=False):
        """The mean of ``t`` (this rank's block of a leaf under ``spec``)
        over ``dims`` of the whole leaf."""
        if spec is None:
            if len(dims) == t.dim() and not keepdim:
                return t.mean()
            return t.mean(dims, keepdim=keepdim)
        axes = [a for d in dims if d % t.dim() < len(spec)
                for a in SH.axis_tuple(spec[d % t.dim()])]
        n = SH.axis_size(mesh, axes) * math.prod(t.shape[d] for d in dims)
        return SH.psum(t.sum(dims, keepdim=keepdim), axes, mesh) / n

    def init(params) -> AdafactorState:
        def rows(p):
            if p.dim() >= 2:
                return torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device)
            return torch.zeros_like(p, dtype=torch.float32)

        def cols(p):
            if p.dim() >= 2:
                return torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=p.device)
            return torch.zeros((1,), dtype=torch.float32, device=p.device)

        return AdafactorState(_step0(params), tree_map(rows, params),
                              tree_map(cols, params))

    def update(grads, state: AdafactorState, params):
        step = state.step + 1
        lr_t = schedule(step)
        beta = 1.0 - (step.float() + 1) ** -decay
        sp = specs if specs is not None else [None] * len(leaves(params))
        for p, g, vr, vc, spec in zip(leaves(params), leaves(grads),
                                      leaves(state.vr), leaves(state.vc),
                                      sp):
            g = g.float()
            g2 = g * g + eps
            if p.dim() >= 2:
                vr.mul_(beta).add_((1 - beta) * mean(g2, (-1,), spec))
                vc.mul_(beta).add_((1 - beta) * mean(g2, (-2,), spec))
                rspec = None if spec is None else SH.Spec(*spec[:-1])
                r = vr / torch.clamp(mean(vr, (-1,), rspec, True), min=eps)
                denom = torch.sqrt(r[..., None] * vc[..., None, :])
            else:
                vr.mul_(beta).add_((1 - beta) * g2)
                denom = torch.sqrt(vr)
            u = g / torch.clamp(denom, min=eps)
            norm = torch.sqrt(mean(u * u, tuple(range(u.dim())), spec))
            u = u / torch.clamp(norm / clip, min=1.0)
            _write(p, lr_t * u)
        return params, AdafactorState(step, state.vr, state.vc)

    return init, update


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return make_adamw(**kw)
    if name == "adafactor":
        return make_adafactor(**kw)
    raise ValueError(name)


def optimizer_for(n_params: int) -> str:
    """AdamW below 20e9 params, Adafactor (no first moment, factored
    second moment) from there: the JAX package's threshold, kept so that
    both packages pick the same optimizer for a config."""
    return "adamw" if n_params < 20e9 else "adafactor"
