"""Training substrate: the loss, the train step (per-block remat, MoE aux
loss, gradient accumulation, the global-norm clip, the optimizer), its
metrics; the JAX package's ``training/trainer.py`` in plain PyTorch.

Gradients come from ``torch.autograd.grad`` over the param tree's leaves
(the model holds no module state): each leaf enters the loss as a
detached alias that requires grad, so the caller's tensors never carry
autograd state. Every config trains on the card in fp32 and in bf16 (a
bf16 param tree, as the JAX dry-run's production step: the gradients
taken in the leaves' dtypes, then cast to fp32 for the accumulation, the
global-norm clip and the optimizer, whose moments and update are fp32,
the update cast back to each leaf's dtype, as the JAX step does; the
leaves the port keeps in fp32, Mamba-2's ``A_log`` and RG-LRU's
``lambda``, stay fp32). Attention's gradient is kernel 1's backward
(``kernels/flash_attention.py``), the SSD scan's kernel 6's
(``kernels/ssd_scan.py``) and the RG-LRU scan's kernel 7's
(``kernels/rglru_scan.py``), each a hand-written CUDA kernel in both
dtypes under a ``torch.autograd.Function``. ``train_step_shardings`` gives
the train state's partition specs.

Sharded (``make_train_step(cfg, policy)``, ROADMAP §1 item 8d): the state,
the batch and every gradient are this rank's shards under
``train_step_shardings``. The forward is the model's sharded one; with
the vocab over the model axis the cross-entropy is vocab parallel (the
max and the sum of exponentials and the gold logit summed over the
ranks), so no rank holds the whole logits. Each data rank's loss is its
rows' share of the whole batch's mean (the MoE aux loss over the data
ranks), so its gradients are shares: the gradients of the leaves the data
axes do not split are summed over them, once per step in one buffer,
while an FSDP leaf's share is reduce-scattered by its gather's backward.
The global gradient norm counts each leaf's squares once: summed over the
axes the leaf is split on, never over those it is replicated on.
Adafactor's row and column means and its update's mean square are summed
over the dims the leaf's spec splits (``training/optimizer.py``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.sharding import (TP, ShardingPolicy, Spec, map_specs,
                                         spec_leaves)
from repro_torch.training.optimizer import (AdafactorState, AdamWState,
                                            make_optimizer, optimizer_for)
from repro_torch.training.tree import leaves, unflatten


class TrainState(NamedTuple):
    params: Any
    opt_state: Any


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL in fp32. logits (B,S,V), labels (B,S); the
    padded vocabulary's logits arrive at -1e30 (``T.lm_logits``), so they
    take no probability."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _nll(logits: torch.Tensor, labels: torch.Tensor, tp) -> torch.Tensor:
    """Each token's NLL (B, S) in fp32; over this rank's vocab block when
    the logits are one (vocab parallel: the max, the sum of exponentials
    and the gold logit taken over the model axis)."""
    logits = logits.float()
    if tp is None or tp.model is None or not tp.policy.shard_vocab:
        logz = torch.logsumexp(logits, dim=-1)
        return logz - logits.gather(-1, labels.long()[..., None])[..., 0]
    vl = logits.shape[-1]
    m = SH.pmax(logits.detach().amax(dim=-1), tp.model, tp.mesh)
    logz = torch.log(tp.reduce(torch.exp(logits - m[..., None]).sum(-1))) + m
    ids = labels.long() - tp.r * vl
    inside = (ids >= 0) & (ids < vl)
    gold = logits.gather(-1, ids.clamp(0, vl - 1)[..., None])[..., 0]
    return logz - tp.reduce(torch.where(inside, gold, 0.0))


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            remat: bool = False, aux_weight: float = 0.01,
            policy: Optional[ShardingPolicy] = None):
    """(loss + aux_weight · aux, {"loss", "aux"}) of one batch: ``tokens``,
    ``labels``, optional ``mask`` and ``frontend``. A decoder-only VLM's
    frontend positions carry no loss. With ``policy`` on a mesh the batch
    is this rank's rows, the objective this rank's share of the whole's
    (the module docstring), and ``loss`` the whole batch's."""
    logits, aux = T.forward(params, batch["tokens"], cfg,
                            frontend=batch.get("frontend"), remat=remat,
                            policy=policy)
    if cfg.frontend_embed_len and not cfg.n_encoder_layers:
        logits = logits[:, cfg.frontend_embed_len:]
    tp = TP.of(policy)
    if tp is None:
        loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
        return loss + aux_weight * aux, {"loss": loss, "aux": aux}
    nll = _nll(logits, batch["labels"], tp)
    mask = batch.get("mask")
    w = torch.ones_like(nll) if mask is None else mask.float()
    num, den = (nll * w).sum(), w.sum()
    if tp.bax:
        den = SH.psum(den, tp.bax, tp.mesh)
        loss = SH.psum(num.detach(), tp.bax, tp.mesh) / den.clamp(min=1.0)
    else:
        # every data rank holds the whole batch: its share is 1 / dsz
        loss = num.detach() / den.clamp(min=1.0)
        den = den * tp.dsz
    share = num / den.clamp(min=1.0) + aux_weight * aux / tp.dsz
    return share, {"loss": loss, "aux": aux}


def compute_grads(params, batch, cfg: ModelConfig, *, remat: bool = False,
                  aux_weight: float = 0.01,
                  policy: Optional[ShardingPolicy] = None):
    """(grads, metrics) of ``loss_fn`` at ``params``: ``grads`` a tree of
    ``params``' structure in the leaves' dtypes (zeros for a leaf the loss
    does not reach, as ``jax.grad`` gives), ``metrics`` {"loss", "aux"}
    detached. With ``policy`` on a mesh, this rank's shares (the module
    docstring)."""
    live = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        total, metrics = loss_fn(unflatten(params, live), batch, cfg,
                                 remat=remat, aux_weight=aux_weight,
                                 policy=policy)
        grads = torch.autograd.grad(total, live, allow_unused=True,
                                    materialize_grads=True)
    return (unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ModelConfig,
                    policy: Optional[ShardingPolicy] = None, *,
                    optimizer: Optional[str] = None,
                    remat: bool = True, lr: float = 3e-4,
                    accum_steps: int = 1, **opt_kw):
    """Returns (init_fn(params) -> TrainState, step_fn(state, batch) ->
    (TrainState, metrics)).

    ``init_fn`` copies the params: the state owns its tensors, and
    ``step_fn`` updates them (and the optimizer's moments) in place and
    returns the same tensors in a new ``TrainState``.
    ``accum_steps`` > 1 splits the batch into that many microbatches, in
    order, and adds each one's gradient divided by ``accum_steps`` into an
    fp32 sum, as the JAX ``lax.scan`` does. The global gradient norm is
    clipped to 1. ``metrics``: ``loss``, ``aux``, ``grad_norm`` (before
    the clip) and ``total`` (the loss), 0-dim tensors on the device.
    ``policy`` on a mesh: the state and the batch are this rank's shards
    (``train_step_shardings``), and so are the updated state; the metrics
    are the whole step's (the module docstring).
    """
    opt_name = optimizer or optimizer_for(cfg.n_params)
    tp = TP.of(policy)
    specs = spec_leaves(T.param_specs(cfg, policy)) if tp else None
    if tp is not None and opt_name == "adafactor":
        # its factored means sum over the dims a leaf's spec splits
        opt_kw = dict(opt_kw, specs=specs, mesh=tp.mesh)
    opt_init, opt_update = make_optimizer(opt_name, lr=lr, **opt_kw)

    def init_fn(params) -> TrainState:
        params = unflatten(params, [p.detach().clone()
                                    for p in leaves(params)])
        if leaves(params)[0].is_cuda:
            # pinned fp32 matmul precision, as the engine pins it: no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return TrainState(params, opt_init(params))

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if accum_steps <= 1:
            grads, metrics = compute_grads(state.params, batch, cfg,
                                           remat=remat, policy=policy)
            grads = [g.float() for g in leaves(grads)]
        else:
            b = batch["tokens"].shape[0]
            assert b % accum_steps == 0, (b, accum_steps)
            micro = {k: v.reshape((accum_steps, b // accum_steps)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in leaves(state.params)]
            loss = aux = torch.zeros((), dtype=torch.float32,
                                     device=grads[0].device)
            for i in range(accum_steps):
                g, m = compute_grads(state.params,
                                     {k: v[i] for k, v in micro.items()},
                                     cfg, remat=remat, policy=policy)
                for acc, gi in zip(grads, leaves(g)):
                    acc.add_(gi.float() / accum_steps)
                del g
                loss = loss + m["loss"] / accum_steps
                aux = aux + m["aux"] / accum_steps
            metrics = {"loss": loss, "aux": aux}
        if tp is not None:
            _sum_shares(grads, specs, tp)
            gnorm = _global_norm(grads, specs, tp)
        else:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                   for g in grads))
        scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-6), max=1.0)
        for g in grads:
            g.mul_(scale)
        params, opt_state = opt_update(unflatten(state.params, grads),
                                       state.opt_state, state.params)
        metrics = dict(metrics, grad_norm=gnorm, total=metrics["loss"])
        return TrainState(params, opt_state), metrics

    return init_fn, step_fn


def _names_data(spec: Spec) -> bool:
    return any(a in SH.DATA_AXES for part in spec for a in SH.axis_tuple(part))


def _sum_shares(grads, specs, tp) -> None:
    """Sum the data ranks' gradient shares of every leaf the data axes do
    not split, in place, in one all-reduce."""
    if SH.axis_size(tp.mesh, tp.data) == 1:
        return
    todo = [g for g, s in zip(grads, specs) if not _names_data(s)]
    if not todo:
        return
    flat = SH.psum(torch.cat([g.reshape(-1) for g in todo]), tp.data,
                   tp.mesh)
    for g, part in zip(todo, flat.split([g.numel() for g in todo])):
        g.copy_(part.view_as(g))


def _global_norm(grads, specs, tp) -> torch.Tensor:
    """The norm of the whole gradient: each leaf's sum of squares summed
    over the axes its spec splits (one all-reduce per distinct set)."""
    by_axes: Dict[tuple, torch.Tensor] = {}
    for g, spec in zip(grads, specs):
        axes = tuple(a for part in spec for a in SH.axis_tuple(part))
        axes = tuple(a for a in tp.mesh.axis_names if a in axes)
        sq = torch.sum(torch.square(g))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = sum(SH.psum(v, axes, tp.mesh) for axes, v in by_axes.items())
    return torch.sqrt(total)


def train_step_shardings(cfg: ModelConfig, policy: ShardingPolicy):
    """((state_specs, batch_specs), (state_specs, metric_specs)): the
    partition specs of the JAX ``train_step_shardings``, leaf for leaf, for
    this port's ``TrainState``: the params' :func:`T.param_specs`, AdamW's
    moments as their params, Adafactor's row moment without the last dim
    and column moment without the second last (one dim: replicated)."""
    pspecs = T.param_specs(cfg, policy)

    def mapped(fn):
        return map_specs(fn, pspecs)

    if optimizer_for(cfg.n_params) == "adamw":
        opt_specs = AdamWState(Spec(), mapped(lambda s: s),
                               mapped(lambda s: s))
    else:
        opt_specs = AdafactorState(
            Spec(),
            mapped(lambda s: Spec(*s[:-1]) if len(s) >= 2 else s),
            mapped(lambda s: (Spec(*(s[:-2] + s[-1:])) if len(s) >= 2
                              else Spec(None))))
    state_specs = TrainState(pspecs, opt_specs)
    bax = policy.data_axes if policy.shard_batch else None
    batch_specs = {"tokens": Spec(bax, None), "labels": Spec(bax, None)}
    if cfg.frontend_embed_len:
        batch_specs["frontend"] = Spec(bax, None, None)
    metric_specs = {"loss": Spec(), "aux": Spec(), "grad_norm": Spec(),
                    "total": Spec()}
    return (state_specs, batch_specs), (state_specs, metric_specs)
