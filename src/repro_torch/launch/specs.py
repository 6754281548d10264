"""Meta-device stand-ins for every (architecture × input shape) model
input, the step functions the dry-run traces, and their partition specs:
the port of the JAX package's ``launch/specs.py``.

  train_4k     -> the train step (bf16 params, fp32 moments)
  prefill_32k  -> prefill(params, tokens, lengths, cache[, frontend])
  decode_32k   -> decode_step(params, cache, tokens, pos)
  long_500k    -> decode_step over the ring-window / state caches

Every step runs in bf16, as the JAX dry-run's (``DTYPE``): the train step
on a bf16 param tree (the optimizer's moments fp32), the serving steps on
the dense slot cache. Every tensor lives
on the meta device: shapes and dtypes, no storage, no device touched.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, get_config
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardingPolicy, Spec, make_policy
from repro_torch.models.sharding import spec_leaves
from repro_torch.training.trainer import (make_train_step,
                                          train_step_shardings)
from repro_torch.training.tree import leaves

#: the steps' dtype, the train step's included
DTYPE = torch.bfloat16


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def _batch_axes(policy: ShardingPolicy):
    return policy.data_axes if policy.shard_batch else None


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """Meta model inputs for one (architecture × input shape): the JAX
    ``input_specs``' keys, shapes and dtypes."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    fe_len = (cfg.encoder_seq_len if cfg.n_encoder_layers
              else cfg.frontend_embed_len)
    if shape.kind in ("train", "prefill"):
        s_tok = s - (cfg.frontend_embed_len if not cfg.n_encoder_layers
                     else 0)
        out["tokens"] = meta((b, s_tok), torch.int32)
        if shape.kind == "train":
            out["labels"] = meta((b, s_tok), torch.int32)
        else:
            out["lengths"] = meta((b,), torch.int32)
        if cfg.frontend_embed_len:
            out["frontend"] = meta((b, fe_len, cfg.frontend_embed_dim),
                                   DTYPE)
    else:   # decode
        out["tokens"] = meta((b, 1), torch.int32)
        out["pos"] = meta((b,), torch.int32)
    return out


def abstract_params(cfg: ModelConfig, dtype=DTYPE):
    """``T.init_params``' tree on the meta device."""
    return T.init_params(cfg, dtype=dtype, device="meta")


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   long_context: bool):
    """``T.init_cache``'s dense slot cache on the meta device."""
    return T.init_cache(cfg, batch, max_len, DTYPE, device="meta",
                        long_context=long_context)


def _accum_steps(cfg: ModelConfig, policy: ShardingPolicy, seq_len: int,
                 global_batch: int) -> int:
    """The JAX dry-run's gradient accumulation: enough microbatches that
    the remat residuals (~3 live copies of the bf16 per-layer activations)
    stay under ~5 GB a device."""
    b_local = global_batch // max(policy.data_size, 1)
    act_gb = (b_local * seq_len * cfg.d_model * cfg.n_layers * 2 * 3) / 2**30
    accum = 1
    for cand in (1, 2, 4, 8, 16):
        if b_local % cand == 0 and act_gb / cand > 5.0:
            accum = min(cand * 2, b_local) if cand * 2 <= 16 else 16
    while b_local % accum:
        accum //= 2
    return max(accum, 1)


def build_dryrun(arch: str, shape_name: str, mesh, *,
                 moe_2d: Optional[bool] = None, moe_2d_train: bool = False,
                 fsdp: Optional[bool] = None):
    """Returns (step_fn, example_args (a tree of meta tensors), in_specs,
    out_specs, policy). ``moe_2d`` (default: on for a MoE decode, as the
    JAX dry-run's ``REPRO_MOE_2D``) and ``moe_2d_train`` (its
    ``REPRO_MOE_2D_TRAIN``) pick the 2D expert-weight layout; ``fsdp``
    (default: always for training, for serving when tensor parallelism
    alone leaves more than 8 GB of weights a device) the FSDP layout."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    model_axis_size = mesh.shape.get("model", 1)
    weights_gb = cfg.n_params * 2 / model_axis_size / 2**30
    moe_2d = cfg.n_experts > 0 and (
        (moe_2d is not False and shape.kind == "decode")
        or (moe_2d_train and shape.kind == "train"))
    if fsdp is None:
        fsdp = shape.kind == "train" or weights_gb > 8.0
    policy = make_policy(cfg, mesh, global_batch=shape.global_batch,
                         fsdp=fsdp,
                         moe_token_shard_map=(shape.kind != "train"
                                              and not moe_2d),
                         moe_2d_weights=moe_2d)
    ins = input_specs(arch, shape_name)
    bax = _batch_axes(policy)
    pspecs = T.param_specs(cfg, policy)
    long_ctx = shape_name == "long_500k"

    if shape.kind == "train":
        accum = _accum_steps(cfg, policy, shape.seq_len, shape.global_batch)
        init_fn, step_fn = make_train_step(cfg, remat=True,
                                           accum_steps=accum)
        state = init_fn(abstract_params(cfg))
        (state_specs, batch_specs), (out_state_specs, metric_specs) = \
            train_step_shardings(cfg, policy)
        bspecs = {k: batch_specs.get(k, Spec(bax, None, None)) for k in ins}
        return (step_fn, (state, ins), (state_specs, bspecs),
                (out_state_specs, metric_specs), policy)

    params = abstract_params(cfg)
    cspecs = T.cache_specs(cfg, policy)
    logits_spec = Spec(bax, policy.model_axis if policy.shard_vocab
                       else None)
    if shape.kind == "prefill":
        cache = abstract_cache(cfg, shape.global_batch, shape.seq_len,
                               long_context=False)

        def fn(params, cache, tokens, lengths, frontend=None):
            return T.prefill(params, tokens, lengths, cache, None, cfg,
                             frontend=frontend)

        args = [params, cache, ins["tokens"], ins["lengths"]]
        in_specs = [pspecs, cspecs, Spec(bax, None), Spec(bax)]
        if "frontend" in ins:
            args.append(ins["frontend"])
            in_specs.append(Spec(bax, None, None))
        return fn, tuple(args), tuple(in_specs), (logits_spec, cspecs), \
            policy

    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len,
                           long_context=long_ctx)

    def fn(params, cache, tokens, pos):
        return T.decode_step(params, cache, tokens, pos, cfg,
                             long_context=long_ctx)

    args = (params, cache, ins["tokens"], ins["pos"])
    in_specs = (pspecs, cspecs, Spec(bax, None), Spec(bax))
    return fn, args, in_specs, (logits_spec, cspecs), policy


def sharded_resident_gb(args, specs, mesh) -> float:
    """Analytic per-device GiB of the persistent inputs (params + cache or
    the train state) under their partition specs: each leaf's bytes over
    the product of the sizes of the mesh axes its spec names (the JAX
    ``sharded_resident_gb``)."""
    flat_args = leaves(args)
    flat_specs = spec_leaves(specs)
    if len(flat_args) != len(flat_specs):
        raise ValueError(f"{len(flat_args)} leaves, {len(flat_specs)} specs")
    total = 0.0
    for a, spec in zip(flat_args, flat_specs):
        shards = 1
        for part in spec:
            if part is None:
                continue
            for ax in (part if isinstance(part, tuple) else (part,)):
                shards *= mesh.shape[ax]
        total += a.numel() * a.element_size() / shards
    return total / 2**30
