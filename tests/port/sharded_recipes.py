"""The sharded recipes' rank programs, for ``test_torch_sharded.py``: each
runs on every rank of a ``launch/mesh.run_on_mesh`` spawn, so it lives in
an importable module that imports no JAX (the spawned ranks import it by
name). The test process makes every input with numpy (the JAX params
converted to numpy, seeded tokens), runs the JAX and the port's
single-device functions, and holds them against what the ranks return.

- ``models``: the recipes of ``tests/test_sharded_numerics.py`` (and
  reduced RecurrentGemma): each rank takes its shards of the params, runs
  ``forward``, ``prefill`` and ``decode_step`` with the policy on its own
  rows, and the gathered logits, the gathered cache and the policy's flags
  come back;
- ``seq_parallel``: ``tests/test_models.py``'s sequence-parallel decode and
  ring-write recipes on the model axis;
- ``train``: sharded train steps (AdamW; Adafactor with FSDP), the
  gathered params and metrics after each;
- ``placement``: ``shard_tree`` then ``gather_tree`` on full param trees
  (packed leaves included), each rank's bytes against
  ``sharded_resident_gb``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: tests/test_sharded_numerics.py's sizes: batch, sequence, prompt
B, S, S0 = 4, 16, 10


def reduced(arch: str, heads: int, kv: int, **kw):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced(n_heads=heads, n_kv_heads=kv,
                                   d_model=128, head_dim=32, **kw)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    return cfg


def _np(t):
    return t.detach().float().cpu().numpy()


def _tree_np(tree):
    from repro_torch.training.tree import leaves, unflatten
    return unflatten(tree, [_np(t) for t in leaves(tree)])


def _policy(cfg, mesh, **kw):
    from repro_torch.models.sharding import make_policy
    return make_policy(cfg, mesh, global_batch=B, **kw)


def _rows(t, policy, mesh):
    """This rank's batch rows of a global input."""
    from repro_torch.models import sharding as SH
    bax = policy.data_axes if policy.shard_batch else None
    return SH.shard_leaf(t, SH.Spec(bax), mesh).clone()


def _logits(t, policy, mesh):
    from repro_torch.models import sharding as SH
    bax = policy.data_axes if policy.shard_batch else None
    vocab = policy.model_axis if policy.shard_vocab else None
    spec = SH.Spec(bax, None, vocab) if t.dim() == 3 else SH.Spec(bax, vocab)
    return _np(SH.gather_leaf(t, spec, mesh))


def models(mesh, recipes):
    """Every recipe ``(name, arch, heads, kv, policy kwargs, params (numpy,
    the JAX tree), tokens)``: the sharded forward, prefill and decode on
    this mesh. Returns {name: {"forward", "prefill", "decode", "cache",
    "policy", "launches"}}."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    out = {}
    for name, arch, heads, kv, kw, np_params, toks in recipes:
        cfg = reduced(arch, heads, kv)
        policy = _policy(cfg, mesh, **kw)
        full = params_from_jax(np_params, device="cpu")
        params = SH.shard_tree(full, T.param_specs(cfg, policy), mesh, cfg)
        del full
        toks = _rows(torch.from_numpy(toks), policy, mesh)
        lens = torch.full((toks.shape[0],), S0, dtype=torch.int32)
        with torch.no_grad():
            fwd, _ = T.forward(params, toks, cfg, policy=policy)
            cache = T.init_cache(cfg, B, S + 4, torch.float32, "cpu",
                                 policy=policy)
            pre, cache = T.prefill(params, toks[:, :S0], lens, cache, None,
                                   cfg, policy=policy)
            dec, cache = T.decode_step(params, cache, toks[:, S0:S0 + 1],
                                       lens.clone(), cfg, policy=policy)
        cspecs = T.cache_specs(cfg, policy)
        out[name] = {
            "forward": _logits(fwd, policy, mesh),
            "prefill": _logits(pre, policy, mesh),
            "decode": _logits(dec, policy, mesh),
            "cache": _tree_np(SH.gather_tree(cache, cspecs, mesh, cfg)),
            "policy": {k: getattr(policy, k) for k in (
                "shard_heads", "shard_kv_heads", "seq_parallel_decode",
                "shard_experts", "shard_vocab", "shard_batch")},
        }
    return out


def seq_parallel(mesh, q, kc, vc, kvpos, pos, new, slot):
    """The sequence-parallel decode and ring write on the model axis: each
    rank takes its block of the cache's rows; returns (attention output,
    the gathered cache after the ring write)."""
    from repro_torch.models import attention as A
    from repro_torch.models import sharding as SH
    spec = SH.Spec(None, "model")
    kl = SH.shard_leaf(torch.from_numpy(kc), spec, mesh).clone()
    vl = SH.shard_leaf(torch.from_numpy(vc), spec, mesh).clone()
    pl = SH.shard_leaf(torch.from_numpy(kvpos), spec, mesh).clone()
    o = A.seq_parallel_decode_attention(
        torch.from_numpy(q), kl, vl, pl, torch.from_numpy(pos), mesh=mesh,
        axis="model")
    A.write_cache_slot_seq_sharded(kl, torch.from_numpy(new),
                                   torch.from_numpy(slot), mesh=mesh,
                                   axis="model")
    return _np(o), _np(SH.gather_leaf(kl, spec, mesh))


def placement(mesh, cases):
    """``cases`` (name, arch, heads, kv, policy kwargs): for each, the port's
    seeded init at the reduced widths, cut by ``shard_tree`` and put back
    by ``gather_tree``; the init with the policy (leaf by leaf) against
    the cut. Returns {name: (max |gathered - full|, every leaf equal to
    its cut, this rank's parameter bytes, sharded_resident_gb's)}."""
    from repro_torch.launch.specs import sharded_resident_gb
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.training.tree import leaves
    out = {}
    for name, arch, heads, kv, kw in cases:
        cfg = reduced(arch, heads, kv)
        policy = _policy(cfg, mesh, **kw)
        specs = T.param_specs(cfg, policy)
        full = T.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
        local = SH.shard_tree(full, specs, mesh, cfg)
        back = SH.gather_tree(local, specs, mesh, cfg)
        err = max(float((a - b).abs().max()) for a, b
                  in zip(leaves(back), leaves(full)))
        placed = T.init_params(cfg, seed=3, dtype=torch.float32,
                               device="cpu", policy=policy)
        same = all(torch.equal(a, b) for a, b
                   in zip(leaves(placed), leaves(local)))
        nbytes = sum(t.numel() * t.element_size() for t in leaves(placed))
        out[name] = (err, same, nbytes,
                     sharded_resident_gb(full, specs, mesh) * 2**30)
    return out


def train(mesh, cases):
    """Every case ``(name, arch, heads, kv, policy kwargs, step kwargs,
    params (numpy), batches (numpy dicts))``: this rank's shards through
    ``make_train_step(cfg, policy)``, one step a batch. Returns {name:
    ([(loss, aux, grad_norm) per step], the gathered params after the
    last step)}."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.training.trainer import make_train_step
    out = {}
    for name, arch, heads, kv, kw, step_kw, np_params, batches in cases:
        cfg = reduced(arch, heads, kv)
        policy = _policy(cfg, mesh, **kw)
        specs = T.param_specs(cfg, policy)
        params = SH.shard_tree(params_from_jax(np_params, device="cpu"),
                               specs, mesh, cfg)
        init_fn, step_fn = make_train_step(cfg, policy, **step_kw)
        state = init_fn(params)
        metrics = []
        for batch in batches:
            local = {k: _rows(torch.from_numpy(v), policy, mesh)
                     for k, v in batch.items()}
            state, m = step_fn(state, local)
            metrics.append(tuple(float(m[k]) for k in
                                 ("loss", "aux", "grad_norm")))
        out[name] = (metrics, _tree_np(SH.gather_tree(state.params, specs,
                                                      mesh, cfg)))
    return out


def fail_on_rank(mesh, rank: int):
    """Raise on ``rank`` while the others wait in a collective."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails")
    from repro_torch.models import sharding as SH
    return float(SH.psum(torch.ones(1), "model", mesh))


def suite(mesh, jobs):
    """Several of this module's programs in one spawn: ``jobs`` {name:
    (function name, args)}; returns {name: result}."""
    return {name: globals()[fn](mesh, *args)
            for name, (fn, args) in jobs.items()}


def card_qwen(mesh):
    """Qwen3-1.7B at full width and depth, fp32, on this rank's card:
    forward (2 x 128), prefill of 120 tokens and 4 teacher-forced decode
    steps with the policy on this rank's rows; rank 0 then the unsharded
    port on its card. Returns {"launches" (flash, decode on this rank),
    "errors" (rank 0: per output the max abs error and the logits' scale
    over the real vocab)}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-1.7b")
    dev = mesh.device
    b, s, s0 = 2, 128, 120
    gen = torch.Generator().manual_seed(7)
    whole = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                          dtype=torch.int32).to(dev)

    def drive(params, toks, policy):
        lens = torch.full((toks.shape[0],), s0, dtype=torch.int32,
                          device=dev)
        out = {}
        with torch.no_grad():
            out["forward"], _ = T.forward(params, toks, cfg, policy=policy)
            cache = T.init_cache(cfg, b, s, torch.float32, dev,
                                 policy=policy)
            out["prefill"], cache = T.prefill(params, toks[:, :s0], lens,
                                              cache, None, cfg,
                                              policy=policy)
            for i in range(4):
                out[f"decode{i}"], cache = T.decode_step(
                    params, cache, toks[:, s0 + i:s0 + i + 1], lens + i,
                    cfg, policy=policy)
        return out

    policy = SH.make_policy(cfg, mesh, global_batch=b)
    params = T.init_params(cfg, seed=7, dtype=torch.float32, device=dev,
                           policy=policy)
    bax = policy.data_axes if policy.shard_batch else None
    FA.launches = DA.launches = 0
    rows = drive(params, SH.shard_leaf(whole, SH.Spec(bax), mesh)
                 .contiguous(), policy)
    launches = {"flash": FA.launches, "decode": DA.launches}
    got = {k: SH.gather_leaf(v, SH.Spec(bax, None, "model") if v.dim() == 3
                             else SH.Spec(bax, "model"), mesh)
           for k, v in rows.items()}
    del params, rows
    out = {"launches": launches}
    if mesh.rank == 0:
        want = drive(T.init_params(cfg, seed=7, dtype=torch.float32,
                                   device=dev), whole, None)
        out["errors"] = {k: (float((got[k] - want[k]).abs().max()),
                             float(want[k][..., :cfg.vocab_size].abs().max()))
                         for k in want}
    return out
