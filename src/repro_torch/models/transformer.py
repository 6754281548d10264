"""The transformer of the Bullet serving path: init, page pool, dense slot
cache, prefill (also of a suffix over shared-prefix pages, and under the
long-context window), the chunked prefill (``prefill_chunk``: a chunk of a
prompt over its cached context), paged and dense decode, and the fused
prefill-group + decode cycle.

The port covers stacks of full-attention blocks with an MLP or a routed
mixture of experts (the paged path, ``supports_paged_cache``), of
sliding-window attention blocks with either (Mixtral), of Mamba-2 SSD
blocks, and of RG-LRU and sliding-window attention blocks
(RecurrentGemma), the last three on the dense slot cache only:
``n_pattern_repeats`` repeats of ``cfg.pattern``, with
per-pattern parameters stacked along a leading repeat axis R, then the
unstacked ``cfg.pattern_tail`` blocks (``params["tail_blocks"]``,
``cache["tail"]``), as in the JAX package. Python loops over the repeats
take the place of ``lax.scan``. Page pools and slot caches are updated in
place where the JAX package donated its buffers. The dense slot cache
keeps the JAX package's ring semantics, addressed through
``_kv_positions``: a sliding-window block's cache of ``min(window,
max_len)`` rows is always a ring, a full-attention cache only under
``long_context``; an SSD or RG-LRU block's entry is its conv window and
recurrent state. An encoder-decoder config (SeamlessM4T) adds the
bidirectional encoder over its stub frontend frames (``encode``) and a
cross-attention after each decoder block's mixer, over the encoder's K/V
(prefill) or the cross cache ``cache["cross"]`` (decode); a decoder-only
VLM (InternVL2) prepends its projected stub frontend to the prompt. Both
run through the models-level ``prefill`` / ``decode_step`` / ``forward``.

A MoE block's capacity counts the tokens of its call (``models/moe.py``).
Every prefill path passes each row's length, so padded rows take no
capacity and a prompt's result does not depend on its padding (the JAX
package counts the padding; ROADMAP §3). A decode pass passes none: its
(B, 1, D) slot array has the JAX engine's shape, and with at most 8 slots
the capacity (at least 8) is never reached; past 8 slots inactive slots
take capacity as in the JAX package.

Sharded (ROADMAP §1 item 8d): ``forward``, ``prefill`` (dense cache) and
``decode_step`` (dense cache) take ``policy=`` as the JAX functions do;
``init_params`` and ``init_cache`` take it too and build this rank's
shards. With ``policy.mesh`` a running mesh of more than one rank
(``launch/mesh.RankMesh``) every argument and result is the rank's own:
the batch rows over the data axes when ``policy.shard_batch``, the
logits' vocab block over "model" when ``policy.shard_vocab``, every leaf
cut by ``param_specs`` / ``cache_specs``. The JAX package's GSPMD
constraints become explicit collectives (``models/sharding.py``): query
heads split when ``shard_heads`` (kernel 1 and kernel 4 on the rank's
heads, ``wo`` row parallel), else the attention runs replicated with
``wq``/``wk``/``wv`` row parallel and ``wo`` column parallel; KV heads
split when ``shard_kv_heads``, else under ``seq_parallel_decode`` the
dense cache is split over its sequence and decode writes through
``write_cache_slot_seq_sharded`` and attends through
``seq_parallel_decode_attention``; the MLP, the MoE
(``moe_ffn_sharded``: 2D weights, token-parallel, or the whole-batch
default), SSD heads and the RG-LRU width as their specs split them; the
embedding and the head by ``shard_vocab`` (the padded-vocab mask offset
by the rank's block); FSDP leaves all-gathered over the data axes at use.
The paged functions, the fused cycle and the chunked prefill take no
policy, as in the JAX engine, which never passes one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import (ATTN, MLP, MOE, RGLRU, SSD, SWA,
                                      BlockSpec, ModelConfig)
from repro_torch.models import attention as attn_ops
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models.moe import MoEStats, moe_ffn, moe_ffn_sharded
from repro_torch.models.rglru import RGLRUState, rglru_block
from repro_torch.models.sharding import TP, ShardingPolicy, Spec, tp_matmul
from repro_torch.models.ssm import SSDState, ssd_block

Params = Dict[str, Any]

#: leaves kept in fp32 whatever the serving dtype: Mamba-2's ``A_log`` and
#: RG-LRU's ``lambda`` (both set a decay that compounds its rounding along
#: the sequence; the gates read them in fp32 anyway) and the SSD and RG-LRU
#: recurrent states, which the JAX cache keeps in fp32 too. The bridge
#: (``repro_torch/bridge.py``) follows the same rule.
FP32_PARAMS = frozenset({"A_log", "lambda"})
FP32_CACHE = frozenset({"ssm", "hidden"})


# ---------------------------------------------------------------------------
# Parameter definitions: (shape, init) per name, as the JAX package's PDefs
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig,
               cross: bool = False) -> Dict[str, Tuple[tuple, str]]:
    """Self-attention's leaves, or (``cross``) a decoder block's
    cross-attention ``cwq/cwk/cwv/cwo``, which take no bias and no qk
    norm, as in the JAX package."""
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pre = "c" if cross else ""
    defs = {
        pre + "wq": ((d, h * dh), "dense"),
        pre + "wk": ((d, k * dh), "dense"),
        pre + "wv": ((d, k * dh), "dense"),
        pre + "wo": ((h * dh, d), "dense"),
    }
    if cross:
        return defs
    if cfg.qkv_bias:
        defs["bq"] = ((h * dh,), "zeros")
        defs["bk"] = ((k * dh,), "zeros")
        defs["bv"] = ((k * dh,), "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ((dh,), "zeros")
        defs["k_norm"] = ((dh,), "zeros")
    return defs


def _ssd_defs(cfg: ModelConfig) -> Dict[str, Tuple[tuple, str]]:
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    kw = cfg.rglru_conv_width
    return {
        "in_proj": ((d, 2 * di + 2 * n + h), "dense"),
        "conv": ((kw, di + 2 * n), "dense"),
        "A_log": ((h,), "lru"),
        "D": ((h,), "ones"),
        "dt_bias": ((h,), "zeros"),
        "norm": ((di,), "zeros"),
        "out_proj": ((di, d), "dense"),
    }


def _rglru_defs(cfg: ModelConfig) -> Dict[str, Tuple[tuple, str]]:
    d, w = cfg.d_model, cfg.lru_width
    kw = cfg.rglru_conv_width
    return {
        "w_in": ((d, 2 * w), "dense"),
        "conv": ((kw, w), "dense"),
        "w_a": ((w, w), "dense"),
        "w_x": ((w, w), "dense"),
        "b_a": ((w,), "zeros"),
        "b_x": ((w,), "zeros"),
        "lambda": ((w,), "lru"),
        "w_out": ((w, d), "dense"),
    }


def _moe_defs(cfg: ModelConfig) -> Dict[str, Tuple[tuple, str]]:
    """The JAX shapes: the router, every expert's fused gate|up and down
    projections, and the shared expert's when ``n_shared_experts``. A
    dense leaf's init scale is 1/sqrt(its first dim), the expert count for
    ``w_in`` / ``w_out``, as in the JAX package."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = {
        "router": ((d, e), "dense"),
        "w_in": ((e, d, 2 * f), "dense"),
        "w_out": ((e, f, d), "dense"),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs["shared_wi"] = ((d, 2 * fs), "dense")
        defs["shared_wo"] = ((fs, d), "dense")
    return defs


_MIXER_DEFS = {ATTN: _attn_defs, SWA: _attn_defs, SSD: _ssd_defs,
               RGLRU: _rglru_defs}


def _block_defs(cfg: ModelConfig, blk: BlockSpec, *, decoder: bool = True):
    """A block's leaves: ``ln1``, its mixer's, for a decoder block of a
    config with cross-attention ``ln_cross`` and the cross leaves, then
    ``ln2`` and its feed-forward's (the encoder's blocks are built with
    ``decoder=False``)."""
    if blk.mixer not in _MIXER_DEFS:
        raise ValueError(f"{cfg.name}: unknown mixer {blk.mixer!r}")
    d = cfg.d_model
    defs = {"ln1": ((d,), "zeros")}
    defs.update(_MIXER_DEFS[blk.mixer](cfg))
    if decoder and cfg.cross_attention:
        defs["ln_cross"] = ((d,), "zeros")
        defs.update(_attn_defs(cfg, cross=True))
    if blk.ff != "none":
        defs["ln2"] = ((d,), "zeros")
    if blk.ff == MLP:
        defs["wi"] = ((d, 2 * cfg.d_ff), "dense")
        defs["wo_mlp"] = ((cfg.d_ff, d), "dense")
    elif blk.ff == MOE:
        defs.update(_moe_defs(cfg))
    return defs


def _top_defs(cfg: ModelConfig):
    d, v = cfg.d_model, cfg.vocab_padded
    defs = {"embed": ((v, d), "embed"), "final_norm": ((d,), "zeros")}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((d, v), "dense")
    if cfg.frontend_embed_len:
        defs["frontend_proj"] = ((cfg.frontend_embed_dim, d), "dense")
    return defs


def _init_one(gen, shape, init, dtype, *, lead=(), fan_in=None):
    full = tuple(lead) + tuple(shape)
    if gen is None:                     # the meta device: shapes only
        return torch.empty(full, dtype=dtype, device="meta")
    if init == "dense":
        return L.dense_init(gen, full, dtype, fan_in=fan_in or shape[0])
    if init == "embed":
        return L.embed_init(gen, full, dtype)
    if init == "zeros":
        return torch.zeros(full, dtype=dtype, device=gen.device)
    if init == "ones":
        return torch.ones(full, dtype=dtype, device=gen.device)
    if init == "lru":   # Griffin Lambda / mamba A_log init
        u = torch.rand(full, generator=gen, dtype=torch.float32,
                       device=gen.device) * 0.8 + 0.1
        return torch.log(u / (1 - u)).to(dtype)
    raise ValueError(init)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype=torch.bfloat16, device="cuda",
                policy: Optional[ShardingPolicy] = None) -> Params:
    """Seeded random params with the JAX package's tree, shapes and
    distributions (no bit parity with jax.random): ``{"embed",
    "final_norm", ["lm_head"], ["frontend_proj"], "blocks": (per pattern
    position {name: (R, ...)}), ["tail_blocks": (per tail block {name:
    (...)})], ["encoder": {name: (n_encoder_layers, ...)},
    "encoder_norm"]}``, vocab padded to a multiple of 256. Leaves in
    ``FP32_PARAMS`` stay fp32. On the meta device (a dry-run) the leaves
    hold shapes and dtypes only, drawn from no generator. With a
    ``policy`` on a mesh, this rank's shards (``param_specs``): each leaf
    is drawn whole, as without one, and cut at once, so a rank holds one
    full leaf at a time, never the full tree, and its shards equal the
    unsharded init's."""
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    place = _placer(cfg, policy)

    def one(path, shape, init, dt, lead=()):
        return place(path, _init_one(gen, shape, init, dt, lead=lead))

    params: Params = {}
    for name, (shape, init) in sorted(_top_defs(cfg).items()):
        params[name] = one((name,), shape, init, dtype)

    def block(key, j, blk, lead):
        return {name: one((key, j, name), shape, init,
                          torch.float32 if name in FP32_PARAMS else dtype,
                          lead)
                for name, (shape, init)
                in sorted(_block_defs(cfg, blk).items())}

    params["blocks"] = tuple(block("blocks", j, blk,
                                   (cfg.n_pattern_repeats,))
                             for j, blk in enumerate(cfg.pattern))
    if cfg.pattern_tail:
        params["tail_blocks"] = tuple(block("tail_blocks", j, blk, ())
                                      for j, blk
                                      in enumerate(cfg.pattern_tail))
    if cfg.n_encoder_layers:
        enc = _block_defs(cfg, BlockSpec(mixer=ATTN, ff=MLP), decoder=False)
        params["encoder"] = {
            name: one(("encoder", name), shape, init, dtype,
                      (cfg.n_encoder_layers,))
            for name, (shape, init) in sorted(enc.items())}
        params["encoder_norm"] = place(("encoder_norm",), torch.zeros(
            cfg.d_model, dtype=dtype, device=device))
    return params


def _placer(cfg: ModelConfig, policy: Optional[ShardingPolicy],
            specs=None):
    """(path, full leaf) -> this rank's shard of it under ``policy``'s
    specs (``param_specs``, or ``specs``), copied out; the leaf itself
    without a policy on a mesh."""
    if TP.of(policy) is None:
        return lambda path, t: t
    specs = param_specs(cfg, policy) if specs is None else specs

    def place(path, t):
        secs = SH.leaf_sections(cfg, path[-1], t.shape[-1]) if t.dim() \
            else None
        local = SH.shard_leaf(t, SH.spec_at(specs, path), policy.mesh, secs)
        return local if local is t else local.clone()
    return place


# ---------------------------------------------------------------------------
# Partition specs: the JAX package's, per leaf, as plain data
# ---------------------------------------------------------------------------

def _mp(policy: ShardingPolicy, cond: bool = True):
    return policy.model_axis if (policy and cond) else None


def _attn_specs(cfg: ModelConfig, p: ShardingPolicy, cross: bool = False):
    pre = "c" if cross else ""
    kv = (Spec(None, _mp(p, p.shard_kv_heads)) if p.shard_kv_heads
          else Spec(_mp(p), None))
    specs = {
        pre + "wq": (Spec(None, _mp(p, p.shard_heads)) if p.shard_heads
                     else Spec(_mp(p), None)),
        pre + "wk": kv,
        pre + "wv": kv,
        pre + "wo": (Spec(_mp(p, p.shard_heads), None) if p.shard_heads
                     else Spec(None, _mp(p))),
    }
    if cross:
        return specs
    if cfg.qkv_bias:
        specs["bq"] = Spec(_mp(p, p.shard_heads))
        specs["bk"] = Spec(_mp(p, p.shard_kv_heads))
        specs["bv"] = Spec(_mp(p, p.shard_kv_heads))
    if cfg.qk_norm:
        specs["q_norm"] = Spec(None)
        specs["k_norm"] = Spec(None)
    return specs


def _ssd_specs(cfg: ModelConfig, p: ShardingPolicy):
    hs = Spec(_mp(p, cfg.ssm_n_heads % max(p.model_size, 1) == 0))
    return {"in_proj": Spec(None, _mp(p)), "conv": Spec(None, _mp(p)),
            "A_log": hs, "D": hs, "dt_bias": hs, "norm": Spec(_mp(p)),
            "out_proj": Spec(_mp(p), None)}


def _rglru_specs(cfg: ModelConfig, p: ShardingPolicy):
    col, vec = Spec(None, _mp(p)), Spec(_mp(p))
    return {"w_in": col, "conv": col, "w_a": col, "w_x": col, "b_a": vec,
            "b_x": vec, "lambda": vec, "w_out": Spec(_mp(p), None)}


def _moe_specs(cfg: ModelConfig, p: ShardingPolicy):
    e = _mp(p, p.shard_experts)
    if p.moe_2d_weights:
        # d_ff over data (and model when experts cannot span it)
        f = tuple(p.data_axes)
        if not p.shard_experts and p.model_axis:
            f = (p.model_axis,) + f
        f = f or None
        w_in, w_out = Spec(e, None, f), Spec(e, f, None)
    elif p.shard_experts:
        w_in = w_out = Spec(e, None, None)
    else:
        w_in, w_out = Spec(None, None, _mp(p)), Spec(None, _mp(p), None)
    specs = {"router": Spec(None, None), "w_in": w_in, "w_out": w_out}
    if cfg.n_shared_experts:
        specs["shared_wi"] = Spec(None, _mp(p))
        specs["shared_wo"] = Spec(_mp(p), None)
    return specs


_MIXER_SPECS = {ATTN: _attn_specs, SWA: _attn_specs, SSD: _ssd_specs,
                RGLRU: _rglru_specs}


def _block_specs(cfg: ModelConfig, blk: BlockSpec, p: ShardingPolicy, *,
                 decoder: bool = True):
    specs = {"ln1": Spec(None)}
    specs.update(_MIXER_SPECS[blk.mixer](cfg, p))
    if decoder and cfg.cross_attention:
        specs["ln_cross"] = Spec(None)
        specs.update(_attn_specs(cfg, p, cross=True))
    if blk.ff != "none":
        specs["ln2"] = Spec(None)
    if blk.ff == MLP:
        specs["wi"] = Spec(None, _mp(p))
        specs["wo_mlp"] = Spec(_mp(p), None)
    elif blk.ff == MOE:
        specs.update(_moe_specs(cfg, p))
    return specs


def _top_specs(cfg: ModelConfig, p: ShardingPolicy):
    specs = {"embed": (Spec(_mp(p, p.shard_vocab), None) if p.shard_vocab
                       else Spec(None, _mp(p))),
             "final_norm": Spec(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (Spec(None, _mp(p, p.shard_vocab))
                            if p.shard_vocab else Spec(_mp(p), None))
    if cfg.frontend_embed_len:
        specs["frontend_proj"] = Spec(None, None)
    return specs


def _maybe_fsdp(spec: Spec, shape, policy: ShardingPolicy) -> Spec:
    """FSDP: shard the first unsharded dim the data axes divide over them
    too (a leaf already sharded over a data axis keeps its spec)."""
    if not policy.fsdp or not policy.data_axes:
        return spec
    for part in spec:
        axes = part if isinstance(part, tuple) else (part,)
        if any(a in policy.data_axes for a in axes if a):
            return spec
    dsz = policy.data_size
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (pt, dim) in enumerate(zip(parts, shape)):
        if pt is None and dim % dsz == 0 and dim >= dsz:
            parts[i] = (policy.data_axes if len(policy.data_axes) > 1
                        else policy.data_axes[0])
            return Spec(*parts)
    return spec


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    """The partition-spec tree of :func:`init_params`'s params: the JAX
    ``param_specs``, leaf for leaf (a stacked leaf's repeat axis
    replicated)."""
    def specs_of(defs, rules, stacked):
        out = {}
        for name, (shape, _) in sorted(defs.items()):
            spec = _maybe_fsdp(rules[name], shape, policy)
            out[name] = Spec(None, *spec) if stacked else spec
        return out

    specs = specs_of(_top_defs(cfg), _top_specs(cfg, policy), False)
    specs["blocks"] = tuple(
        specs_of(_block_defs(cfg, blk), _block_specs(cfg, blk, policy),
                 True) for blk in cfg.pattern)
    if cfg.pattern_tail:
        specs["tail_blocks"] = tuple(
            specs_of(_block_defs(cfg, blk), _block_specs(cfg, blk, policy),
                     False) for blk in cfg.pattern_tail)
    if cfg.n_encoder_layers:
        enc = BlockSpec(mixer=ATTN, ff=MLP)
        specs["encoder"] = specs_of(
            _block_defs(cfg, enc, decoder=False),
            _block_specs(cfg, enc, policy, decoder=False), True)
        specs["encoder_norm"] = Spec(None)
    return specs


def cache_specs(cfg: ModelConfig, policy: ShardingPolicy) -> Dict[str, Any]:
    """The partition-spec tree of :func:`init_cache`'s dense cache: the
    JAX ``cache_specs``, leaf for leaf (the repeat axis replicated, the
    batch over the data axes when they divide it)."""
    b = policy.data_axes if policy.shard_batch else None
    m = policy.model_axis

    def entry(blk, lead):
        if blk.mixer in (ATTN, SWA):
            if policy.shard_kv_heads:
                s = Spec(*lead, b, None, m, None)
            elif policy.seq_parallel_decode:
                s = Spec(*lead, b, m, None, None)
            else:
                s = Spec(*lead, b, None, None, None)
            return {"k": s, "v": s}
        if blk.mixer == RGLRU:
            return {"conv": Spec(*lead, b, None, m),
                    "hidden": Spec(*lead, b, m)}
        hm = m if cfg.ssm_n_heads % max(policy.model_size, 1) == 0 else None
        return {"conv": Spec(*lead, b, None, m),
                "ssm": Spec(*lead, b, hm, None, None)}

    specs = {"blocks": tuple(entry(blk, (None,)) for blk in cfg.pattern)}
    if cfg.pattern_tail:
        specs["tail"] = tuple(entry(blk, ()) for blk in cfg.pattern_tail)
    if cfg.cross_attention:
        cs = Spec(None, b, None, m if policy.shard_kv_heads else None, None)
        specs["cross"] = {"k": cs, "v": cs}
    return specs


# ---------------------------------------------------------------------------
# Page pool
# ---------------------------------------------------------------------------

def supports_paged_cache(cfg: ModelConfig) -> bool:
    """Block-paged caches cover homogeneous full-attention stacks: every
    position is a GQA KV entry addressed by absolute position."""
    return (all(blk.mixer == ATTN for blk in cfg.pattern)
            and not cfg.pattern_tail and not cfg.cross_attention)


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cuda"):
    """Per pattern position a shared physical page pool ``(R, n_pages + 1,
    page_size, K, D)``, all indexed by the same logical block ids. The
    extra last page (index ``n_pages``) is the trash page: unused
    block-table entries point at it, so masked reads and inactive-slot
    writes stay in bounds."""
    assert supports_paged_cache(cfg), cfg.pattern
    shape = (cfg.n_pattern_repeats, n_pages + 1, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"blocks": tuple(
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in cfg.pattern)}


# ---------------------------------------------------------------------------
# Dense slot cache
# ---------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, blk: BlockSpec, max_len: int,
               long_context: bool) -> int:
    if blk.mixer == ATTN and long_context:
        return min(cfg.long_context_window, max_len)
    if blk.mixer == SWA:
        return min(cfg.sliding_window, max_len)
    return max_len


def _is_ring(blk: BlockSpec, long_context: bool) -> bool:
    """A cache is a ring iff positions can pass its length: a sliding-window
    block's always, a full-attention block's only in the long-context
    window."""
    return blk.mixer == SWA or (blk.mixer == ATTN and long_context)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", *,
               long_context: bool = False,
               policy: Optional[ShardingPolicy] = None):
    """Dense decode cache, one entry per pattern position with a leading
    repeat axis R (``"blocks"``), and one per tail block without it
    (``"tail"``, when ``cfg.pattern_tail``): attention ``{"k", "v"}`` of
    shape (R, batch, S, K, D), one fixed row of S positions per slot (S =
    ``max_len``; a sliding-window block's ring holds ``min(window,
    max_len)`` rows, and ``long_context`` switches full attention to its
    ring of the long-context window); SSD ``{"conv": (R, batch, K-1,
    di+2N), "ssm": (R, batch, H, P, N) fp32}``; RG-LRU ``{"conv": (R, batch,
    K-1, W), "hidden": (R, batch, W) fp32}``. With cross-attention also
    ``"cross": {"k", "v"}`` of shape (R, batch, Se, K, D): the encoder's
    K/V as each repeat's first decoder block projects them (``prefill``
    fills it), which every block of the repeat reads. With a ``policy`` on
    a mesh (``batch`` the global batch), this rank's shard of every leaf
    (``cache_specs``), allocated at its local shape."""
    kw = cfg.rglru_conv_width
    tp = TP.of(policy)
    cspecs = cache_specs(cfg, policy) if tp is not None else None

    def zeros(shape, dt=dtype, path=None):
        if tp is not None:
            secs = SH.leaf_sections(cfg, path[-1], shape[-1])
            shape = SH.shard_leaf(torch.empty(shape, device="meta"),
                                  SH.spec_at(cspecs, path), tp.mesh,
                                  secs).shape
        return torch.zeros(shape, dtype=dt, device=device)

    def entry(blk, lead, at):
        _block_defs(cfg, blk)           # raises for blocks not served
        if blk.mixer == SSD:
            ch = cfg.ssm_d_inner + 2 * cfg.ssm_state
            return {"conv": zeros(lead + (batch, kw - 1, ch),
                                  path=at + ("conv",)),
                    "ssm": zeros(lead + (batch, cfg.ssm_n_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state),
                                 torch.float32, at + ("ssm",))}
        if blk.mixer == RGLRU:
            w = cfg.lru_width
            return {"conv": zeros(lead + (batch, kw - 1, w),
                                  path=at + ("conv",)),
                    "hidden": zeros(lead + (batch, w), torch.float32,
                                    at + ("hidden",))}
        s = _cache_len(cfg, blk, max_len, long_context)
        shape = lead + (batch, s, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(shape, path=at + ("k",)),
                "v": zeros(shape, path=at + ("v",))}

    cache = {"blocks": tuple(entry(blk, (cfg.n_pattern_repeats,),
                                   ("blocks", j))
                             for j, blk in enumerate(cfg.pattern))}
    if cfg.pattern_tail:
        cache["tail"] = tuple(entry(blk, (), ("tail", j))
                              for j, blk in enumerate(cfg.pattern_tail))
    if cfg.cross_attention:
        shape = (cfg.n_pattern_repeats, batch, cfg.encoder_seq_len,
                 cfg.n_kv_heads, cfg.head_dim)
        cache["cross"] = {"k": zeros(shape, path=("cross", "k")),
                          "v": zeros(shape, path=("cross", "v"))}
    return cache


def _window_gather(full_k, full_v, lengths, wsize: int):
    """Collapse prefill K/V (B,S,K,D) into ring-window caches (B,W,K,D).

    Slot s holds position p*(s) = len-1 - ((len-1-s) mod W) (the latest
    position congruent to s); invalid slots (p* < 0) are zeroed."""
    s_full = full_k.shape[1]
    slots = torch.arange(wsize, device=full_k.device)[None, :]
    last = lengths.long()[:, None] - 1
    pstar = last - torch.remainder(last - slots, wsize)
    valid = (pstar >= 0)[:, :, None, None]
    idx = pstar.clamp(0, s_full - 1)[:, :, None, None].expand(
        -1, -1, *full_k.shape[2:])
    gk = torch.where(valid, torch.gather(full_k, 1, idx), 0)
    gv = torch.where(valid, torch.gather(full_v, 1, idx), 0)
    return gk, gv


def _prefill_cache_entry(entry, blk: BlockSpec, cfg: ModelConfig, lengths,
                         cache_tpl, long_context: bool, shards: int = 1):
    """Convert a full-sequence cache entry into the decode cache layout of
    ``cache_tpl`` (pad full KV to the cache length, or gather into the
    ring window: always for a sliding-window block; recurrent states are
    cast to the template's dtypes). ``shards``: the template is one of
    that many blocks of the cache's sequence, and the whole layout is
    returned."""
    if blk.mixer not in (ATTN, SWA):
        return {key: entry[key].to(cache_tpl[key].dtype) for key in cache_tpl}
    tgt = cache_tpl["k"].shape[1] * shards            # (B, S_cache, K, D)
    k, v = entry["k"], entry["v"]
    s = k.shape[1]
    if blk.mixer == SWA or (long_context and tgt < s):
        k, v = _window_gather(k, v, lengths, tgt)
    elif s < tgt:
        pad = (0, 0, 0, 0, 0, tgt - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    else:
        k, v = k[:, :tgt], v[:, :tgt]
    return {"k": k.to(cache_tpl["k"].dtype), "v": v.to(cache_tpl["v"].dtype)}


def _kv_positions(pos, s_cache: int, window_like: bool):
    """(B, S_cache) int32 absolute position per cache row given the current
    pos (B,): row j for a linear cache; for a ring, the latest position
    congruent to j that is <= pos, or -1 when there is none."""
    slots = torch.arange(s_cache, dtype=torch.int32, device=pos.device)[None]
    if not window_like:
        return slots.expand(pos.shape[0], s_cache).contiguous()
    p = pos[:, None] - torch.remainder(pos[:, None] - slots, s_cache)
    return torch.where(p >= 0, p, -1).to(torch.int32)


def params_at(params_j: Dict[str, torch.Tensor], r: int):
    """One repeat's slice of a stacked per-pattern param dict (views)."""
    return {name: leaf[r] for name, leaf in params_j.items()}


def params_by_repeat(params_j: Dict[str, torch.Tensor]):
    """Every repeat's slice of a stacked per-pattern param dict (views),
    from one ``unbind`` per leaf. Under autograd a leaf's gradient is then
    one stack of its repeats' gradients, where a ``params_at`` per repeat
    would add a zero-filled copy of the whole stacked leaf per repeat."""
    names = list(params_j)
    return [dict(zip(names, slices))
            for slices in zip(*(params_j[n].unbind(0) for n in names))]


# ---------------------------------------------------------------------------
# Forward building blocks
# ---------------------------------------------------------------------------

def _tp(policy: Optional[ShardingPolicy], cfg: ModelConfig):
    """The call's :class:`TP` (None unless ``policy`` spans several
    ranks), with its FSDP plan (:func:`_fsdp_plan`) under ``policy.fsdp``.
    A page pool or a fused cycle is never sharded."""
    tp = TP.of(policy)
    if tp is not None:
        tp.fsdp = _fsdp_plan(cfg, policy) if policy.fsdp else None
    return tp


def _heads(tp: Optional[TP]) -> Tuple[bool, bool]:
    """(query heads split, KV heads split) over the model axis."""
    if tp is None or tp.model is None:
        return False, False
    return tp.policy.shard_heads, tp.policy.shard_kv_heads


def _fsdp_plan(cfg: ModelConfig, policy: ShardingPolicy):
    """What FSDP adds to each leaf's spec: ``{"top": {name: how},
    "blocks": ({name: how}, ...), ["tail_blocks"], ["encoder"]}``, each
    ``how`` (dim, data axes) or None, the dim counted in one repeat's
    slice for the stacked leaves."""
    full = param_specs(cfg, policy)
    base = param_specs(cfg, dataclasses.replace(policy, fsdp=False))

    def diff(f, b, stacked):
        if isinstance(f, Spec):
            for dim, (pf, pb) in enumerate(zip(f, b)):
                if pf != pb:
                    return (dim - stacked, pf)
            return None
        return {k: diff(f[k], b[k], stacked) for k in f}

    plan = {"top": {k: diff(full[k], base[k], 0) for k in full
                    if k not in ("blocks", "tail_blocks", "encoder")}}
    plan["blocks"] = tuple(diff(f, b, 1) for f, b
                           in zip(full["blocks"], base["blocks"]))
    if "tail_blocks" in full:
        plan["tail_blocks"] = tuple(diff(f, b, 0) for f, b in
                                    zip(full["tail_blocks"],
                                        base["tail_blocks"]))
    if "encoder" in full:
        plan["encoder"] = diff(full["encoder"], base["encoder"], 1)
    return plan


def _unfsdp(p: Dict[str, Any], plan, tp: Optional[TP]):
    """``p`` (one block's leaves, or the top-level ones) with its FSDP
    leaves all-gathered over the data axes (their gradient
    reduce-scattered back)."""
    if tp is None or not plan:
        return p
    out = dict(p)
    for name, how in plan.items():
        if how is not None and name in out:
            dim, axes = how
            out[name] = SH.gather_sum(out[name], dim, axes, tp.mesh)
    return out


def _kv_for_heads(k, v, cfg: ModelConfig, tp: Optional[TP]):
    """The K/V heads this rank's query heads read: all of them, or this
    rank's when both split; when only the query heads split, those of the
    whole K/V its heads map to (a slice when they map evenly, else one
    K/V head per query head)."""
    qs, kvs = _heads(tp)
    if not qs or kvs:
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    hl = cfg.n_heads // tp.m
    first = tp.r * hl
    if hl % g == 0:
        sl = slice(first // g, first // g + hl // g)
        return k[:, :, sl], v[:, :, sl]
    if g % hl == 0:
        sl = slice(first // g, first // g + 1)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.arange(first, first + hl, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _attn_out(o, w, tp: Optional[TP]):
    """The attention output (B, S, H_loc, D) through ``wo`` / ``cwo``:
    row parallel over the rank's heads when they split, else column
    parallel and all-gathered (the Megatron fallback)."""
    qs, _ = _heads(tp)
    if qs:
        return tp_matmul(_merge_heads(o), w, tp, "in", x_local=True)
    return tp_matmul(_merge_heads(o), w, tp, "out", gather=True)


def _project_qkv(x, p, cfg: ModelConfig, positions, tp=None):
    """q (B, S, H, D), k and v (B, S, K, D), each RoPE'd; sharded, H and
    K are this rank's heads where they split."""
    b, s, _ = x.shape
    h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qs, kvs = _heads(tp)
    q = tp_matmul(x, p["wq"], tp, "out" if qs else "in")
    kk = tp_matmul(x, p["wk"], tp, "out" if kvs else "in")
    v = tp_matmul(x, p["wv"], tp, "out" if kvs else "in")
    h, k = (h // tp.m if qs else h), (k // tp.m if kvs else k)
    if cfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    kk = kk.reshape(b, s, k, dh)
    v = v.reshape(b, s, k, dh)
    if cfg.qk_norm:
        # a replicated scale on this rank's own heads
        qn = tp.copy(p["q_norm"]) if qs else p["q_norm"]
        kn = tp.copy(p["k_norm"]) if kvs else p["k_norm"]
        q = L.rms_norm(q, qn, cfg.rmsnorm_eps)
        kk = L.rms_norm(kk, kn, cfg.rmsnorm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    kk = L.apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, v


def _ff(x, p, blk: BlockSpec, cfg: ModelConfig, lengths=None, stats=None,
        tp=None):
    """Feed-forward sub-block: the MLP, or the routed experts over each
    row's first ``lengths`` tokens (all of them without ``lengths``;
    ``models/moe.py``), their metrics added to ``stats`` (a
    :class:`MoEStats`) when given. Sharded: the MLP's d_ff over the model
    axis; the experts by the JAX dispatch rule, 2D weights first, then
    the token-parallel ``moe_ffn_sharded``, else the whole batch at
    once."""
    if blk.ff == "none":
        return torch.zeros_like(x)
    h = L.rms_norm(x, p["ln2"], cfg.rmsnorm_eps)
    if blk.ff == MLP:
        # ``L.gated_mlp`` by the matmul rule
        gate, up = tp_matmul(h, p["wi"], tp, "out").chunk(2, dim=-1)
        return tp_matmul(torch.nn.functional.silu(gate) * up, p["wo_mlp"],
                         tp, "in", x_local=True)
    valid = None
    if lengths is not None:
        cols = torch.arange(x.shape[1], device=x.device)[None, :]
        valid = cols < lengths[:, None]
    kw = dict(n_experts=cfg.n_experts, k=cfg.n_experts_per_token,
              capacity_factor=cfg.moe_capacity_factor, valid=valid)
    if tp is None:
        y, metrics = moe_ffn(h, p, **kw)
    else:
        y, metrics = moe_ffn_sharded(
            h, p, policy=tp.policy, **kw,
            token_parallel=tp.policy.moe_token_shard_map)
    if stats is not None:
        stats.add(metrics)
    return y


def _merge_heads(o):
    return o.reshape(*o.shape[:2], -1)


def _cross_attend(x, p, cfg: ModelConfig, cross_k, cross_v, cross_pos=None,
                  tp=None):
    """A decoder block's cross-attention over the encoder's K/V (B, Se, K,
    D): every query attends every encoder row, without RoPE. Over a prompt
    (``cross_pos`` None) it is kernel 1 with ``causal=False`` and Sq =
    the prompt's length, Sk = Se. In decode (``cross_pos`` = the cross
    cache's (kv_positions (B, Se) = 0..Se-1, pos (B,) = Se-1), so every
    row is attended) it is kernel 4, the dense decode kernel over the
    cross cache: one query a slot over Se rows is non-causal attention at
    Sq = 1, which kernel 1's 128-row query tile would run at 1/128 of its
    rows, while kernel 4 splits the rows across CTAs and reads each K/V
    row once for the slot's G query heads (the bytes bound it)."""
    h = L.rms_norm(x, p["ln_cross"], cfg.rmsnorm_eps)
    b, s, _ = h.shape
    q = tp_matmul(h, p["cwq"], tp, "out" if _heads(tp)[0] else "in")
    q = q.reshape(b, s, -1, cfg.head_dim)
    cross_k, cross_v = _kv_for_heads(cross_k, cross_v, cfg, tp)
    if cross_pos is None:
        o = attn_ops.attention_prefill(q, cross_k, cross_v, causal=False)
    else:
        o = attn_ops.attention_decode(q, cross_k, cross_v, *cross_pos)
    return _attn_out(o, p["cwo"], tp)


def _apply_block_full(x, p, blk: BlockSpec, cfg: ModelConfig, positions,
                      lengths=None, stats=None, cross_kv=None,
                      window_override=None, tp=None):
    """Prefill block application over a full sequence. Returns (x, entry):
    this layer's full-sequence KV ``{"k", "v"}`` (a sliding-window block
    attends over its window, a full-attention block over
    ``window_override`` when given: the long-context prefill), or an SSD
    block's state ``{"conv", "ssm"}``
    or an RG-LRU block's ``{"conv", "hidden"}`` after each row's
    ``lengths[b]`` tokens (after all of them without ``lengths``). A MoE
    block routes only the rows below ``lengths``. With ``cross_kv`` (the
    encoder's (K, V) as this block projects them) cross-attention follows
    the mixer. Sharded (``tp``): the entry is this rank's (its K/V heads
    when they split, else all of them; its state's shard)."""
    h = L.rms_norm(x, p["ln1"], cfg.rmsnorm_eps)
    if blk.mixer == SSD:
        y, st = ssd_block(h, p, cfg, lengths=lengths, tp=tp)
        entry = {"conv": st.conv, "ssm": st.ssm}
    elif blk.mixer == RGLRU:
        y, st = rglru_block(h, p, cfg, lengths=lengths, tp=tp)
        entry = {"conv": st.conv, "hidden": st.hidden}
    else:
        q, k, v = _project_qkv(h, p, cfg, positions, tp)
        window = cfg.sliding_window if blk.mixer == SWA else 0
        if window_override is not None and blk.mixer == ATTN:
            window = window_override
        ka, va = _kv_for_heads(k, v, cfg, tp)
        o = attn_ops.attention_prefill(q, ka, va, causal=True, window=window)
        y = _attn_out(o, p["wo"], tp)
        entry = {"k": k, "v": v}
    x = x + y
    if cross_kv is not None:
        x = x + _cross_attend(x, p, cfg, *cross_kv, tp=tp)
    x = x + _ff(x, p, blk, cfg, lengths, stats, tp)
    return x, entry


def _apply_block_decode(x, p, blk: BlockSpec, cfg: ModelConfig, cache_entry,
                        pos, block_tables=None, *, long_context: bool = False,
                        kv_positions=None, cross=None, tp=None):
    """Single-token block application, x: (B,1,D). The new token's K/V is
    written into the cache in place, then attention reads it.

    With ``block_tables`` (B, n_b) the entry is one layer's page pool
    {(P+1, ps, K, D)}: the token lands in its slot's current page and
    attention reads only the pages the table names. Without, it is the
    dense slot cache {(B, S, K, D)}: the token lands in row ``pos`` (ring:
    ``pos mod S`` for a sliding-window block, and for full attention under
    ``long_context``) and attention masks the rows by the (B, S) map
    ``kv_positions[(S, ring)]``, which :func:`decode_step` computes once
    for all the layers that share that cache length and ring. An SSD or
    RG-LRU block steps its recurrence and writes its new conv window and
    state into the entry in place. ``cross`` (cross_k, cross_v,
    kv_positions, pos) of the cross cache adds cross-attention after the
    mixer (``_cross_attend``). Sharded (``tp``, dense cache): the entry is
    this rank's; under ``seq_parallel_decode`` it is the rank's block of
    the sequence, the map covers the whole cache, and the token is written
    by the block's owner and attended by flash decoding over the blocks,
    every query head on every rank."""
    h = L.rms_norm(x, p["ln1"], cfg.rmsnorm_eps)
    if blk.mixer in (SSD, RGLRU):
        if blk.mixer == SSD:
            y, st = ssd_block(h, p, cfg, decode=True, state=SSDState(
                cache_entry["conv"], cache_entry["ssm"]), tp=tp)
            new = {"conv": st.conv, "ssm": st.ssm}
        else:
            y, st = rglru_block(h, p, cfg, decode=True, state=RGLRUState(
                cache_entry["conv"], cache_entry["hidden"]), tp=tp)
            new = {"conv": st.conv, "hidden": st.hidden}
        for key, t in new.items():
            cache_entry[key].copy_(t)
        x = x + y
        if cross is not None:
            x = x + _cross_attend(x, p, cfg, cross[0], cross[1], cross[2:],
                                  tp=tp)
        return x + _ff(x, p, blk, cfg, tp=tp)
    q, k_new, v_new = _project_qkv(h, p, cfg, pos[:, None], tp)
    if block_tables is not None:
        kp, vp = attn_ops.write_paged_kv(cache_entry["k"], cache_entry["v"],
                                         k_new, v_new, block_tables, pos)
        o = attn_ops.attention_decode_paged(q, kp, vp, block_tables, pos)
    elif _seq_par(tp):
        kc, vc = cache_entry["k"], cache_entry["v"]
        s_cache = kc.shape[1] * tp.m
        ring = _is_ring(blk, long_context)
        slot = (torch.remainder(pos, s_cache) if ring
                else pos.clamp(max=s_cache - 1))
        kw = dict(mesh=tp.mesh, axis=tp.model)
        attn_ops.write_cache_slot_seq_sharded(kc, k_new, slot, **kw)
        attn_ops.write_cache_slot_seq_sharded(vc, v_new, slot, **kw)
        kvpos = SH.split_to(kv_positions[(s_cache, ring)], 1, tp.model,
                            tp.mesh)
        if _heads(tp)[0]:
            q = tp.gather(q, 2)
        o = attn_ops.seq_parallel_decode_attention(q, kc, vc, kvpos, pos,
                                                   **kw)
        if _heads(tp)[0]:
            o = SH.split_to(o, 2, tp.model, tp.mesh)
    else:
        kc, vc = cache_entry["k"], cache_entry["v"]
        s_cache = kc.shape[1]
        ring = _is_ring(blk, long_context)
        slot = (torch.remainder(pos, s_cache) if ring
                else pos.clamp(max=s_cache - 1))
        attn_ops.write_cache_slot(kc, k_new, slot)
        attn_ops.write_cache_slot(vc, v_new, slot)
        kc, vc = _kv_for_heads(kc, vc, cfg, tp)
        o = attn_ops.attention_decode(q, kc, vc,
                                      kv_positions[(s_cache, ring)], pos)
    x = x + _attn_out(o, p["wo"], tp)
    if cross is not None:
        x = x + _cross_attend(x, p, cfg, cross[0], cross[1], cross[2:],
                              tp=tp)
    return x + _ff(x, p, blk, cfg, tp=tp)


def _seq_par(tp: Optional[TP]) -> bool:
    """The dense cache's attention entries split over their sequence (the
    JAX ``seq_parallel_decode`` with ``policy.mesh.size > 1``)."""
    return (tp is not None and tp.model is not None
            and tp.policy.seq_parallel_decode)


def scatter_prefill_pages(pages, kv, page_map, rep=None):
    """Scatter a prefill batch's full-sequence K or V (B, Sp, K, D) into a
    block-paged pool, in place (the JAX engine donated the pool to a
    functional scatter instead): prompt block ``(b, c)`` lands in physical
    page ``page_map[b, c]`` (trash page past each request's length, so
    padded rows are write-offs). ``pages`` is one layer's pool (P+1, ps,
    K, D), or the repeat-stacked pool (R, P+1, ps, K, D) with ``rep``
    naming the slice. Only the trash index may repeat in ``page_map``
    (``index_copy_`` then leaves garbage there, which nothing reads)."""
    ps = pages.shape[-3]
    pad = page_map.shape[1] * ps - kv.shape[1]
    if pad:
        kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
    kvb = kv.reshape(-1, ps, kv.shape[2], kv.shape[3]).to(pages.dtype)
    dst = pages if rep is None else pages[rep]
    dst.index_copy_(0, page_map.reshape(-1).long(), kvb)
    return pages


def scatter_suffix_pages(pages, kv, page_map, offsets, rep=None):
    """Scatter a *suffix* prefill's K or V (B, Ss, K, D) into a block-paged
    pool at a per-row page offset, in place (shared-prefix path,
    docs/KV_SHARING.md; the JAX engine donated the pool instead).

    Row ``b``'s suffix starts mid-page: its first token lands in page
    ``page_map[b, 0]`` at slot ``offsets[b]`` (the tail of a copy-on-write
    page, whose copied prefix below the offset must survive). Read-modify-
    write: gather the mapped pages, splice the suffix in at the offset
    (clamped so it fits, as ``dynamic_update_slice`` clamps), write the
    whole pages back. Rows pad with the trash page; a row's real pages are
    disjoint from every other row's, so the trash index is the only one
    that repeats, and it holds garbage by contract. ``pages`` is one
    layer's pool (P+1, ps, K, D), or the repeat-stacked pool with ``rep``
    naming the slice. Returns the (same) pool."""
    ps = pages.shape[-3]
    b, n_b = page_map.shape
    ss = kv.shape[1]
    dst = pages if rep is None else pages[rep]
    idx = page_map.reshape(-1).long()
    flat = dst.index_select(0, idx).reshape(b, n_b * ps, *dst.shape[2:])
    start = offsets.long().clamp(0, n_b * ps - ss)
    cols = start[:, None] + torch.arange(ss, device=kv.device)[None]
    rows = torch.arange(b, device=kv.device)[:, None]
    flat[rows, cols] = kv.to(pages.dtype)
    dst.index_copy_(0, idx, flat.reshape(-1, ps, *dst.shape[2:]))
    return pages


def _apply_block_prefix(x, p, blk: BlockSpec, cfg: ModelConfig, positions,
                        k_pre, v_pre, prefix_lens, lengths=None, stats=None):
    """Prefill block application for a suffix continuing reused prefix KV
    (docs/KV_SHARING.md). ``x`` (B, Ss, D) holds only the unshared suffix
    at absolute ``positions`` (B, Ss), ``lengths`` (B,) tokens of it per
    row; ``k_pre/v_pre`` (B, Lp, K, D) is the prefix KV gathered from
    shared pages, valid below ``prefix_lens``. Returns (x, {"k","v"}) with
    the *suffix's own* KV for page scatter."""
    assert blk.mixer == ATTN, blk.mixer
    h = L.rms_norm(x, p["ln1"], cfg.rmsnorm_eps)
    q, k, v = _project_qkv(h, p, cfg, positions)
    o = attn_ops.prefix_suffix_attention(q, k, v, k_pre, v_pre,
                                         prefix_lens, positions)
    x = x + _merge_heads(o) @ p["wo"]
    return x + _ff(x, p, blk, cfg, lengths, stats), {"k": k, "v": v}


def _apply_block_fused(x_p, x_d, p, blk: BlockSpec, cfg: ModelConfig,
                       positions_p, pos_d, cache_entry, block_tables,
                       page_map, decode_share: float, lengths=None,
                       stats=None):
    """Spatially-fused block application: one prefill layer of the current
    layer group AND one decode layer of the same (repeat, pattern)
    position share a single attention launch (paper §3.5 co-execution).

    The decode token's K/V is written to its slot's page FIRST, then the
    prefill group's K/V is scattered into its requests' pages (disjoint
    page sets: mid-prefill slots sit on the trash page in
    ``block_tables``). The prefill side's MoE routes only the rows below
    ``lengths`` and adds its metrics to ``stats``. Returns (x_p, x_d)."""
    hp = L.rms_norm(x_p, p["ln1"], cfg.rmsnorm_eps)
    qp, kp_new, vp_new = _project_qkv(hp, p, cfg, positions_p)
    hd = L.rms_norm(x_d, p["ln1"], cfg.rmsnorm_eps)
    qd, kd_new, vd_new = _project_qkv(hd, p, cfg, pos_d[:, None])
    kpg, vpg = attn_ops.write_paged_kv(
        cache_entry["k"], cache_entry["v"], kd_new, vd_new, block_tables,
        pos_d)
    scatter_prefill_pages(kpg, kp_new, page_map)
    scatter_prefill_pages(vpg, vp_new, page_map)
    op, od = attn_ops.attention_fused_paged(
        qp, kp_new, vp_new, qd, kpg, vpg, block_tables, pos_d,
        decode_share=decode_share, causal=True, window=0)
    x_p = x_p + _merge_heads(op) @ p["wo"]
    x_p = x_p + _ff(x_p, p, blk, cfg, lengths, stats)
    x_d = x_d + _merge_heads(od) @ p["wo"]
    x_d = x_d + _ff(x_d, p, blk, cfg)
    return x_p, x_d


def prefill_group(params, x, positions, rep: int, cfg: ModelConfig,
                  lengths=None, stats=None, enc_out=None,
                  window_override=None, tp=None):
    """Pattern-repeat group ``rep`` over a prompt batch: returns (x, [entry
    per pattern position]) — the raw full-sequence KV ``{"k", "v"}`` the
    caller scatters into pooled pages or writes into slot rows, or an SSD
    or RG-LRU block's recurrent state at each row's ``lengths`` (below
    which a MoE block routes; its metrics go to ``stats``). With the
    encoder's output ``enc_out`` each block cross-attends it, and its
    entry also holds the cross K/V it projected (``"cross"``).
    ``window_override``: the full-attention blocks' window (the
    long-context prefill). ``tp``: sharded (the module docstring)."""
    entries = []
    for j, blk in enumerate(cfg.pattern):
        p = params_at(params["blocks"][j], rep)
        if tp is not None and tp.fsdp:
            p = _unfsdp(p, tp.fsdp["blocks"][j], tp)
        cross = (None if enc_out is None
                 else _cross_kv_from_encoder(p, enc_out, cfg, tp))
        x, entry = _apply_block_full(x, p, blk, cfg, positions, lengths,
                                     stats, cross, window_override, tp)
        if cross is not None:
            entry["cross"] = cross
        entries.append(entry)
    return x, entries


def prefill_group_shared(params, cache, x, positions, prefix_map,
                         prefix_lens, rep: int, cfg: ModelConfig,
                         lengths=None, stats=None):
    """Pattern-repeat group ``rep`` over a *suffix* batch whose leading
    ``prefix_lens`` tokens are served from shared pages
    (docs/KV_SHARING.md): per layer, gather the prefix K/V from repeat
    ``rep`` of the page pool through ``prefix_map`` (B, Lp) and attend
    prefix and suffix jointly (a MoE block routes each row's first
    ``lengths`` suffix tokens). The pool is only read here. Returns (x,
    [the suffix's own ``{"k", "v"}`` per pattern position]) for
    :func:`scatter_suffix_group_pages`."""
    b = prefix_map.shape[0]
    pm = prefix_map.long()
    entries = []
    for j, blk in enumerate(cfg.pattern):
        leaf = cache["blocks"][j]
        k_pre = leaf["k"][rep][pm].reshape(b, -1, *leaf["k"].shape[-2:])
        v_pre = leaf["v"][rep][pm].reshape(b, -1, *leaf["v"].shape[-2:])
        x, entry = _apply_block_prefix(
            x, params_at(params["blocks"][j], rep), blk, cfg, positions,
            k_pre, v_pre, prefix_lens, lengths, stats)
        entries.append(entry)
    return x, entries


def decode_repeat(params, cache, x, pos, rep: int, cfg: ModelConfig,
                  block_tables=None, *, long_context: bool = False,
                  kv_positions=None, cross_pos=None, tp=None):
    """Pattern repeat ``rep`` of a decode pass: one
    :func:`_apply_block_decode` per pattern position, in order (the
    segment a decode graph of the fused cycle replays), each block
    cross-attending repeat ``rep`` of ``cache["cross"]`` through
    ``cross_pos`` (its (kv_positions, pos), :func:`decode_step`) when the
    cache has one. Returns x."""
    cross = None
    if "cross" in cache:
        cross = (cache["cross"]["k"][rep], cache["cross"]["v"][rep],
                 *cross_pos)
    for j, blk in enumerate(cfg.pattern):
        p = params_at(params["blocks"][j], rep)
        if tp is not None and tp.fsdp:
            p = _unfsdp(p, tp.fsdp["blocks"][j], tp)
        x = _apply_block_decode(
            x, p, blk, cfg, params_at(cache["blocks"][j], rep), pos,
            block_tables, long_context=long_context,
            kv_positions=kv_positions, cross=cross, tp=tp)
    return x


def fused_repeat(params, cache, x_p, x_d, positions, page_map, pos,
                 rep: int, cfg: ModelConfig, *, decode_share: float,
                 block_tables, lengths=None, stats=None):
    """Pattern repeat ``rep`` of a fused cycle: one
    :func:`_apply_block_fused` per pattern position, prefill group ``rep``
    (its prompts of ``lengths`` tokens) and the decode pass's repeat
    ``rep`` sharing each attention launch. Returns (x_p, x_d)."""
    for j, blk in enumerate(cfg.pattern):
        x_p, x_d = _apply_block_fused(
            x_p, x_d, params_at(params["blocks"][j], rep), blk, cfg,
            positions, pos, params_at(cache["blocks"][j], rep),
            block_tables, page_map, decode_share, lengths, stats)
    return x_p, x_d


def fused_group_decode(params, cache, x_p, positions, page_map, tokens, pos,
                       cfg: ModelConfig, *, rep: int, decode_share: float,
                       block_tables, lengths=None, stats=None):
    """One fused engine cycle: pattern-repeat group ``rep`` of an in-flight
    prefill AND a full continuous-batching decode iteration.

    The decode pass walks every repeat (:func:`decode_repeat`); at repeat
    ``rep`` each layer fuses with the matching prefill layer
    (:func:`fused_repeat`), scattering the group's prompt KV into pooled
    pages as it goes. Layer math is op-for-op the serial path's, so token
    streams are identical. ``lengths`` and ``stats`` are the prefill
    side's, as in :func:`prefill_group`. Returns (x_p, decode_logits (B,
    V)); ``cache`` is updated in place.
    """
    assert supports_paged_cache(cfg), cfg.pattern
    x_d = embed_tokens(params, tokens, cfg)
    for r in range(cfg.n_pattern_repeats):
        if r == rep:
            x_p, x_d = fused_repeat(params, cache, x_p, x_d, positions,
                                    page_map, pos, r, cfg,
                                    decode_share=decode_share,
                                    block_tables=block_tables,
                                    lengths=lengths, stats=stats)
        else:
            x_d = decode_repeat(params, cache, x_d, pos, r, cfg,
                                block_tables)
    return x_p, decode_logits(params, x_d, cfg)


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype`` first, as in JAX, as a Python
    float: a tensor times it rounds as the tensor times the rounded 0-dim
    tensor does (both in opmath, the scale exact there), with no
    host-to-device copy (illegal while a CUDA graph captures)."""
    return float(torch.tensor(d_model ** 0.5, dtype=dtype))


def embed_tokens(params, tokens, cfg: ModelConfig, frontend=None, tp=None):
    """The tokens' embeddings (B, S, D); with the stub ``frontend`` (B, Sf,
    De) of a decoder-only VLM, its projection through ``frontend_proj``
    prepended (B, Sf + S, D). Sharded: the embedding's vocab rows over
    the model axis (``shard_vocab``: each rank looks up the tokens in its
    block, the rows summed) or its columns (all-gathered)."""
    if tp is None or tp.model is None:
        x = params["embed"][tokens.long()]
    elif tp.policy.shard_vocab:
        vl = params["embed"].shape[0]
        ids = tokens.long() - tp.r * vl
        inside = ((ids >= 0) & (ids < vl))[..., None]
        x = tp.reduce(torch.where(inside, params["embed"][ids.clamp(0, vl - 1)],
                                  0))
    else:
        x = tp.gather(params["embed"][tokens.long()])
    if cfg.tie_embeddings:
        x = x * _embed_scale(cfg.d_model, x.dtype)
    if frontend is not None:
        fe = frontend.to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([fe, x], dim=1)
    return x


def lm_logits(params, x, cfg: ModelConfig, tp=None):
    """fp32 logits (B, S, V), the padded vocab tail at -1e30. Sharded:
    this rank's vocab block under ``shard_vocab`` (column parallel), else
    the whole vocab from a row-parallel product."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    vocab = tp is not None and tp.policy.shard_vocab
    logits = tp_matmul(x, w, tp, "out" if vocab else "in").float()
    if cfg.vocab_padded != cfg.vocab_size:
        # mask the padded vocab tail out of the softmax
        first = tp.r * logits.shape[-1] if vocab else 0
        idx = first + torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(idx < cfg.vocab_size, logits, -1e30)
    return logits


def decode_logits(params, x, cfg: ModelConfig, tp=None):
    """Final norm, then the logits of a decode pass's activations (B, 1,
    D): (B, V)."""
    x = L.rms_norm(x, params["final_norm"], cfg.rmsnorm_eps)
    return lm_logits(params, x, cfg, tp)[:, 0]


def last_token_logits(params, x, lengths, cfg: ModelConfig, tp=None):
    """Final norm, then logits of each row's last valid token: (B, V)."""
    x = L.rms_norm(x, params["final_norm"], cfg.rmsnorm_eps)
    idx = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
    last = x[torch.arange(x.shape[0], device=x.device), idx]
    return lm_logits(params, last[:, None], cfg, tp)[:, 0]


# ---------------------------------------------------------------------------
# Encoder (encoder-decoder models)
# ---------------------------------------------------------------------------

def encode(params, frontend, cfg: ModelConfig, tp=None):
    """The bidirectional encoder over stub frontend embeddings (B, Se,
    De): projected through ``frontend_proj``, then per layer RoPE'd
    self-attention over positions 0..Se-1 with no mask (kernel 1 with
    ``causal=False``, G = K/H of the config) and the gated MLP, then
    ``encoder_norm``. Returns (B, Se, D)."""
    enc = params["encoder"]
    x = frontend.to(enc["wq"].dtype) @ params["frontend_proj"]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for p in params_by_repeat(enc):
        if tp is not None and tp.fsdp:
            p = _unfsdp(p, tp.fsdp["encoder"], tp)
        h = L.rms_norm(x, p["ln1"], cfg.rmsnorm_eps)
        q, k, v = _project_qkv(h, p, cfg, positions, tp)
        k, v = _kv_for_heads(k, v, cfg, tp)
        o = attn_ops.attention_prefill(q, k, v, causal=False)
        x = x + _attn_out(o, p["wo"], tp)
        x = x + _ff(x, p, BlockSpec(mixer=ATTN, ff=MLP), cfg, tp=tp)
    return L.rms_norm(x, params["encoder_norm"], cfg.rmsnorm_eps)


def _cross_kv_from_encoder(p_blk, enc_out, cfg: ModelConfig, tp=None):
    """The encoder's output projected by one decoder block's ``cwk`` /
    ``cwv``: (K, V) of shape (B, Se, K, D), no RoPE (sharded: this rank's
    K/V heads when they split)."""
    b, se, _ = enc_out.shape
    split = "out" if _heads(tp)[1] else "in"
    k = tp_matmul(enc_out, p_blk["cwk"], tp, split)
    v = tp_matmul(enc_out, p_blk["cwv"], tp, split)
    return (k.reshape(b, se, -1, cfg.head_dim),
            v.reshape(b, se, -1, cfg.head_dim))


def _embed_prompt(params, tokens, cfg: ModelConfig, frontend, tp=None):
    """(x, enc_out) of a prompt batch: an encoder-decoder model encodes
    ``frontend`` and embeds the tokens alone; a decoder-only one prepends
    the projected ``frontend`` (when given) to the tokens' embeddings."""
    if cfg.n_encoder_layers:
        if frontend is None:
            raise ValueError(f"{cfg.name}: the encoder needs its frontend "
                             "frames")
        return (embed_tokens(params, tokens, cfg, tp=tp),
                encode(params, frontend, cfg, tp))
    return embed_tokens(params, tokens, cfg, frontend, tp), None


# ---------------------------------------------------------------------------
# Top level: prefill / decode
# ---------------------------------------------------------------------------

def scatter_group_pages(cache, entries, page_map, rep: int) -> None:
    """Scatter one layer group's prefill K/V (:func:`prefill_group`) into
    the pooled pages of repeat ``rep``, in place."""
    for leaf, entry in zip(cache["blocks"], entries):
        for key in ("k", "v"):
            scatter_prefill_pages(leaf[key], entry[key], page_map, rep)


def scatter_suffix_group_pages(cache, entries, page_map, offsets,
                               rep: int) -> None:
    """Scatter one layer group's suffix K/V (:func:`prefill_group_shared`)
    into the pooled pages of repeat ``rep`` at each row's in-page offset,
    in place."""
    for leaf, entry in zip(cache["blocks"], entries):
        for key in ("k", "v"):
            scatter_suffix_pages(leaf[key], entry[key], page_map, offsets,
                                 rep)


def copy_pages(cache, src, dst) -> None:
    """Copy-on-write: duplicate pages ``src`` into ``dst`` across every
    repeat of every layer's pool, in place, before the first divergent
    write lands in ``dst`` (docs/KV_SHARING.md)."""
    for leaf in cache["blocks"]:
        for key in ("k", "v"):
            leaf[key].index_copy_(1, dst, leaf[key].index_select(1, src))


def _write_entry(tpl, entry, blk: BlockSpec, cfg: ModelConfig,
                 lengths, long_context: bool = False, tp=None) -> None:
    """Write one layer's prefill entry into its dense cache leaves ``tpl``
    (the prompt batch's rows), in place (``long_context``: a full-attention
    entry longer than its leaf is gathered into the ring). Under the
    sequence-parallel layout the leaves are this rank's block of the
    sequence and take that block of the layout."""
    seq = _seq_par(tp) and blk.mixer in (ATTN, SWA)
    new = _prefill_cache_entry(entry, blk, cfg, lengths, tpl, long_context,
                               tp.m if seq else 1)
    for key, t in tpl.items():
        t.copy_(SH.split_to(new[key], 1, tp.model, tp.mesh) if seq
                else new[key])


def write_dense_entries(cache, entries, cfg: ModelConfig, lengths,
                        rep: int, long_context: bool = False,
                        tp=None) -> None:
    """Write one layer group's prefill entries (:func:`prefill_group`)
    into repeat ``rep`` of a dense slot cache of :func:`init_cache` (built
    with the same ``long_context``) whose batch rows are the prompt
    batch's, in place."""
    for blk, entry, leaf in zip(cfg.pattern, entries, cache["blocks"]):
        _write_entry({key: t[rep] for key, t in leaf.items()}, entry, blk,
                     cfg, lengths, long_context, tp)


def prefill(params, tokens, lengths, cache, page_map, cfg: ModelConfig, *,
            stats=None, frontend=None, long_context: bool = False,
            policy: Optional[ShardingPolicy] = None):
    """Process a prompt batch and write its cache entries.

    tokens: (B, S) with ``lengths`` (B,) valid tokens each. With
    ``page_map`` (B, ceil(S/ps)), naming each prompt block's physical page
    (the trash page past a request's length), the KV is scattered into the
    page pool; with ``page_map=None`` ``cache`` is a dense slot cache of
    :func:`init_cache` with B rows, which takes each row's KV (a
    sliding-window block's gathered into its ring), or recurrent state at
    its own length. The ``pattern_tail`` blocks run after the repeats and
    fill ``cache["tail"]``. A MoE block routes each row's ``lengths``
    tokens, its metrics added to ``stats``. ``frontend`` (B, Sf, De): an
    encoder-decoder model encodes it, every decoder block cross-attends
    the encoder's output, and ``cache["cross"]`` takes each repeat's
    first block's cross K/V, as the JAX package's; a decoder-only VLM
    prepends it to the tokens, and ``lengths`` count its Sf rows.
    ``long_context`` (dense cache only, built by :func:`init_cache` with
    the same flag): the full-attention blocks attend over the window
    ``min(cfg.long_context_window, S)`` and their K/V is gathered into
    the ring of that window, as the JAX package's ``window_override``.
    ``policy`` (dense cache only): sharded over its mesh, every argument
    and result this rank's (the module docstring).
    Returns (last_logits (B, V), cache), the cache updated in place."""
    if long_context and page_map is not None:
        raise ValueError(f"{cfg.name}: the long-context prefill writes the "
                         "dense slot cache's ring, not pages")
    tp = _tp(policy, cfg)
    if tp is not None and page_map is not None:
        raise ValueError(f"{cfg.name}: a sharded prefill writes the dense "
                         "slot cache, not pages")
    params = _top_params(params, tp)
    x, enc_out = _embed_prompt(params, tokens, cfg, frontend, tp)
    if enc_out is not None:
        se = cache["cross"]["k"].shape[2]
        if enc_out.shape[1] != se:
            raise ValueError(f"{cfg.name}: {enc_out.shape[1]} frontend "
                             f"frames, the cross cache holds {se}")
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    window = (min(cfg.long_context_window, x.shape[1]) if long_context
              else None)
    for r in range(cfg.n_pattern_repeats):
        x, entries = prefill_group(params, x, positions, r, cfg, lengths,
                                   stats, enc_out, window, tp)
        if page_map is None:
            write_dense_entries(cache, entries, cfg, lengths, r,
                                long_context, tp)
        else:
            scatter_group_pages(cache, entries, page_map, r)
        if enc_out is not None:
            for key, t in zip(("k", "v"), entries[0]["cross"]):
                cache["cross"][key][r].copy_(t)
    for j, blk in enumerate(cfg.pattern_tail):
        p = _tail_params(params, j, tp)
        cross = (None if enc_out is None
                 else _cross_kv_from_encoder(p, enc_out, cfg, tp))
        x, entry = _apply_block_full(x, p, blk, cfg, positions, lengths,
                                     stats, cross, window, tp)
        _write_entry(cache["tail"][j], entry, blk, cfg, lengths,
                     long_context, tp)
    return last_token_logits(params, x, lengths, cfg, tp), cache


def _top_params(params, tp: Optional[TP]):
    """``params`` with its top-level FSDP leaves all-gathered (the
    embedding, the head, the norms, the frontend projection)."""
    if tp is None or not tp.fsdp:
        return params
    return _unfsdp(params, tp.fsdp["top"], tp)


def _tail_params(params, j: int, tp: Optional[TP]):
    p = params["tail_blocks"][j]
    if tp is None or not tp.fsdp:
        return p
    return _unfsdp(p, tp.fsdp["tail_blocks"][j], tp)


def _apply_block_chunk(x, p, blk: BlockSpec, cfg: ModelConfig,
                       ctx_start: int, cache_entry, stats=None):
    """Chunked-prefill block: a chunk of ``Sq`` prompt tokens at positions
    ``ctx_start ..`` with ``ctx_start`` tokens already in the dense cache
    (the paper's §2.3 workflow: attention re-reads the cached context).
    An attention block writes the chunk's K/V into rows ``[ctx_start,
    ctx_start + Sq)`` of its entry, in place, then kernel 1 runs with
    ``q_offset = ctx_start`` over the entry's first ``ctx_start + Sq``
    rows (a sliding-window block with its window); an SSD or RG-LRU block
    continues from its entry's state and writes the new one in place; a
    MoE block routes every row of the chunk, as the JAX ``_ff`` does.
    Returns x."""
    sq = x.shape[1]
    positions = ctx_start + torch.arange(sq, device=x.device)[None, :]
    h = L.rms_norm(x, p["ln1"], cfg.rmsnorm_eps)
    if blk.mixer == SSD:
        y, st = ssd_block(h, p, cfg, state=SSDState(cache_entry["conv"],
                                                    cache_entry["ssm"]))
        new = {"conv": st.conv, "ssm": st.ssm}
    elif blk.mixer == RGLRU:
        y, st = rglru_block(h, p, cfg, state=RGLRUState(
            cache_entry["conv"], cache_entry["hidden"]))
        new = {"conv": st.conv, "hidden": st.hidden}
    else:
        end = ctx_start + sq
        kc, vc = cache_entry["k"], cache_entry["v"]
        if end > kc.shape[1]:
            raise ValueError(
                f"{cfg.name}: a chunk ending at {end} past the {blk.mixer} "
                f"cache's {kc.shape[1]} rows (the chunked prefill needs a "
                "cache that holds the whole prompt, not a ring)")
        q, k_new, v_new = _project_qkv(h, p, cfg, positions)
        kc[:, ctx_start:end] = k_new.to(kc.dtype)
        vc[:, ctx_start:end] = v_new.to(vc.dtype)
        window = cfg.sliding_window if blk.mixer == SWA else 0
        o = attn_ops.attention_prefill(q, kc[:, :end], vc[:, :end],
                                       causal=True, window=window,
                                       q_offset=ctx_start)
        y = _merge_heads(o) @ p["wo"]
        new = {}
    for key, t in new.items():
        cache_entry[key].copy_(t)
    x = x + y
    return x + _ff(x, p, blk, cfg, stats=stats)


def prefill_chunk(params, tokens, ctx_start: int, cache, cfg: ModelConfig,
                  *, stats=None):
    """One chunked-prefill iteration (the SARATHI-style baselines'
    substrate, as the JAX package's ``prefill_chunk``): ``tokens`` (B, Sq)
    through every layer with ``ctx_start`` tokens of each row already in
    ``cache``, a dense slot cache of :func:`init_cache` sized for the
    whole prompt (no ring shorter than it: :func:`_apply_block_chunk`
    raises ``ValueError`` there, where the JAX ``dynamic_update_slice``
    clamps), updated in place. A MoE block's metrics go to ``stats``.
    Returns (last_logits (B, V), cache): the logits of the chunk's last
    position. Encoder-decoder configs are refused, as the JAX package
    refuses them (chunking a translation model's decoder prompt is not a
    meaningful baseline)."""
    if cfg.cross_attention:
        raise ValueError(f"{cfg.name}: the chunked prefill serves "
                         "decoder-only models")
    if ctx_start < 0:
        raise ValueError(f"prefill_chunk: ctx_start {ctx_start} < 0")
    x = embed_tokens(params, tokens, cfg)
    for r in range(cfg.n_pattern_repeats):
        for j, blk in enumerate(cfg.pattern):
            x = _apply_block_chunk(x, params_at(params["blocks"][j], r), blk,
                                   cfg, ctx_start,
                                   params_at(cache["blocks"][j], r), stats)
    for j, blk in enumerate(cfg.pattern_tail):
        x = _apply_block_chunk(x, params["tail_blocks"][j], blk, cfg,
                               ctx_start, cache["tail"][j], stats)
    return decode_logits(params, x[:, -1:], cfg), cache


def _position_maps(cfg: ModelConfig, cache, pos, long_context: bool,
                   shards: int = 1):
    """The (B, S) ``_kv_positions`` map of every distinct (cache length,
    ring) pair among the dense cache's attention entries, computed once
    for all the layers that share it (``shards``: each entry is one of
    that many blocks of its sequence; the maps cover the whole)."""
    maps = {}
    entries = list(zip(cfg.pattern, cache["blocks"]))
    entries += list(zip(cfg.pattern_tail, cache.get("tail", ())))
    for blk, leaf in entries:
        if blk.mixer in (ATTN, SWA):
            key = (leaf["k"].shape[-3] * shards,
                   _is_ring(blk, long_context))
            if key not in maps:
                maps[key] = _kv_positions(pos, *key)
    return maps


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, *,
                block_tables=None, long_context: bool = False,
                policy: Optional[ShardingPolicy] = None):
    """One decode iteration.

    tokens: (B, 1) int; pos: (B,) int32 absolute position of the new token.
    ``block_tables`` (B, n_b) int32, shared across layers, selects the
    block-paged cache of :func:`init_paged_cache`; without it ``cache`` is
    the dense slot cache of :func:`init_cache` (built with the same
    ``long_context``), whose attention entries are masked by one
    ``_kv_positions`` map per distinct (cache length, ring) pair, and whose
    ``pattern_tail`` blocks run after the repeats. With ``cache["cross"]``
    every block of repeat r cross-attends its row r (the tail blocks the
    last row), all of its Se rows: the map 0..Se-1 and pos Se-1 are made
    on the device here, so a CUDA graph of this step captures them with
    no copy from the host. ``policy`` (dense cache only): sharded over its
    mesh, every argument and result this rank's (the module docstring).
    Returns (logits (B, V), cache), the cache updated in place."""
    tp = _tp(policy, cfg)
    if tp is not None and block_tables is not None:
        raise ValueError(f"{cfg.name}: a sharded decode step reads the "
                         "dense slot cache, not pages")
    params = _top_params(params, tp)
    x = embed_tokens(params, tokens, cfg, tp=tp)
    kvpos = (None if block_tables is not None
             else _position_maps(cfg, cache, pos, long_context,
                                 tp.m if _seq_par(tp) else 1))
    cross_pos = None
    if "cross" in cache:
        se = cache["cross"]["k"].shape[2]
        cross_pos = (_kv_positions(pos, se, False),
                     torch.full_like(pos, se - 1))
    for r in range(cfg.n_pattern_repeats):
        x = decode_repeat(params, cache, x, pos, r, cfg, block_tables,
                          long_context=long_context, kv_positions=kvpos,
                          cross_pos=cross_pos, tp=tp)
    for j, blk in enumerate(cfg.pattern_tail):
        cross = None
        if cross_pos is not None:
            cross = (cache["cross"]["k"][-1], cache["cross"]["v"][-1],
                     *cross_pos)
        x = _apply_block_decode(
            x, _tail_params(params, j, tp), blk, cfg, cache["tail"][j], pos,
            long_context=long_context, kv_positions=kvpos, cross=cross,
            tp=tp)
    return decode_logits(params, x, cfg, tp), cache


# ---------------------------------------------------------------------------
# Teacher forcing
# ---------------------------------------------------------------------------

def param_count(params) -> int:
    """Elements over every leaf of a param tree."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(param_count(v) for v in params)
    return params.numel()


def forward(params, tokens, cfg: ModelConfig, *, frontend=None,
            remat: bool = False, policy: Optional[ShardingPolicy] = None):
    """Teacher-forcing forward over ``tokens`` (B, S), every row a full
    sequence, with ``frontend`` encoded (encoder-decoder) or prepended
    (decoder-only VLM: the logits then cover its rows too), as in
    :func:`prefill`. Returns (logits (B, S, V), aux): ``aux`` the MoE
    load-balance losses summed over the layers in order (zero without
    MoE blocks), as the JAX ``forward``. With ``remat`` each pattern
    block runs under ``torch.utils.checkpoint`` (non-reentrant), the JAX
    package's per-block ``jax.checkpoint``: only the block's input is kept
    for the backward, which runs the block again (the forward draws no
    random numbers, so no RNG state is stashed). The tail blocks are not
    checkpointed, as in the JAX ``forward``. ``policy``: sharded over its
    mesh, every argument and result this rank's (the module docstring); a
    block's FSDP leaves are gathered inside its checkpoint, so the
    backward gathers them again."""
    tp = _tp(policy, cfg)
    params = _top_params(params, tp)
    x, enc_out = _embed_prompt(params, tokens, cfg, frontend, tp)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def one_block(x, p, blk, plan=None):
        if plan:
            p = _unfsdp(p, plan, tp)
        cross = (None if enc_out is None
                 else _cross_kv_from_encoder(p, enc_out, cfg, tp))
        # the block's own sums, returned (as the JAX ``one_block`` returns
        # its aux), so a recomputed block counts nothing twice
        stats = MoEStats(x.device)
        x, _ = _apply_block_full(x, p, blk, cfg, positions, stats=stats,
                                 cross_kv=cross, tp=tp)
        return x, stats.sums[3]

    run = one_block
    if remat:
        run = functools.partial(torch.utils.checkpoint.checkpoint, one_block,
                                use_reentrant=False,
                                preserve_rng_state=False)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    repeats = [params_by_repeat(p_j) for p_j in params["blocks"]]
    plans = tp.fsdp if tp is not None and tp.fsdp else None
    for r in range(cfg.n_pattern_repeats):
        for j, blk in enumerate(cfg.pattern):
            x, a = run(x, repeats[j][r], blk,
                       plans["blocks"][j] if plans else None)
            aux = aux + a
    for j, blk in enumerate(cfg.pattern_tail):
        x, a = one_block(x, params["tail_blocks"][j], blk,
                         plans["tail_blocks"][j] if plans else None)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.rmsnorm_eps)
    return lm_logits(params, x, cfg, tp), aux
