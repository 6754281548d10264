"""The transformer of the paged Bullet path: init, page pool, prefill,
paged decode and the fused prefill-group + decode cycle.

This slice covers homogeneous full-attention stacks (``supports_paged_cache``):
``n_pattern_repeats`` repeats of ``cfg.pattern``, with per-pattern
parameters stacked along a leading repeat axis R, as in the JAX package.
Python loops over the repeats take the place of ``lax.scan``. Page pools
are updated in place where the JAX package donated its buffers.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ATTN, MLP, BlockSpec, ModelConfig
from repro_torch.models import attention as attn_ops
from repro_torch.models import layers as L

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter definitions: (shape, init) per name, as the JAX package's PDefs
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig) -> Dict[str, Tuple[tuple, str]]:
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ((d, h * dh), "dense"),
        "wk": ((d, k * dh), "dense"),
        "wv": ((d, k * dh), "dense"),
        "wo": ((h * dh, d), "dense"),
    }
    if cfg.qkv_bias:
        defs["bq"] = ((h * dh,), "zeros")
        defs["bk"] = ((k * dh,), "zeros")
        defs["bv"] = ((k * dh,), "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ((dh,), "zeros")
        defs["k_norm"] = ((dh,), "zeros")
    return defs


def _block_defs(cfg: ModelConfig, blk: BlockSpec):
    if blk.mixer != ATTN or blk.ff not in (MLP, "none"):
        raise NotImplementedError(
            f"block {blk}: the port serves dense full-attention stacks; "
            "other mixers and MoE come with a later slice (ROADMAP)")
    d = cfg.d_model
    defs = {"ln1": ((d,), "zeros")}
    defs.update(_attn_defs(cfg))
    if blk.ff == MLP:
        defs["ln2"] = ((d,), "zeros")
        defs["wi"] = ((d, 2 * cfg.d_ff), "dense")
        defs["wo_mlp"] = ((cfg.d_ff, d), "dense")
    return defs


def _top_defs(cfg: ModelConfig):
    d, v = cfg.d_model, cfg.vocab_padded
    defs = {"embed": ((v, d), "embed"), "final_norm": ((d,), "zeros")}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((d, v), "dense")
    return defs


def _init_one(gen, shape, init, dtype, *, lead=(), fan_in=None):
    full = tuple(lead) + tuple(shape)
    if init == "dense":
        return L.dense_init(gen, full, dtype, fan_in=fan_in or shape[0])
    if init == "embed":
        return L.embed_init(gen, full, dtype)
    if init == "zeros":
        return torch.zeros(full, dtype=dtype, device=gen.device)
    raise ValueError(init)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Seeded random params with the JAX package's tree, shapes and
    distributions (no bit parity with jax.random): ``{"embed",
    "final_norm", ["lm_head"], "blocks": (per pattern position {name:
    (R, ...)})}``, vocab padded to a multiple of 256."""
    if not supports_paged_cache(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the port serves pure full-attention stacks")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: Params = {}
    for name, (shape, init) in sorted(_top_defs(cfg).items()):
        params[name] = _init_one(gen, shape, init, dtype)
    r = cfg.n_pattern_repeats
    params["blocks"] = tuple(
        {name: _init_one(gen, shape, init, dtype, lead=(r,))
         for name, (shape, init) in sorted(_block_defs(cfg, blk).items())}
        for blk in cfg.pattern)
    return params


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


def params_at(params_j: Dict[str, torch.Tensor], r: int):
    """One repeat's slice of a stacked per-pattern param dict (views)."""
    return {name: leaf[r] for name, leaf in params_j.items()}


# ---------------------------------------------------------------------------
# Forward building blocks
# ---------------------------------------------------------------------------

def _project_qkv(x, p, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    kk = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    kk = kk.reshape(b, s, k, dh)
    v = v.reshape(b, s, k, dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.rmsnorm_eps)
        kk = L.rms_norm(kk, p["k_norm"], cfg.rmsnorm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    kk = L.apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, v


def _ff(x, p, blk: BlockSpec, cfg: ModelConfig):
    """Feed-forward sub-block (the MLP branch)."""
    if blk.ff == "none":
        return torch.zeros_like(x)
    h = L.rms_norm(x, p["ln2"], cfg.rmsnorm_eps)
    return L.gated_mlp(h, p["wi"], p["wo_mlp"])


def _merge_heads(o):
    return o.reshape(*o.shape[:2], -1)


def _apply_block_full(x, p, blk: BlockSpec, cfg: ModelConfig, positions):
    """Prefill block application over a full sequence. Returns
    (x, {"k", "v"}) with this layer's full-sequence KV."""
    h = L.rms_norm(x, p["ln1"], cfg.rmsnorm_eps)
    q, k, v = _project_qkv(h, p, cfg, positions)
    o = attn_ops.attention_prefill(q, k, v, causal=True, window=0)
    x = x + _merge_heads(o) @ p["wo"]
    x = x + _ff(x, p, blk, cfg)
    return x, {"k": k, "v": v}


def _apply_block_decode(x, p, blk: BlockSpec, cfg: ModelConfig, cache_entry,
                        pos, block_tables):
    """Single-token block application over one layer's page pool
    ``cache_entry`` {(P+1, ps, K, D)}: the new token's K/V is written into
    its slot's current page (in place) and attention reads only the pages
    the table names. x: (B,1,D)."""
    h = L.rms_norm(x, p["ln1"], cfg.rmsnorm_eps)
    q, k_new, v_new = _project_qkv(h, p, cfg, pos[:, None])
    kp, vp = attn_ops.write_paged_kv(cache_entry["k"], cache_entry["v"],
                                     k_new, v_new, block_tables, pos)
    o = attn_ops.attention_decode_paged(q, kp, vp, block_tables, pos)
    x = x + _merge_heads(o) @ p["wo"]
    return x + _ff(x, p, blk, cfg)


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


def _apply_block_fused(x_p, x_d, p, blk: BlockSpec, cfg: ModelConfig,
                       positions_p, pos_d, cache_entry, block_tables,
                       page_map, decode_share: float):
    """Spatially-fused block application: one prefill layer of the current
    layer group AND one decode layer of the same (repeat, pattern)
    position share a single attention launch (paper §3.5 co-execution).

    The decode token's K/V is written to its slot's page FIRST, then the
    prefill group's K/V is scattered into its requests' pages (disjoint
    page sets: mid-prefill slots sit on the trash page in
    ``block_tables``). Returns (x_p, x_d)."""
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
    x_p = x_p + _ff(x_p, p, blk, cfg)
    x_d = x_d + _merge_heads(od) @ p["wo"]
    x_d = x_d + _ff(x_d, p, blk, cfg)
    return x_p, x_d


def prefill_group(params, x, positions, rep: int, cfg: ModelConfig):
    """Pattern-repeat group ``rep`` over a prompt batch: returns (x, [(k,
    v) per pattern position]) — the raw full-sequence KV the caller
    scatters into pooled pages."""
    entries = []
    for j, blk in enumerate(cfg.pattern):
        x, entry = _apply_block_full(x, params_at(params["blocks"][j], rep),
                                     blk, cfg, positions)
        entries.append((entry["k"], entry["v"]))
    return x, entries


def fused_group_decode(params, cache, x_p, positions, page_map, tokens, pos,
                       cfg: ModelConfig, *, rep: int, decode_share: float,
                       block_tables):
    """One fused engine cycle: pattern-repeat group ``rep`` of an in-flight
    prefill AND a full continuous-batching decode iteration.

    The decode pass walks every layer; at repeat ``rep`` each layer fuses
    with the matching prefill layer via :func:`_apply_block_fused`,
    scattering the group's prompt KV into pooled pages as it goes. Layer
    math is op-for-op the serial path's, so token streams are identical.
    Returns (x_p, decode_logits (B, V)); ``cache`` is updated in place.
    """
    assert supports_paged_cache(cfg), cfg.pattern
    x_d = embed_tokens(params, tokens, cfg)
    for r in range(cfg.n_pattern_repeats):
        for j, blk in enumerate(cfg.pattern):
            p_rj = params_at(params["blocks"][j], r)
            entry_rj = params_at(cache["blocks"][j], r)
            if r == rep:
                x_p, x_d = _apply_block_fused(
                    x_p, x_d, p_rj, blk, cfg, positions, pos, entry_rj,
                    block_tables, page_map, decode_share)
            else:
                x_d = _apply_block_decode(x_d, p_rj, blk, cfg, entry_rj, pos,
                                          block_tables)
    x_d = L.rms_norm(x_d, params["final_norm"], cfg.rmsnorm_eps)
    return x_p, lm_logits(params, x_d, cfg)[:, 0]


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens.long()]
    if cfg.tie_embeddings:
        # the scale is rounded to the activation dtype first, as in JAX
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def lm_logits(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = logits.float()
    if cfg.vocab_padded != cfg.vocab_size:
        # mask the padded vocab tail out of the softmax
        idx = torch.arange(cfg.vocab_padded, device=logits.device)
        logits = torch.where(idx < cfg.vocab_size, logits, -1e30)
    return logits


def last_token_logits(params, x, lengths, cfg: ModelConfig):
    """Final norm, then logits of each row's last valid token: (B, V)."""
    x = L.rms_norm(x, params["final_norm"], cfg.rmsnorm_eps)
    idx = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
    last = x[torch.arange(x.shape[0], device=x.device), idx]
    return lm_logits(params, last[:, None], cfg)[:, 0]


# ---------------------------------------------------------------------------
# Top level: prefill / decode
# ---------------------------------------------------------------------------

def prefill(params, tokens, lengths, cache, page_map, cfg: ModelConfig):
    """Process a prompt batch and scatter its KV into the page pool.

    tokens: (B, S) with ``lengths`` (B,) valid tokens each; ``page_map``
    (B, ceil(S/ps)) names each prompt block's physical page (the trash page
    past a request's length). Returns (last_logits (B, V), cache), the
    cache updated in place."""
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for r in range(cfg.n_pattern_repeats):
        x, entries = prefill_group(params, x, positions, r, cfg)
        for j, (k, v) in enumerate(entries):
            scatter_prefill_pages(cache["blocks"][j]["k"], k, page_map, r)
            scatter_prefill_pages(cache["blocks"][j]["v"], v, page_map, r)
    return last_token_logits(params, x, lengths, cfg), cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, *,
                block_tables):
    """One decode iteration over the block-paged cache.

    tokens: (B, 1) int; pos: (B,) int32 absolute position of the new token;
    block_tables: (B, n_b) int32, shared across layers. Returns
    (logits (B, V), cache), the cache updated in place."""
    x = embed_tokens(params, tokens, cfg)
    for r in range(cfg.n_pattern_repeats):
        for j, blk in enumerate(cfg.pattern):
            x = _apply_block_decode(
                x, params_at(params["blocks"][j], r), blk, cfg,
                params_at(cache["blocks"][j], r), pos, block_tables)
    x = L.rms_norm(x, params["final_norm"], cfg.rmsnorm_eps)
    return lm_logits(params, x, cfg)[:, 0], cache
