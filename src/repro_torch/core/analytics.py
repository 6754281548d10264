"""Analytic FLOP / byte accounting per phase, per layer, per architecture.

Feeds the Bullet performance estimator (Eq. 2's c_i and b_i), the
discrete-event simulator, and the §Roofline MODEL_FLOPS terms. All numbers
are *algorithmic* (dense-equivalent) — the HLO-derived numbers in
launch/roofline.py measure what the compiler actually emitted; the ratio of
the two is the useful-compute metric.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.configs.base import ATTN, MLP, MOE, RGLRU, SSD, SWA, BlockSpec, ModelConfig


@dataclass(frozen=True)
class PhaseCost:
    flops: float            # floating-point ops
    hbm_bytes: float        # weight + activation + KV traffic
    # split used by the co-location / lockstep models:
    gemm_flops: float       # MXU-eligible portion
    attn_flops: float
    weight_bytes: float = 0.0   # parameter traffic (read once per batch)
    kv_bytes: float = 0.0       # KV-cache traffic (reload + read + write)

    def __add__(self, o: "PhaseCost") -> "PhaseCost":
        return PhaseCost(self.flops + o.flops, self.hbm_bytes + o.hbm_bytes,
                         self.gemm_flops + o.gemm_flops,
                         self.attn_flops + o.attn_flops,
                         self.weight_bytes + o.weight_bytes,
                         self.kv_bytes + o.kv_bytes)


def _attn_kv_bytes(cfg: ModelConfig, ctx: int, n_tokens: int,
                   dtype_bytes: int = 2) -> float:
    return 2 * ctx * cfg.n_kv_heads * cfg.head_dim * dtype_bytes * 1.0


def block_weight_bytes(cfg: ModelConfig, blk: BlockSpec,
                       dtype_bytes: int = 2, active_only: bool = True) -> float:
    d = cfg.d_model
    total = 0
    if blk.mixer in (ATTN, SWA):
        total += d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
        total += cfg.n_heads * cfg.head_dim * d
    elif blk.mixer == RGLRU:
        w = cfg.lru_width
        total += 2 * d * w + 2 * w * w + w * d
    elif blk.mixer == SSD:
        di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
        total += d * (2 * di + 2 * n + h) + di * d
    if blk.ff == MLP:
        total += 3 * d * cfg.d_ff
    elif blk.ff == MOE:
        e = cfg.n_experts_per_token if active_only else cfg.n_experts
        total += (e + cfg.n_shared_experts) * 3 * d * cfg.d_ff
        total += d * cfg.n_experts  # router
    return total * dtype_bytes


def block_prefill_cost(cfg: ModelConfig, blk: BlockSpec, n_tokens: int,
                       ctx_start: int = 0, dtype_bytes: int = 2) -> PhaseCost:
    """Cost of running ``n_tokens`` prompt tokens through one block, with
    ``ctx_start`` tokens of earlier context already in cache (chunked
    prefill re-reads that cache — the paper's §2.3 reload term)."""
    d = cfg.d_model
    gemm = 0.0
    attn = 0.0
    kvb = 0.0
    wb = block_weight_bytes(cfg, blk, dtype_bytes)
    bytes_ = wb
    bytes_ += 2 * n_tokens * d * dtype_bytes          # activations in/out
    if blk.mixer in (ATTN, SWA):
        h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        gemm += 2 * n_tokens * d * (h + 2 * k) * dh   # qkv proj
        gemm += 2 * n_tokens * h * dh * d             # out proj
        if blk.mixer == SWA:
            span = min(cfg.sliding_window, ctx_start + n_tokens)
            attn += 2 * 2 * n_tokens * span * h * dh * 0.5
        else:
            # causal: sum_{i} (ctx_start + i) ≈ n(ctx + n/2)
            attn += 2 * 2 * n_tokens * (ctx_start + n_tokens / 2) * h * dh
        kvb += _attn_kv_bytes(cfg, ctx_start, n_tokens) * 1.0  # chunk reload
        kvb += 2 * n_tokens * k * dh * dtype_bytes    # cache write
        bytes_ += kvb
    elif blk.mixer == RGLRU:
        w = cfg.lru_width
        gemm += 2 * n_tokens * (2 * d * w + 2 * w * w + w * d)
        attn += 10 * n_tokens * w                     # scan flops (elementwise)
    elif blk.mixer == SSD:
        di, n, hh, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                        cfg.ssm_head_dim)
        gemm += 2 * n_tokens * d * (2 * di + 2 * n + hh)
        gemm += 2 * n_tokens * di * d
        q = cfg.ssm_chunk
        attn += 2 * n_tokens * q * (2 * n + p)        # chunked SSD matmuls
        attn += 2 * n_tokens * n * p * 2              # state build/apply
    if blk.ff == MLP:
        gemm += 2 * n_tokens * 3 * d * cfg.d_ff
    elif blk.ff == MOE:
        e = cfg.n_experts_per_token + cfg.n_shared_experts
        gemm += 2 * n_tokens * 3 * d * cfg.d_ff * e
        gemm += 2 * n_tokens * d * cfg.n_experts
    return PhaseCost(gemm + attn, bytes_, gemm, attn, wb, kvb)


def _decode_spans(cfg: ModelConfig, blk: BlockSpec, batch: int, ctx: int,
                  contexts: Optional[Sequence[int]],
                  page_size: Optional[int]) -> float:
    """Summed per-slot KV span one decode iteration streams for one
    attention block. ``contexts`` charges each slot its own live context
    (a collapsed ``batch × mean`` hides the truncation and the per-slot
    window clamp); ``page_size`` rounds each span up to whole pages — what
    the block-paged kernel actually fetches. The uniform case stays O(1):
    this sits on the scheduler/simulator hot path."""
    if contexts is None:
        span = min(cfg.sliding_window, ctx) if blk.mixer == SWA else ctx
        if page_size:
            span = -(-span // page_size) * page_size
        return float(batch) * span
    total = 0.0
    for c in contexts:
        span = min(cfg.sliding_window, c) if blk.mixer == SWA else c
        if page_size:
            span = -(-span // page_size) * page_size
        total += span
    return total


def block_decode_cost(cfg: ModelConfig, blk: BlockSpec, batch: int,
                      ctx: int, dtype_bytes: int = 2, *,
                      contexts: Optional[Sequence[int]] = None,
                      page_size: Optional[int] = None) -> PhaseCost:
    """One decode iteration for ``batch`` requests at mean context ``ctx``
    (or exact per-slot ``contexts``; see :func:`_decode_spans`)."""
    if contexts is not None:
        batch = len(contexts)
    d = cfg.d_model
    gemm = attn = 0.0
    kvb = 0.0
    wb = block_weight_bytes(cfg, blk, dtype_bytes)
    bytes_ = wb
    bytes_ += 2 * batch * d * dtype_bytes
    if blk.mixer in (ATTN, SWA):
        h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        gemm += 2 * batch * d * (h + 2 * k) * dh + 2 * batch * h * dh * d
        span_sum = _decode_spans(cfg, blk, batch, ctx, contexts, page_size)
        attn += 2 * 2 * span_sum * h * dh
        kvb += _attn_kv_bytes(cfg, span_sum, 1)             # cache read
        kvb += 2 * batch * k * dh * dtype_bytes             # cache write
        bytes_ += kvb
    elif blk.mixer == RGLRU:
        w = cfg.lru_width
        gemm += 2 * batch * (2 * d * w + 2 * w * w + w * d)
        bytes_ += batch * w * 4 * 2                         # state rw fp32
    elif blk.mixer == SSD:
        di, n, hh, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                        cfg.ssm_head_dim)
        gemm += 2 * batch * d * (2 * di + 2 * n + hh) + 2 * batch * di * d
        attn += 2 * batch * hh * p * n * 2
        bytes_ += batch * hh * p * n * 4 * 2                # state rw fp32
    if blk.ff == MLP:
        gemm += 2 * batch * 3 * d * cfg.d_ff
    elif blk.ff == MOE:
        e = cfg.n_experts_per_token + cfg.n_shared_experts
        gemm += 2 * batch * 3 * d * cfg.d_ff * e
        # decode batches touch up to min(batch·k, E) experts' weights
        touched = min(batch * max(cfg.n_experts_per_token, 1), cfg.n_experts)
        extra_w = (touched - 1) * 3 * d * cfg.d_ff * dtype_bytes
        bytes_ += extra_w
        wb += extra_w
    return PhaseCost(gemm + attn, bytes_, gemm, attn, wb, kvb)


def _model_cost(cfg: ModelConfig, per_block) -> PhaseCost:
    f = b = g = a = w = kv = 0.0
    for blk in cfg.all_blocks:
        c = per_block(blk)
        f += c.flops
        b += c.hbm_bytes
        g += c.gemm_flops
        a += c.attn_flops
        w += c.weight_bytes
        kv += c.kv_bytes
    return PhaseCost(f, b, g, a, w, kv)


def prefill_cost(cfg: ModelConfig, n_tokens: int, ctx_start: int = 0,
                 include_head: bool = True) -> PhaseCost:
    c = _model_cost(cfg, lambda blk: block_prefill_cost(cfg, blk, n_tokens,
                                                        ctx_start))
    head = 2 * 1 * cfg.d_model * cfg.vocab_size if include_head else 0
    emb_bytes = n_tokens * cfg.d_model * 2
    return PhaseCost(c.flops + head, c.hbm_bytes + emb_bytes + head / 2,
                     c.gemm_flops + head, c.attn_flops,
                     c.weight_bytes + head / 2, c.kv_bytes)


def decode_cost(cfg: ModelConfig, batch: int, ctx: int, *,
                contexts: Optional[Sequence[int]] = None,
                page_size: Optional[int] = None) -> PhaseCost:
    """One decode iteration. ``contexts`` switches the KV terms from the
    ``batch × mean`` collapse to exact per-slot live contexts, and
    ``page_size`` quantizes each span to whole pages (the block-paged
    cache's streaming granularity)."""
    if contexts is not None:
        batch = len(contexts)
    c = _model_cost(cfg, lambda blk: block_decode_cost(
        cfg, blk, batch, ctx, contexts=contexts, page_size=page_size))
    head = 2 * batch * cfg.d_model * cfg.vocab_size
    head_bytes = cfg.d_model * cfg.vocab_size * 2
    return PhaseCost(c.flops + head, c.hbm_bytes + head_bytes,
                     c.gemm_flops + head, c.attn_flops,
                     c.weight_bytes + head_bytes, c.kv_bytes)


def kv_transfer_bytes(cfg: ModelConfig, n_tokens: int,
                      dtype_bytes: int = 2) -> float:
    """Bytes a prefill→decode cross-mesh KV handoff moves for ``n_tokens``
    of written cache: K and V for every attention layer of the model (the
    page payload ``kvcache.paged.transfer_pages`` re-shards; page-padding
    is ignored — trash-page rows transfer too in practice but the charge
    models the useful payload, consistent with the KV terms above)."""
    per_layer = 2 * n_tokens * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
    n_attn = sum(1 for blk in cfg.all_blocks if blk.mixer in (ATTN, SWA))
    return float(per_layer * n_attn)


def model_flops_per_token(cfg: ModelConfig) -> float:
    """The 6·N·D convention (N = active params) per trained token; for
    inference forward-only it is 2·N_active per token."""
    return 6.0 * cfg.n_active_params


def train_step_flops(cfg: ModelConfig, global_batch: int, seq: int) -> float:
    return model_flops_per_token(cfg) * global_batch * seq
