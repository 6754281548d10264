"""Attention ops in model layout, ported from the JAX package's XLA path.

The plain attention math (``flash_ref_attention``, ``decode_attention``,
``gather_pages``, ``paged_decode_ref``, ``NEG_INF``) lives once, in
``repro_torch.kernels.ref``, next to the kernels it is the plain version
of; it is re-exported here under the JAX package's names. This module adds
the in-place cache writes (``write_paged_kv``, ``write_cache_slot``), the
shared-prefix suffix attention (``prefix_suffix_attention``, XLA in the
JAX package and plain PyTorch here, on either device) and the model's
entry points, the dispatchers at the end, which reach the kernels through
``repro_torch.kernels.ops``: a CUDA tensor launches the CUDA kernel, a CPU
tensor runs the plain version.

The sequence-parallel pair (ROADMAP §1 item 8d) are the bodies of the JAX
package's two ``shard_map`` functions, run by each rank on its own block
of a cache sharded over the sequence on one mesh axis:
``write_cache_slot_seq_sharded`` (the rank that owns ``slot`` writes) and
``seq_parallel_decode_attention`` (a local (m, l, o) partial over the
rank's rows, merged with ``pmax`` and ``psum`` over the axis: flash
decoding). The partial is plain PyTorch on either device, in the JAX op
order, as it is XLA in the JAX package and no Pallas kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import sharding as SH
from repro_torch.kernels.ref import (NEG_INF, _gqa_logits,  # noqa: F401
                                     decode_attention, flash_ref_attention,
                                     gather_pages, paged_decode_ref)


def write_paged_kv(k_pages, v_pages, k_new, v_new, block_tables, pos):
    """Write one new token's K/V into the page pool, in place (the JAX
    version returns updated pools from donated buffers).

    k_new/v_new: (B, 1, K, D); the token at absolute position ``pos[b]``
    lands in page ``block_tables[b, pos[b] // ps]`` at offset
    ``pos[b] % ps``. The block index is clamped to the table width, so
    slots with stale ``pos`` (inactive) write into whatever page their
    table names there — engines point unused table entries at a trash
    page, making those writes harmless. Returns the (same) pools.
    """
    ps = k_pages.shape[1]
    n_b = block_tables.shape[1]
    pos = pos.long()
    bi = (pos // ps).clamp(0, n_b - 1)
    phys = block_tables.long().gather(1, bi[:, None])[:, 0]
    off = (pos % ps).clamp(0, ps - 1)
    k_pages[phys, off] = k_new[:, 0].to(k_pages.dtype)
    v_pages[phys, off] = v_new[:, 0].to(v_pages.dtype)
    return k_pages, v_pages


def write_cache_slot(cache, new, slot):
    """Write ``new`` (B, 1, K, D) into the dense cache (B, S, K, D) at per-row
    index ``slot`` (B,), in place (the JAX version is a vmapped
    ``dynamic_update_slice``, which clamps the index into range; so does
    this). Returns the (same) cache."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = slot.long().clamp(0, cache.shape[1] - 1)
    cache[rows, idx] = new[:, 0].to(cache.dtype)
    return cache


def write_cache_slot_seq_sharded(cache, new, slot, *, mesh, axis: str):
    """``write_cache_slot`` on a cache sharded over its sequence dim on
    ``axis``: ``cache`` is this rank's block (B, S_loc, K, D) of rows
    ``[i·S_loc, (i+1)·S_loc)``, i the rank's index on ``axis``; a row whose
    ``slot`` (global, B,) falls in the block is written, in place, the
    others keep their values (the JAX ``where(owns, written, ci)``).
    Returns the (same) block."""
    s_loc = cache.shape[1]
    local = slot.long() - SH.axis_index(mesh, axis) * s_loc
    owns = (local >= 0) & (local < s_loc)
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = local.clamp(0, s_loc - 1)
    cache[rows, idx] = torch.where(owns[:, None, None],
                                   new[:, 0].to(cache.dtype),
                                   cache[rows, idx])
    return cache


def seq_parallel_decode_attention(q, k_cache, v_cache, kv_positions, pos, *,
                                  mesh, axis: str):
    """Flash decoding over a cache sharded over its sequence on ``axis``:
    ``q`` (B, 1, H, D) and ``pos`` (B,) the same on every rank of the axis,
    ``k_cache`` / ``v_cache`` (B, S_loc, K, D) and ``kv_positions`` (B,
    S_loc) this rank's rows. Each rank's partial softmax (m, l, o) over its
    rows, merged with exp-weighted sums over ``axis``. Returns (B, 1, H,
    D), the same on every rank."""
    d = q.shape[-1]
    logits = _gqa_logits(q * d ** -0.5, k_cache)       # (B,K,G,1,S_loc)
    valid = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    vmask = valid[:, None, None, None, :]
    logits = torch.where(vmask, logits, NEG_INF)
    m = logits.amax(dim=-1)                                # (B,K,G,1)
    p = torch.exp(logits - m[..., None])
    p = torch.where(vmask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype),
                     v_cache).float()
    m_g = SH.pmax(m, axis, mesh)
    scale = torch.exp(m - m_g)
    l_g = SH.psum(l * scale, axis, mesh)
    o_g = SH.psum(o * scale[..., None], axis, mesh)
    out = o_g / l_g.clamp(min=1e-30)[..., None]
    b, kh, g, sq, dd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, kh * g, dd).to(q.dtype)


def prefix_suffix_attention(q, k_sfx, v_sfx, k_pre, v_pre, prefix_len,
                            q_positions):
    """Suffix prefill attending over a reused (gathered) KV prefix: the
    shared-prefix prefill path (docs/KV_SHARING.md), where a cache-hit
    request recomputes only its unshared suffix.

    q: (B, S, H, D) suffix queries at absolute positions ``q_positions``
    (B, S); k_sfx/v_sfx: (B, S, K, D) the suffix's own K/V; k_pre/v_pre:
    (B, Lp, K, D) the prefix K/V gathered from the page pool, slot ``t``
    valid iff ``t < prefix_len[b]`` (slot index is the absolute position:
    shared pages are prompt-aligned from 0). Padded suffix columns are
    masked by causality. One block, the JAX op sequence: scale q,
    concatenate prefix and suffix, mask by absolute positions, fp32
    logits, subtract the max, exp, sum, divide; so an empty prefix gives
    the plain prefill path's numbers."""
    b, sq, h, d = q.shape
    lp = k_pre.shape[1]
    q = (q * d ** -0.5).to(q.dtype)
    kc = torch.cat([k_pre.to(k_sfx.dtype), k_sfx], dim=1)
    vc = torch.cat([v_pre.to(v_sfx.dtype), v_sfx], dim=1)
    q_pos = q_positions.long()
    pre_pos = torch.arange(lp, device=q.device)[None].expand(b, lp)
    pre_pos = torch.where(pre_pos < prefix_len.long()[:, None], pre_pos,
                          torch.iinfo(torch.int32).max)
    kv_pos = torch.cat([pre_pos, q_pos], dim=1)               # (B, Lp+S)
    logits = _gqa_logits(q, kc)                           # (B,K,G,Sq,Lp+S)
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]            # (B,Sq,Sk)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p.to(vc.dtype), vc).float()
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Model-level dispatchers: every call reaches a kernel wrapper, which
# launches the CUDA kernel for CUDA tensors and runs the plain version for
# CPU tensors.
# ---------------------------------------------------------------------------

def attention_prefill(q, k, v, *, causal=True, window=0, q_offset=0):
    """Prefill attention (model layout): q (B,Sq,H,D), k/v (B,Sk,K,D), query
    row i at position ``q_offset + i`` among the keys (a chunk of a prompt
    over its cached context)."""
    return ops.flash_attention_op(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)


def attention_decode(q, k_cache, v_cache, kv_positions, pos):
    """Decode attention over a dense per-slot cache (model layout): q (B, 1,
    H, D), caches (B, S, K, D), kv_positions (B, S) int32 absolute position
    of each row (-1 = empty), pos (B,) int32. Every cache length goes to
    the kernel: it masks the tail, where the JAX dispatcher sent only
    ``S % 128 == 0`` to its TPU kernel."""
    return ops.decode_attention_op(q, k_cache, v_cache, kv_positions, pos)


def attention_decode_paged(q, k_pages, v_pages, block_tables, pos):
    """Decode attention over a block-paged cache.

    q: (B, 1, H, D); pages: (P, ps, K, D) shared physical page pool;
    block_tables: (B, n_b) int32 physical page per (slot, block) — every
    entry must be a valid page index (unused entries point at a trash
    page); pos: (B,) absolute position of the current token.
    """
    return ops.paged_decode_attention_op(q, k_pages, v_pages, block_tables,
                                         pos)


def attention_fused_paged(qp, kp, vp, qd, k_pages, v_pages, block_tables,
                          pos, *, decode_share: float = 0.5,
                          causal: bool = True, window: int = 0):
    """Fused prefill+decode attention (model layout): a prefill batch's
    attention (qp/kp/vp, (Bp,Sp,·,D)) AND a decode iteration's paged
    attention (qd (Bd,1,H,D) over the page pool) in one launch whose SMs
    split by ``decode_share``. Outputs equal ``attention_prefill`` +
    ``attention_decode_paged`` exactly, so fused and serial engines are
    token-identical."""
    return ops.bullet_attention_paged_op(
        qp, kp, vp, qd, k_pages, v_pages, block_tables, pos,
        decode_share=decode_share, causal=causal, window=window)
