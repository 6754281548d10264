"""Attention ops in model layout, ported from the JAX package's XLA path.

The plain attention math (``flash_ref_attention``, ``decode_attention``,
``gather_pages``, ``paged_decode_ref``, ``NEG_INF``) lives once, in
``repro_torch.kernels.ref``, next to the kernels it is the plain version
of; it is re-exported here under the JAX package's names. This module adds
``write_paged_kv`` and the model's entry points, the dispatchers at the
end, which reach the kernels through ``repro_torch.kernels.ops``: a CUDA
tensor launches the CUDA kernel, a CPU tensor runs the plain version.
"""

from __future__ import annotations

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (NEG_INF, decode_attention,  # noqa: F401
                                     flash_ref_attention, gather_pages,
                                     paged_decode_ref)


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


# ---------------------------------------------------------------------------
# Model-level dispatchers: every call reaches a kernel wrapper, which
# launches the CUDA kernel for CUDA tensors and runs the plain version for
# CPU tensors.
# ---------------------------------------------------------------------------

def attention_prefill(q, k, v, *, causal=True, window=0):
    """Prefill attention (model layout): q (B,S,H,D), k/v (B,S,K,D)."""
    return ops.flash_attention_op(q, k, v, causal=causal, window=window)


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
    attention (qd (Bd,1,H,D) over the page pool) in one launch whose CTAs
    split by ``decode_share``. Outputs equal ``attention_prefill`` +
    ``attention_decode_paged`` exactly, so fused and serial engines are
    token-identical."""
    return ops.bullet_attention_paged_op(
        qp, kp, vp, qd, k_pages, v_pages, block_tables, pos,
        decode_share=decode_share, causal=causal, window=window)
