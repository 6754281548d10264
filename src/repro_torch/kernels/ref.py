"""Plain PyTorch versions of the attention kernels: the one implementation
that the kernel wrappers run for CPU tensors, that the CUDA kernels are
held against on the card, and that ``repro_torch.models.attention``
exports to the model.

The math is the JAX package's XLA path (``models/attention.py``), so the
port's CPU engine reproduces the JAX engine token for token:

- ``flash_ref_attention``: blockwise online-softmax causal/windowed
  attention (never materializes more than one KV block of scores).
- ``decode_attention``: single-token GQA attention over a per-slot cache.
- ``paged_decode_ref``: gather a slot's pages, then ``decode_attention``.

The oracles of the JAX package's ``kernels/ref.py`` are adapters of that
math to the kernel layouts (``flash_attention_ref``,
``paged_decode_attention_ref``, ``bullet_attention_paged_ref``); the
dense-cache and scan oracles come with their kernels in a later slice.

An inactive decode slot (pos < 0) masks every key: here, as in the JAX
reference, its softmax is uniform and returns the mean of V, where the
kernels return zeros. The engine discards those rows either way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _gqa_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,D), k: (B,Sk,K,D) -> (B, K, H/K, Sq, Sk) fp32 logits
    (fp32 products of the inputs, as JAX's preferred_element_type)."""
    b, sq, h, d = q.shape
    kheads = k.shape[2]
    qg = q.reshape(b, sq, kheads, h // kheads, d)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,K,G,Sq,Sk) fp32, v: (B,Sk,K,D) -> (B,Sq,H,D); probabilities
    are cast to V's dtype first."""
    b, kheads, g, sq, sk = p.shape
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(b, sq, kheads * g, -1)


def flash_ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_size: int = 1024) -> torch.Tensor:
    """Blockwise attention with online softmax.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0. Query and key
    positions both start at 0. ``window`` > 0 enables sliding-window
    masking (|i-j| < window).
    """
    b, sq, h, d = q.shape
    sk, kheads = k.shape[1], k.shape[2]
    g = h // kheads
    q = (q * d ** -0.5).to(q.dtype)
    bs = min(block_size, sk)
    n_blocks = -(-sk // bs)
    pad = n_blocks * bs - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, kheads, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kheads, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for i in range(n_blocks):
        k_blk = k[:, i * bs:(i + 1) * bs]
        v_blk = v[:, i * bs:(i + 1) * bs]
        k_pos = i * bs + torch.arange(bs, device=q.device)
        logits = _gqa_logits(q, k_blk)                       # (B,K,G,Sq,bs)
        mask = (k_pos[None, :] < sk).expand(sq, bs)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(v_blk.dtype), v_blk).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a cache.

    q: (B, 1, H, D); caches: (B, S, K, D); kv_positions: (B, S) absolute
    position of each cache slot (−1 = empty); pos: (B,) current absolute
    position. Returns (B, 1, H, D).
    """
    d = q.shape[-1]
    logits = _gqa_logits(q * d ** -0.5, k_cache)             # (B,K,G,1,S)
    valid = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return _gqa_out(p, v_cache)


def gather_pages(pages: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """Materialize each slot's paged KV as a contiguous per-slot cache:
    pages (P, ps, K, D) + tables (B, n_b) -> (B, n_b·ps, K, D). Positions
    are contiguous from 0 by construction of the paged layout."""
    b, n_b = block_tables.shape
    ps = pages.shape[1]
    return pages[block_tables.long()].reshape(b, n_b * ps, *pages.shape[2:])


def paged_decode_ref(q, k_pages, v_pages, block_tables, pos):
    """Paged decode in model layout, q (B, 1, H, D): gather each slot's
    pages into a contiguous per-slot cache and run the dense path."""
    b, n_b = block_tables.shape
    ps = k_pages.shape[1]
    kc = gather_pages(k_pages, block_tables)
    vc = gather_pages(v_pages, block_tables)
    kvpos = torch.arange(n_b * ps, device=q.device)[None].expand(b, n_b * ps)
    return decode_attention(q, kc, vc, kvpos, pos)


# ---------------------------------------------------------------------------
# The same math on the kernel layouts: the kernels' plain versions.
# ---------------------------------------------------------------------------

def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        group: int = 1):
    """q: (BH, Sq, D); k, v: (BH/group, Sk, D), kv head = bh // group
    (``group=1``: kv pre-expanded, as the JAX oracle takes it). Each kv
    head runs as a batch row with ``group`` query heads."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    qm = q.reshape(bhk, group, sq, d).transpose(1, 2)     # (BHk, Sq, G, D)
    o = flash_ref_attention(qm, k.reshape(bhk, sk, 1, d),
                            v.reshape(bhk, sk, 1, d), causal=causal,
                            window=window)
    return o.transpose(1, 2).reshape(bh, sq, d)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, pos):
    """q: (B, K, G, D); pages: (P+1, ps, K, D); block_tables: (B, n_b);
    pos: (B,). Returns (B, K, G, D)."""
    b, kh, g, d = q.shape
    o = paged_decode_ref(q.reshape(b, 1, kh * g, d), k_pages, v_pages,
                         block_tables, pos)
    return o.reshape(b, kh, g, d)


def bullet_attention_paged_ref(qp, kp, vp, qd, k_pages, v_pages,
                               block_tables, pos, *, causal=True, window=0,
                               group=1):
    """Fused hybrid batch = prefill flash + paged decode, back to back."""
    out_p = flash_attention_ref(qp, kp, vp, causal=causal, window=window,
                                group=group)
    out_d = paged_decode_attention_ref(qd, k_pages, v_pages, block_tables,
                                       pos)
    return out_p, out_d
