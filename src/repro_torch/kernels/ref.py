"""Plain PyTorch versions of the attention kernels, and the sequential SSD
oracle: the one implementation
that the kernel wrappers run for CPU tensors, that the CUDA kernels are
held against on the card, and that ``repro_torch.models.attention``
exports to the model.

The math is the JAX package's XLA path (``models/attention.py``), so the
port's CPU engine reproduces the JAX engine token for token:

- ``flash_ref_attention``: blockwise online-softmax causal/windowed
  attention, queries at a position offset (never materializes more than
  one KV block of scores).
- ``decode_attention``: single-token GQA attention over a per-slot cache.
- ``paged_decode_ref``: gather a slot's pages, then ``decode_attention``.

The oracles of the JAX package's ``kernels/ref.py`` are adapters of that
math to the kernel layouts (``flash_attention_ref``,
``decode_attention_ref``, ``paged_decode_attention_ref``,
``bullet_attention_ref``, ``bullet_attention_paged_ref``);
``decode_attention_split_ref`` is the bf16 dense decode kernel's split
and merge spelled out, for the card tests, and
``paged_decode_attention_split_ref`` the same over a slot's gathered
pages (the bf16 paged kernel runs the dense kernel's body).
``flash_attention_bwd_ref`` is kernel 1's gradient written out (the plain
version of ``csrc/flash_attention_bwd.cu``; the JAX package takes it
through XLA's autodiff of ``flash_ref_attention``).
``ssd_scan_ref`` and ``rglru_scan_ref`` are the JAX package's sequential
SSD and RG-LRU oracles, one step per position; the plain versions the
kernels are held against live beside their wrappers
(``kernels/ssd_scan.py``, ``kernels/rglru_scan.py``).
``ssd_scan_bwd_ref`` and ``rglru_scan_bwd_ref`` are the two scans'
gradients written out (the plain versions of ``csrc/ssd_scan_bwd.cu``
and of ``rglru_scan_bwd`` in ``csrc/rglru_scan.cu``; the JAX package
takes them through XLA's autodiff of its ``lax.scan`` and associative
scan).

A decode slot with no attended key (pos < 0, or, dense, no kv position in
[0, pos]) masks every key: here, as in the JAX reference, its softmax is
uniform and returns the mean of V, where the kernels return zeros. The
engine discards those rows either way.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.geometry import slot_pieces

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
                        q_offset: int = 0,
                        block_size: int = 1024) -> torch.Tensor:
    """Blockwise attention with online softmax.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0. ``q_offset``:
    the position of q[0] among the keys (a chunk of a prompt with
    ``q_offset`` tokens cached before it), so query row i sits at
    ``q_offset + i`` and key row j at j. ``window`` > 0 enables
    sliding-window masking (|i-j| < window).
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
    q_pos = torch.arange(sq, device=q.device) + q_offset
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
                        group: int = 1, q_offset: int = 0):
    """q: (BH, Sq, D); k, v: (BH/group, Sk, D), kv head = bh // group
    (``group=1``: kv pre-expanded, as the JAX oracle takes it). Each kv
    head runs as a batch row with ``group`` query heads; query row i sits
    at position ``q_offset + i`` among the keys."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    qm = q.reshape(bhk, group, sq, d).transpose(1, 2)     # (BHk, Sq, G, D)
    o = flash_ref_attention(qm, k.reshape(bhk, sk, 1, d),
                            v.reshape(bhk, sk, 1, d), causal=causal,
                            window=window, q_offset=q_offset)
    return o.transpose(1, 2).reshape(bh, sq, d)


def _flash_mask(sq: int, sk: int, causal: bool, window: int, device):
    """(Sq, Sk) bool: key j is seen by query i iff (not causal or j <= i)
    and (no window or j > i - window)."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask = mask & (j <= i)
    if window > 0:
        mask = mask & (j > i - window)
    return mask


def flash_lse_ref(q, k, *, causal: bool = True, window: int = 0,
                  group: int = 1):
    """Each query row's log2-sum-exp2 of its scaled logits over the keys
    it sees, log2(sum_j 2^(q·k_j · D^-0.5 · log2 e)), (BH, Sq) fp32 from
    q (BH, Sq, D) and k (BH/group, Sk, D) in fp32, at ``q_offset`` 0: the
    plain version of what ``flash_attention_fwd_lse`` writes for kernel
    1's bf16 backward."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    s = torch.einsum("hgqd,hkd->hgqk", q.float().reshape(bhk, group, sq, d),
                     k.float()) * d ** -0.5
    s = s.masked_fill(~_flash_mask(sq, sk, causal, window, q.device),
                      NEG_INF)
    return (torch.logsumexp(s, dim=-1) * math.log2(math.e)).reshape(bh, sq)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window: int = 0, group: int = 1):
    """The gradient of ``flash_attention_ref`` at ``q_offset`` 0, written
    out (the plain version of ``csrc/flash_attention_bwd.cu``): from q
    (BH, Sq, D), k, v (BH/group, Sk, D), the forward's output ``o`` and
    its gradient ``do`` (BH, Sq, D), recompute each query row's
    log-sum-exp over the keys it sees and P = exp(S - lse), then dV = Pᵀ
    dO summed over the group's heads, dP = dO Vᵀ, dS = P ⊙ (dP - rowsum(dO
    ⊙ O)), dK = dSᵀ Q·scale and dQ = dS K·scale, in fp32. Key j is seen by
    query i iff (not causal or j <= i) and (no window or j > i - window).
    Returns (dq, dk, dv) in the inputs' dtypes."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    scale = d ** -0.5
    qs = (q * scale).to(q.dtype).float().reshape(bhk, group, sq, d)
    kf, vf = k.float(), v.float()
    mask = _flash_mask(sq, sk, causal, window, q.device)
    s = torch.einsum("hgqd,hkd->hgqk", qs, kf).masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse).masked_fill(~mask, 0.0)
    dof = do.float().reshape(bhk, group, sq, d)
    delta = (dof * o.float().reshape(bhk, group, sq, d)).sum(-1,
                                                              keepdim=True)
    dv = torch.einsum("hgqk,hgqd->hkd", p, dof)
    ds = p * (torch.einsum("hgqd,hkd->hgqk", dof, vf) - delta)
    dq = torch.einsum("hgqk,hkd->hgqd", ds, kf) * scale
    dk = torch.einsum("hgqk,hgqd->hkd", ds, qs)
    return (dq.reshape(bh, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q, k_cache, v_cache, kv_positions, pos):
    """q: (B, K, G, D); caches: (B, S, K, D); kv_positions: (B, S); pos:
    (B,). Returns (B, K, G, D)."""
    b, kh, g, d = q.shape
    o = decode_attention(q.reshape(b, 1, kh * g, d), k_cache, v_cache,
                         kv_positions, pos)
    return o.reshape(b, kh, g, d)


def decode_attention_split_ref(q, k_cache, v_cache, kv_positions, pos,
                               n_split: int, tile: int = 64):
    """The bf16 dense decode kernel's split and merge, plainly, in fp32
    (flash-decoding): the S rows are cut into ``ceil(S / tile)`` tiles,
    piece ``p`` of ``n_split`` takes tiles ``[p·T/n, (p+1)·T/n)``, each
    piece keeps its own (m, l, acc) over its attended rows, and the
    pieces merge in order, weighted by ``exp(m_p - max m)`` (0 for a piece
    with no attended row). Shapes as ``decode_attention_ref``; returns
    (B, K, G, D) in q's dtype. Unlike ``decode_attention_ref`` a slot with
    no attended row returns zeros, the kernels' contract."""
    b, kh, g, d = q.shape
    s = k_cache.shape[1]
    n_t = -(-s // tile)
    qf = q.float() * d ** -0.5
    valid = (kv_positions >= 0) & (kv_positions <= pos[:, None])   # (B, S)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    logits = torch.where(valid[:, None, None, :], logits, -1e30)
    vf = v_cache.float()
    ms, ls, accs = [], [], []
    for p in range(n_split):
        lo = min(s, p * n_t // n_split * tile)
        hi = min(s, (p + 1) * n_t // n_split * tile)
        m = logits.new_full((b, kh, g), -1e30)
        if hi > lo:
            m = torch.maximum(m, logits[..., lo:hi].amax(-1))
        e = torch.where(valid[:, None, None, lo:hi],
                        torch.exp(logits[..., lo:hi] - m[..., None]), 0.0)
        ms.append(m)
        ls.append(e.sum(-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", e, vf[:, lo:hi]))
    m_all = torch.stack(ms)
    w = torch.where(m_all == -1e30, 0.0, torch.exp(m_all - m_all.amax(0)))
    l_all = (w * torch.stack(ls)).sum(0)
    acc = (w[..., None] * torch.stack(accs)).sum(0)
    return (acc / l_all.clamp_min(1e-30)[..., None]).to(q.dtype)


def paged_decode_attention_split_ref(q, k_pages, v_pages, block_tables, pos,
                                     n_split: int, tile: int = 64):
    """The bf16 paged decode kernel's split and merge, plainly: each
    slot's first ``live = min(pos + 1, n_b·ps)`` gathered rows, with linear
    positions, through ``decode_attention_split_ref`` in
    ``geometry.slot_pieces(n_split, live)`` pieces (the slot's own tiles
    are split, whatever the table's width). No arithmetic of its own: it
    states that the paged body is the dense body over the slot's live
    rows. Shapes as ``paged_decode_attention_ref``; an inactive slot
    returns zeros."""
    b, n_b = block_tables.shape
    rows = n_b * k_pages.shape[1]
    kc = gather_pages(k_pages, block_tables)
    vc = gather_pages(v_pages, block_tables)
    outs = []
    for i, p in enumerate(pos.tolist()):
        live = max(0, min(p + 1, rows))
        kvpos = torch.arange(live, dtype=torch.int32,
                             device=q.device)[None]
        outs.append(decode_attention_split_ref(
            q[i:i + 1], kc[i:i + 1, :live], vc[i:i + 1, :live], kvpos,
            pos[i:i + 1], slot_pieces(n_split, live), tile))
    return torch.cat(outs)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, pos):
    """q: (B, K, G, D); pages: (P+1, ps, K, D); block_tables: (B, n_b);
    pos: (B,). Returns (B, K, G, D)."""
    b, kh, g, d = q.shape
    o = paged_decode_ref(q.reshape(b, 1, kh * g, d), k_pages, v_pages,
                         block_tables, pos)
    return o.reshape(b, kh, g, d)


def bullet_attention_ref(qp, kp, vp, qd, k_cache, v_cache, kv_positions,
                         pos, *, causal=True, window=0, group=1):
    """Fused hybrid batch = prefill flash + dense decode, back to back."""
    out_p = flash_attention_ref(qp, kp, vp, causal=causal, window=window,
                                group=group)
    out_d = decode_attention_ref(qd, k_cache, v_cache, kv_positions, pos)
    return out_p, out_d


def bullet_attention_paged_ref(qp, kp, vp, qd, k_pages, v_pages,
                               block_tables, pos, *, causal=True, window=0,
                               group=1):
    """Fused hybrid batch = prefill flash + paged decode, back to back."""
    out_p = flash_attention_ref(qp, kp, vp, causal=causal, window=window,
                                group=group)
    out_d = paged_decode_attention_ref(qd, k_pages, v_pages, block_tables,
                                       pos)
    return out_p, out_d


def ssd_scan_ref(xw, da_cumsum, B_, C, state0=None):
    """Sequential SSD oracle in cumulative-decay form.

    xw: (B, S, H, P) inputs already scaled by dt;
    da_cumsum: (B, S, H) cumulative sum of dt*A (log decay);
    B_, C: (B, S, N). Returns (y (B,S,H,P), final_state (B,H,P,N) fp32)."""
    bsz, s, h, p = xw.shape
    n = B_.shape[-1]
    da = torch.diff(da_cumsum.float(), dim=1,
                    prepend=da_cumsum.new_zeros((bsz, 1, h)).float())
    st = (xw.new_zeros((bsz, h, p, n), dtype=torch.float32)
          if state0 is None else state0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(da[:, t])                       # (B,H)
        st = st * decay[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xw[:, t].float(), B_[:, t].float())
        ys.append(torch.einsum("bhpn,bn->bhp", st, C[:, t].float()))
    return torch.stack(ys, dim=1).to(xw.dtype), st


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and back to fp32."""
    return t.to(torch.bfloat16).float()


def ssd_scan_tc_ref(xw, cum, B_, C, state0=None):
    """The bf16 SSD chunk scan kernel's numerics, plainly, in fp32 (the
    kernel's arithmetic in another summation order), from ``state0`` (B,
    H, P, N) fp32 (zeros without it; the state entering chunk 0 is
    rounded to bf16 for its inter term, as every chunk's). Per row and
    chunk C Bᵀ is computed once, in fp32 (C and B are exact in bf16); per
    head:

    - intra: (C Bᵀ ⊙ L) rounded to bf16, times xw (exact in bf16);
    - inter: e^{cum} ⊙ (C S₁₆), with S₁₆ the state rounded to bf16;
    - state: S ← e^{total} S + Bᵀ V_hi + Bᵀ V_lo, where V = xw ⊙
      e^{total − cum} is split into V_hi = bf16(V) and V_lo = bf16(V −
      V_hi), so V is carried to about 2⁻¹⁷ of itself.

    Shapes and returns as ``kernels/ssd_scan.py``'s ``ssd_scan``: y in
    xw's dtype, the final state (B, H, P, N) fp32."""
    b, nc, q, h, p = xw.shape
    n = B_.shape[-1]
    causal = torch.ones(q, q, dtype=torch.bool, device=xw.device).tril()
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=xw.device)
             if state0 is None else state0.float())
    ys = []
    for ci in range(nc):
        x_c = xw[:, ci].float()                             # (B,Q,H,P)
        cum_c = cum[:, ci].float()                          # (B,Q,H)
        b_c, c_c = B_[:, ci].float(), C[:, ci].float()      # (B,Q,N)
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)         # once per chunk
        seg = cum_c[:, :, None, :] - cum_c[:, None, :, :]   # (B,Q,Q,H)
        L = torch.exp(torch.where(causal[None, :, :, None], seg,
                                  float("-inf")))
        y_intra = torch.einsum("bijh,bjhp->bihp", _bf16(cb[..., None] * L),
                               x_c)
        y_inter = torch.einsum("bin,bhpn->bihp", c_c, _bf16(state)) \
            * torch.exp(cum_c)[..., None]
        v = x_c * torch.exp(cum_c[:, -1:, :] - cum_c)[..., None]
        v_hi = _bf16(v)
        v_lo = _bf16(v - v_hi)
        state = (state * torch.exp(cum_c[:, -1, :])[..., None, None]
                 + torch.einsum("bjn,bjhp->bhpn", b_c, v_hi)
                 + torch.einsum("bjn,bjhp->bhpn", b_c, v_lo))
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).to(xw.dtype), state


def rglru_scan_ref(a, b, h0=None):
    """Sequential linear recurrence h_t = a_t * h_{t-1} + b_t.

    a, b: (B, S, W) fp32; h0: (B, W). Returns (h (B,S,W), h_T)."""
    bsz, s, w = a.shape
    h = a.new_zeros((bsz, w), dtype=torch.float32) if h0 is None else h0
    hs = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_scan_bwd_ref(a, y, h0, dy, dh_last):
    """The gradient of the recurrence h_t = a_t·h_{t-1} + b_t (y_t = h_t,
    h_T = h_{S-1}), written out: walking the sequence backwards,

        dh_t = a_{t+1}·dh_{t+1} + dy_t,  dh_{S-1} = dh_last + dy_{S-1}
        da_t = dh_t·h_{t-1},  db_t = dh_t,  dh0 = a_0·dh_0,

    with h_{t-1} read from the forward's output ``y`` (exact in fp32) and
    h_{-1} = h0 (zeros without it). a, y, dy: (B, S, W); h0, dh_last: (B,
    W) or None (zeros). Each step multiplies, then adds, as the forward
    does. Returns (da, db, dh0) in fp32, dh0 None without h0."""
    bsz, s, w = a.shape
    af, yf, dyf = a.float(), y.float(), dy.float()
    g = (torch.zeros(bsz, w, dtype=torch.float32, device=a.device)
         if dh_last is None else dh_last.float())
    da = torch.empty_like(af)
    db = torch.empty_like(af)
    for t in range(s - 1, -1, -1):
        dh = g + dyf[:, t]
        if t > 0:
            da[:, t] = dh * yf[:, t - 1]
        elif h0 is not None:
            da[:, t] = dh * h0.float()
        else:
            da[:, t] = 0.0
        db[:, t] = dh
        g = af[:, t] * dh
    return da, db, (None if h0 is None else g)


def ssd_scan_bwd_ref(xw, cum, B_, C, state0, dy, dstate):
    """The gradient of the SSD chunk scan (``kernels/ssd_scan.py``'s
    ``ssd_scan``), written out in fp32. Per chunk, with S the state
    entering it, S' the state it leaves, G = ∂L/∂S', total = cum_{Q-1},
    L_ij = e^{cum_i − cum_j} (j ≤ i), cb_ij = C_i·B_j and M_ij = L_ij
    (dy_i·xw_j) per head:

        dxw_j = Σ_{i≥j} cb_ij L_ij dy_i + e^{total−cum_j} G B_j
        dC_i  = Σ_h [Σ_{j≤i} M_ij B_j + e^{cum_i} Sᵀ dy_i]
        dB_j  = Σ_h [Σ_{i≥j} M_ij C_i + e^{total−cum_j} Gᵀ xw_j]
        dcum_i = Σ_j cb_ij M_ij − Σ_j cb_ji M_ji       (the decay mask)
               + dy_i·e^{cum_i} S C_i                   (the inter term)
               − xw_i·e^{total−cum_i} G B_i             (the state update)
               + [i = Q−1] ⟨G, S'⟩                      (e^{total})
        ∂L/∂S = e^{total} G + Σ_i e^{cum_i} dy_i C_iᵀ

    B and C are shared by the heads (n_groups = 1), so their gradients
    sum over them. The states entering the chunks are recomputed forward
    from ``state0`` (zeros without it), then the chunks are walked
    backwards from ``dstate`` (zeros without it). Inputs as ``ssd_scan``'s
    plus dy (B, NC, Q, H, P) and dstate (B, H, P, N). Returns (dxw, dcum,
    dB, dC, dstate0) in fp32, dstate0 None without ``state0``."""
    b, nc, q, h, p = xw.shape
    n = B_.shape[-1]
    dev = xw.device
    causal = torch.ones(q, q, dtype=torch.bool, device=dev).tril()
    xf, cf = xw.float(), cum.float()
    bf, cc = B_.float(), C.float()
    dyf = dy.float()
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=dev)
             if state0 is None else state0.float())
    states = [state]
    for ci in range(nc):
        d_end = torch.exp(cf[:, ci, -1:, :] - cf[:, ci])        # (B,Q,H)
        state = (state * torch.exp(cf[:, ci, -1, :])[..., None, None]
                 + torch.einsum("bjn,bjh,bjhp->bhpn", bf[:, ci], d_end,
                                xf[:, ci]))
        states.append(state)
    g = (torch.zeros(b, h, p, n, dtype=torch.float32, device=dev)
         if dstate is None else dstate.float())
    dxw = torch.empty_like(xf)
    dcum = torch.empty_like(cf)
    dB = torch.empty_like(bf)
    dC = torch.empty_like(cc)
    for ci in range(nc - 1, -1, -1):
        x_c, cum_c, dy_c = xf[:, ci], cf[:, ci], dyf[:, ci]
        b_c, c_c = bf[:, ci], cc[:, ci]
        s_in, s_out = states[ci], states[ci + 1]
        seg = cum_c[:, :, None, :] - cum_c[:, None, :, :]       # (B,Q,Q,H)
        L = torch.exp(torch.where(causal[None, :, :, None], seg,
                                  float("-inf")))
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)             # (B,Q,Q)
        M = L * torch.einsum("bihp,bjhp->bijh", dy_c, x_c)
        A = cb[..., None] * M
        e_cum = torch.exp(cum_c)                                # (B,Q,H)
        d_end = torch.exp(cum_c[:, -1:, :] - cum_c)             # (B,Q,H)
        dc_inter = torch.einsum("bih,bihp,bhpn->bihn", e_cum, dy_c, s_in)
        u = torch.einsum("bhpn,bjn->bjhp", g, b_c) * d_end[..., None]
        dxw[:, ci] = torch.einsum("bij,bijh,bihp->bjhp", cb, L, dy_c) + u
        dC[:, ci] = torch.einsum("bijh,bjn->bin", M, b_c) + dc_inter.sum(2)
        dB[:, ci] = (torch.einsum("bijh,bin->bjn", M, c_c)
                     + torch.einsum("bjhp,bhpn,bjh->bjn", x_c, g, d_end))
        dcum_c = (A.sum(2) - A.sum(1)
                  + torch.einsum("bihn,bin->bih", dc_inter, c_c)
                  - (x_c * u).sum(-1))
        dcum_c[:, -1] += (g * s_out).sum((-2, -1))
        dcum[:, ci] = dcum_c
        g = (g * torch.exp(cum_c[:, -1, :])[..., None, None]
             + torch.einsum("bih,bihp,bin->bhpn", e_cum, dy_c, c_c))
    return dxw, dcum, dB, dC, (None if state0 is None else g)
