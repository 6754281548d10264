"""The work of each hand-written kernel, stated once: the bytes a call must
move and the operations it must do for its inputs, and the least time an
H100 SXM could take for them (:func:`bound_ms`).

Three readers share these formulas: ``chip_smoke.py`` (the bound column of
its kernel table), the roofline counter (``launch/roofline.py``), which
charges every kernel launch by them, and the dry-run built on it. Bytes
count each input read once and each output written once; operations count
what this call's data needs (the causal pairs of a prompt, the attended
rows of a decode).

Peaks (:data:`HBM_BW`, :data:`PEAK_OPS`, :data:`HBM_BYTES`): the H100 SXM
data sheet, dense, which assumes the card's 700 W power limit: 3.35 TB/s
of HBM3, 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside
them (fp32 matrix products run there: TF32 is off), 80 GB.

The charge hook: :data:`COUNTER` is None unless a roofline counter runs.
Every kernel wrapper reads it once per call; when it is set the wrapper
runs inside ``COUNTER.kernel(name, price)``, which charges the launch
``price()`` = (bytes, operations, dtype) and counts none of the ops the
wrapper runs inside (its plain version's on the CPU, its output
allocations on the meta device and the card)."""

from __future__ import annotations

import torch

#: H100 SXM HBM3 bytes a second
HBM_BW = 3.35e12
#: H100 SXM dense peak operations a second by type: bf16 and fp16 on the
#: tensor cores, fp32 on the CUDA cores
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
#: H100 SXM device memory, bytes
HBM_BYTES = 80e9
#: the flash backward's operations over the forward's (both products
#: again, and dO Vᵀ, Pᵀ dO, dSᵀ Q, dS K: 5 products against the forward's 2)
BWD_OPS = 2.5

#: the active roofline counter (``launch/roofline.Counter``) or None
COUNTER = None


def esize(dtype) -> int:
    """Bytes of one element of ``dtype``."""
    return dtype.itemsize


def peak_ops(dtype) -> float:
    """The peak rate of ``dtype``'s operations (other types: fp32's)."""
    return PEAK_OPS.get(dtype, PEAK_OPS[torch.float32])


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over ``dtype``'s peak."""
    t_b = n_bytes / HBM_BW * 1e3
    t_o = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def causal_pairs(s: int, sk: int, window: int = 0, q_offset: int = 0) -> int:
    """Σ over query rows i < ``s`` of min(q_offset + i + 1, window or sk):
    the (query, key) pairs a causal prompt sees, query i at position
    ``q_offset + i`` with the keys at or before it, within ``window``."""
    cap = window or sk
    first = q_offset + 1
    if first >= cap:
        return s * cap
    m = min(s, cap - first + 1)          # rows below the cap
    return m * first + m * (m - 1) // 2 + (s - m) * cap


def flash_cost(bp, s, dtype, *, h: int, kh: int, d: int, window: int = 0,
               causal: bool = True, sk: int = 0, q_offset: int = 0):
    """Flash's bytes (q, k, v read, the output written) and operations
    (both products over the causal pairs, query i at position ``q_offset
    + i`` with the keys at or before it, within ``window`` keys; not
    ``causal``: every query of ``s`` with every key of ``sk`` or ``s``)."""
    sk = sk or s
    n_bytes = (2 * bp * h * s * d + 2 * bp * kh * sk * d) * esize(dtype)
    pairs = causal_pairs(s, sk, window, q_offset) if causal else s * sk
    return n_bytes, 4 * d * bp * h * pairs


def decode_cost(q, pos, dtype, ps: int, n_b: int = 0):
    """What the paged decode function needs for this run's data: the K and
    V rows of every active slot's positions <= pos, q read and the output
    written, the block-table entries of the live pages and pos; the
    scores and the PV product over those rows. On the meta device ``pos``
    holds no values: every slot then attends all ``n_b`` pages of its
    block table."""
    _, kh, g, d = q.shape
    if pos.is_meta:
        live = [n_b * ps] * pos.shape[0]
    else:
        live = [int(p) + 1 for p in pos.tolist() if p >= 0]
    tokens = sum(live)
    entries = sum(-(-c // ps) for c in live)
    n_bytes = (2 * tokens * kh * d + 2 * q.numel()) * esize(dtype) \
        + 4 * (entries + pos.numel())
    n_ops = 4 * g * d * kh * tokens
    return n_bytes, n_ops


def dense_cost(q, kvpos, pos, dtype):
    """What the dense decode function needs for this run's data: the K and
    V rows whose position is attended (0 <= kv_position <= pos), q read
    and the output written, kv_positions and pos read; the scores and the
    PV product over those rows. On the meta device every row of the cache
    is attended."""
    _, kh, g, d = q.shape
    if kvpos.is_meta:
        rows = kvpos.numel()
    else:
        rows = int(((kvpos >= 0) & (kvpos <= pos[:, None])).sum())
    n_bytes = (2 * rows * kh * d + 2 * q.numel()) * esize(dtype) \
        + 4 * (kvpos.numel() + pos.numel())
    return n_bytes, 4 * g * d * kh * rows


def ssd_cost(xw, dtype, n: int, state: bool = False):
    """What the scan needs for these inputs: xw read and y written at the
    dtype, cum in fp32, B and C (state size ``n``) at the dtype, the final
    state in fp32 (with ``state`` the starting state read too); C Bᵀ
    (2·Q²·N) once per row and chunk, shared by the heads, and per head and
    chunk the masked product with xw (2·Q²·P), the inter-chunk term and the
    state update (2·Q·N·P each)."""
    b, nc, q, h, p = xw.shape
    e = esize(dtype)
    rows = b * nc * q
    n_bytes = (2 * rows * h * p + 2 * rows * n) * e + 4 * rows * h \
        + 4 * b * h * p * n * (2 if state else 1)
    n_ops = b * nc * 2 * q * q * n \
        + b * h * nc * (2 * q * q * p + 4 * q * n * p)
    return n_bytes, n_ops


def ssd_bwd_cost(xw, n: int, state: bool, dtype=torch.float32):
    """What kernel 6's backward needs for these inputs: xw, dy and dxw, B,
    C, dB, dC at ``dtype``, cum and dcum in fp32, each read or written once
    (with ``state`` also state0, the final state's gradient and dstate0,
    fp32); operations over
    the causal triangle: C Bᵀ (Q²·N) once per row and chunk, and per head
    dy·xw and the dxw product (Q²·P each), the dB and dC products (Q²·N
    each), and five P×N state products a row (the chunk's own state and
    gradient term, Sᵀ dy, G B and Gᵀ xw: 2·Q·P·N each)."""
    b, nc, q, h, p = xw.shape
    rows = b * nc * q
    n_bytes = esize(dtype) * (3 * rows * h * p + 4 * rows * n) \
        + 4 * (2 * rows * h + (3 * b * h * p * n if state else 0))
    n_ops = b * nc * (q * q * n + h * (2 * q * q * p + 2 * q * q * n
                                       + 10 * q * p * n))
    return n_bytes, n_ops


def rglru_cost(a, dtype, h0: bool = False):
    """What the recurrence needs: a and b read and y written at the dtype,
    h_T written in fp32 (with ``h0`` the starting state read too); one
    multiply and one add per element."""
    n = a.numel()
    return (3 * n * esize(dtype) + 4 * a.shape[0] * a.shape[2]
            * (2 if h0 else 1), 2 * n)


def rglru_bwd_cost(a, h0: bool, dtype=torch.float32):
    """Kernel 7's backward: a, y, dy read and da, db written at ``dtype``,
    the final state's gradient read in fp32 (with ``h0`` also h0 read and
    dh0 written); an add and two multiplies a step."""
    n = a.numel()
    return (5 * n * esize(dtype)
            + 4 * (3 if h0 else 1) * a.shape[0] * a.shape[2], 3 * n)


def bwd_cost(b, sq, sk, h, kh, d, causal, window, dtype=torch.float32):
    """The flash backward's bytes (q, o, dO, k, v read; dq, dk, dv
    written, at ``dtype``) and operations (:data:`BWD_OPS` times the
    forward's over the seen pairs)."""
    n_bytes = (4 * b * h * sq * d + 4 * b * kh * sk * d) * esize(dtype)
    _, fwd_ops = flash_cost(b, sq, torch.float32, h=h, kh=kh, d=d,
                            window=window, causal=causal, sk=sk)
    return n_bytes, BWD_OPS * fwd_ops


# ---------------------------------------------------------------------------
# Prices of a wrapper's call, from its own arguments (kernel layouts):
# (bytes, operations, dtype)
# ---------------------------------------------------------------------------

def flash_price(q, k, causal, window, group, q_offset=0):
    """Kernel 1 on q (BH, Sq, D), k (BH/group, Sk, D)."""
    bh, sq, d = q.shape
    return (*flash_cost(1, sq, q.dtype, h=bh, kh=bh // group, d=d,
                        window=window, causal=causal, sk=k.shape[1],
                        q_offset=q_offset), q.dtype)


def flash_bwd_price(q, k, causal, window, group):
    """Kernel 1's backward on q (BH, Sq, D), k (BH/group, Sk, D)."""
    bh, sq, d = q.shape
    return (*bwd_cost(1, sq, k.shape[1], bh, bh // group, d, causal,
                      window, q.dtype), q.dtype)


def paged_price(q, pos, k_pages, block_tables):
    """Kernel 2 on q (B, K, G, D) over pages (P+1, ps, K, D)."""
    return (*decode_cost(q, pos, q.dtype, k_pages.shape[1],
                         block_tables.shape[1]), q.dtype)


def dense_price(q, kv_positions, pos):
    """Kernel 4 on q (B, K, G, D) over the slot cache's kv_positions."""
    return (*dense_cost(q, kv_positions, pos, q.dtype), q.dtype)


def _fused(prefill, decode):
    return prefill[0] + decode[0], prefill[1] + decode[1], prefill[2]


def bullet_paged_price(qp, kp, causal, window, group, qd, pos, k_pages,
                       block_tables):
    """Kernel 3: its prefill side (kernel 1) plus its paged decode side
    (kernel 2)."""
    return _fused(flash_price(qp, kp, causal, window, group),
                  paged_price(qd, pos, k_pages, block_tables))


def bullet_price(qp, kp, causal, window, group, qd, kv_positions, pos):
    """Kernel 5: its prefill side (kernel 1) plus its dense decode side
    (kernel 4)."""
    return _fused(flash_price(qp, kp, causal, window, group),
                  dense_price(qd, kv_positions, pos))


def ssd_price(xw, B_, state0):
    """Kernel 6 on xw (B, NC, Q, H, P), B (B, NC, Q, N)."""
    return (*ssd_cost(xw, xw.dtype, B_.shape[-1], state0 is not None),
            xw.dtype)


def ssd_bwd_price(xw, B_, state0):
    """Kernel 6's backward."""
    return (*ssd_bwd_cost(xw, B_.shape[-1], state0 is not None, xw.dtype),
            xw.dtype)


def rglru_price(a, h0):
    """Kernel 7 on a (B, S, W)."""
    return (*rglru_cost(a, a.dtype, h0 is not None), a.dtype)


def rglru_bwd_price(a, h0):
    """Kernel 7's backward."""
    return (*rglru_bwd_cost(a, h0 is not None, a.dtype), a.dtype)
