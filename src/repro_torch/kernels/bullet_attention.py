"""Bullet fused prefill+decode attention: the wrappers of the CUDA kernels
``bullet_attention_paged_fwd`` (decode over the page pool) and
``bullet_attention_fwd`` (decode over a dense per-slot cache) in
``csrc/attention.cu``, their launch counters, their plain PyTorch versions
and the Python mirror of their schedule.

They replace the TPU kernels ``src/repro/kernels/bullet_attention.py:260``
(``bullet_attention_paged``) and ``src/repro/kernels/bullet_attention.py:361``
(``bullet_attention``). On the TPU the two tile streams were
Bresenham-interleaved in one sequential grid by ``decode_share``, the
leftovers of either stream appended. On Hopper one persistent launch holds
as many CTAs as the card runs at once (SMs × CTAs per SM at the kernel's
registers and shared memory), and ``decode_share`` is a share of the SMs:
each CTA reads its SM's id (``%smid``), the SMs are ranked in the order
their first CTA arrives, and the ``n_dec_sm = round(decode_share·n_SM)``
SMs of lowest rank (clamped to [1, n_SM−1] while both phases have work,
``decode_sms``) take decode items, the others prefill items first. Each
phase's items come from one atomic queue. A decode SM's CTA leaves once
the decode queue is empty; a prefill SM's CTA takes decode leftovers once
the prefill queue is empty; and the grid holds, beyond one wave, as many
CTAs as the decode SMs hold (``grid``), which start in the slots the
leaving decode CTAs free and take prefill leftovers. So no slot idles
while work is queued, and no CTA runs the bf16 prefill body after a
decode body (their registers would not fit the kernel's 128). Prefill
tickets walk the query tiles heaviest first (``prefill_order``), and the
CTAs on an SM take that queue's heavy and light end in turn, so the
longest causal tiles start first and not two on one SM. The queues'
counters live in a workspace kept per (device, stream), zero at launch
and left zero by the launch's last CTA. The per-item bodies are the standalone kernels' device functions, so
the outputs equal ``flash_attention`` + ``paged_decode_attention`` (or +
``decode_attention``) bit for bit, whichever CTA ran an item: either
variant's decode items are the standalone split launch's (slot, kv head,
piece) items in both dtypes (both size it with
``decode_attention.split_workspace``).
With ``record=True`` a launch also returns a :class:`Schedule`: which SM
ran each item, and from which queue. The dense variant has no serving path
(the engine runs fused cycles on the paged pool only, as the JAX engine
does); ``chip_smoke.py``'s colocated phase drives it, as
``examples/colocated_attention.py`` drives the TPU kernel. Both are built
for head dims 64 and 128 (``build.PAGED_HEAD_DIMS``): the paged path
serves Granite's D = 64 and the D = 128 models.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (_check_dense, sm_count,
                                                  split_workspace)
from repro_torch.kernels.geometry import SCHED_WORDS
from repro_torch.kernels.paged_decode_attention import _check_decode

#: launches of the paged / the dense fused kernel since the counters were
#: last reset (plain integers)
launches = 0
dense_launches = 0

#: the plain versions: the two phases back to back (ref.py)
bullet_attention_paged_plain = ref.bullet_attention_paged_ref
bullet_attention_plain = ref.bullet_attention_ref

#: (query rows, keys) per tile of the prefill bodies, by dtype code:
#: ``flash_rt_item``'s FQ, FK in fp32 and ``flash_tc_item``'s TC_BQ, TC_BK
#: in bf16 (``csrc/attention.cuh``)
FLASH_TILES = {0: (64, 64), 1: (128, 64)}

#: ints the record holds per ticket (``REC`` in ``csrc/attention.cu``)
RECORD_INTS = 7

@functools.lru_cache(maxsize=None)
def grid_ctas(device_index: int, dtype_code: int, d: int, g: int,
              ps: int, dense: bool = False) -> int:
    """One wave of the persistent launch on a device: its SMs times the
    CTAs of the kernel one SM holds at once (so prefill items run at the
    standalone flash kernel's occupancy; ``grid`` adds the CTAs that take
    prefill leftovers on decode SMs). ``dense`` sizes the dense-cache
    variant (``ps`` is then unused)."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = build.library().bullet_ctas_per_sm(d, dtype_code, g, ps,
                                                int(dense),
                                                ctypes.byref(per_sm))
    build.check(rc, "bullet_attention")
    n_sm = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    return n_sm * max(per_sm.value, 1)


def grid(n_ctas: int, n_sm: int, n_dec_sm: int, has_prefill: bool) -> int:
    """CTAs of a fused launch: the ``n_ctas`` the card runs at once and,
    while prefill has work, as many again as the ``n_dec_sm`` decode SMs
    hold, to take prefill leftovers in the slots the decode CTAs free."""
    return n_ctas + (n_dec_sm * (n_ctas // n_sm) if has_prefill else 0)


def decode_sms(decode_share: float, n_sm: int, has_prefill: bool,
               has_decode: bool) -> int:
    """SMs of the persistent launch that take decode items first: the share
    ``decode_share`` of its ``n_sm``, each phase with work keeping at least
    one SM, a phase without work none."""
    if not has_decode:
        return 0
    if not has_prefill:
        return n_sm
    return min(max(math.floor(decode_share * n_sm + 0.5), 1), n_sm - 1)


def key_tiles(qt: int, s: int, causal: bool, window: int, bq: int,
              bk: int) -> int:
    """Key tiles that query tile ``qt`` (of ``bq`` rows, over ``s`` queries
    and keys) attends in tiles of ``bk`` keys: the range the prefill bodies
    walk."""
    q0 = qt * bq
    q_hi = min(q0 + bq, s) - 1
    n_kt = -(-s // bk)
    lo = max(0, q0 - window + 1) // bk if window > 0 else 0
    hi = min(n_kt, q_hi // bk + 1) if causal else n_kt
    return max(0, hi - lo)


@functools.lru_cache(maxsize=None)
def prefill_lift(s: int, causal: bool, window: int, bq: int, bk: int) -> int:
    """Where the fused kernel's prefill order puts the first query tile of
    its base order (causal: the last tile first, else the first first).
    Every later tile of the base order attends no more key tiles than the
    one before it; only the first can attend fewer than some of them (a
    causal window's last tile, cut short by S), and the lift is how many
    of them do."""
    n_qt = -(-s // bq)
    base = range(n_qt - 1, -1, -1) if causal else range(n_qt)
    first = key_tiles(base[0], s, causal, window, bq, bk) if n_qt else 0
    lift = 0
    for qt in base[1:]:
        if key_tiles(qt, s, causal, window, bq, bk) <= first:
            break
        lift += 1
    return lift


def prefill_order(bh: int, s: int, causal: bool = True, window: int = 0,
                  dtype_code: int = 1) -> list:
    """The (head, query tile) of each prefill ticket of a fused launch over
    ``bh`` heads of ``s`` queries, in ticket order: the query tiles by the
    key tiles they attend, most first, heads inner. The kernel computes
    the same map (``prefill_item`` in ``csrc/attention.cu``) from the
    lift."""
    bq, bk = FLASH_TILES[dtype_code]
    n_qt = -(-s // bq)
    lift = prefill_lift(s, causal, window, bq, bk)
    order = []
    for r in range(n_qt):
        j = r + 1 if r < lift else (0 if r == lift else r)
        qt = n_qt - 1 - j if causal else j
        order += [(h, qt) for h in range(bh)]
    return order


class Schedule(NamedTuple):
    """What one fused launch ran where (``record=True``). ``record`` (n_dec
    + prefill items, RECORD_INTS) int32 holds, per ticket (the decode
    queue's first, then the prefill queue's in ``prefill_order``): how
    often it was taken, the body's item, the ``%smid`` that ran it, that
    SM's rank, 1 if it came from the CTA's own queue, and the low 32 bits
    of the card's ``%globaltimer`` (ns) when it was taken and when its CTA
    asked for its next item (its end)."""
    n_sm: int
    n_dec_sm: int
    n_dec: int
    record: torch.Tensor


#: the schedule workspaces of the fused launches, per (device, stream):
#: zero between launches (the last CTA of each launch zeroes it again)
_SCHED: dict = {}


def _sched_workspace(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    ws = _SCHED.get(key)
    if ws is None:
        ws = _SCHED[key] = torch.zeros(SCHED_WORDS, dtype=torch.int32,
                                       device=device)
    return ws


def _schedule(qp, stream, code: int, n_ctas: int, n_dec: int,
              has_decode: bool, decode_share: float, causal: bool,
              window: int, record: bool):
    """The schedule arguments of a fused launch on ``stream`` (the C
    pointer of its current stream) whose one wave is ``n_ctas`` CTAs:
    (grid, workspace, record or None, n_dec_sm, lift) and the
    :class:`Schedule` to return (or None)."""
    bh, sp, _ = qp.shape
    bq, bk = FLASH_TILES[code]
    n_pre = bh * -(-sp // bq)
    n_sm = sm_count(qp.device.index if qp.device.index is not None
                    else torch.cuda.current_device())
    n_dec_sm = decode_sms(decode_share, n_sm, qp.numel() > 0, has_decode)
    rec = (torch.zeros(n_dec + n_pre, RECORD_INTS, dtype=torch.int32,
                       device=qp.device) if record else None)
    sched = Schedule(n_sm, n_dec_sm, n_dec, rec) if record else None
    return ((grid(n_ctas, n_sm, n_dec_sm, qp.numel() > 0),
             _sched_workspace(qp.device, stream.value or 0), rec, n_dec_sm,
             prefill_lift(sp, bool(causal), int(window), bq, bk)), sched)


def bullet_attention_paged(qp, kp, vp, qd, k_pages, v_pages, block_tables,
                           pos, *, decode_share: float = 0.5,
                           causal: bool = True, window: int = 0,
                           group: int = 1, record: bool = False):
    """Prefill: qp (BHp, Sp, D), kp/vp (BHp/group, Sp, D).
    Decode: qd (Bd, K, G, D), pages (P+1, ps, K, D), block_tables (Bd, n_b)
    int32, pos (Bd,) int32. Returns (out_p (BHp, Sp, D), out_d (Bd, K, G,
    D)), and with ``record`` the launch's :class:`Schedule` (None if no
    kernel was launched: CPU tensors, or no work).

    CUDA tensors launch the kernel; CPU tensors run the plain version;
    meta tensors get empty outputs (and no schedule)."""
    args = (qp, kp, vp, qd, k_pages, v_pages, block_tables, pos,
            decode_share, causal, window, group, record)
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("bullet_attention_paged", lambda: (
                cost.bullet_paged_price(qp, kp, causal, window, group, qd,
                                        pos, k_pages, block_tables))):
            return _dispatch_paged(*args)
    return _dispatch_paged(*args)


def _dispatch_paged(qp, kp, vp, qd, k_pages, v_pages, block_tables, pos,
                    decode_share, causal, window, group, record):
    if qp.device.type == "cpu":
        out = bullet_attention_paged_plain(
            qp, kp, vp, qd, k_pages, v_pages, block_tables, pos,
            causal=causal, window=window, group=group)
        return (*out, None) if record else out
    build.refuse_grad("bullet_attention_paged",
                      (qp, kp, vp, qd, k_pages, v_pages), "ROADMAP §2 R19")
    code = build.check_inputs("bullet_attention_paged",
                              (qp, kp, vp, qd, k_pages, v_pages),
                              (block_tables, pos),
                              head_dims=build.PAGED_HEAD_DIMS)
    bh, sp, d = qp.shape
    if (kp.shape != vp.shape or kp.shape[0] * group != bh
            or kp.shape[1] != sp or kp.shape[2] != d):
        raise ValueError(f"bullet_attention_paged: qp {tuple(qp.shape)}, "
                         f"kp {tuple(kp.shape)}, vp {tuple(vp.shape)}, "
                         f"group {group}")
    _check_decode("bullet_attention_paged", qd, k_pages, v_pages,
                  block_tables, pos)
    b, kh, g, _ = qd.shape
    ps, n_b = k_pages.shape[1], block_tables.shape[1]
    out_p = torch.empty_like(qp)
    out_d = torch.empty_like(qd)
    if (out_p.numel() == 0 and out_d.numel() == 0) or qp.is_meta:
        return (out_p, out_d, None) if record else (out_p, out_d)
    build.check_aligned("bullet_attention_paged",
                        (qp, kp, vp, qd, k_pages, v_pages))
    # the standalone paged decode's pieces, so the outputs stay equal
    n_split, *ws = split_workspace(qd, n_b * ps, paged=True)
    n_ctas = grid_ctas(qp.device.index if qp.device.index is not None
                       else torch.cuda.current_device(), code, d, g, ps)
    stream = build.stream_of(qp)
    (n_grid, sws, rec, n_dec_sm, lift), sched = _schedule(
        qp, stream, code, n_ctas, b * kh * n_split, out_d.numel() > 0,
        decode_share, causal, window, record)
    rc = build.library().bullet_attention_paged_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out_p.data_ptr(),
        bh, sp, group, int(causal), int(window),
        qd.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out_d.data_ptr(),
        *(None if t is None else t.data_ptr() for t in ws),
        b, kh, g, ps, n_b, d, code, n_split, n_grid, sws.data_ptr(),
        None if rec is None else rec.data_ptr(), n_dec_sm, lift, stream)
    build.check(rc, "bullet_attention_paged")
    global launches
    launches += 1
    return (out_p, out_d, sched) if record else (out_p, out_d)


def bullet_attention(qp, kp, vp, qd, k_cache, v_cache, kv_positions, pos, *,
                     decode_share: float = 0.5, causal: bool = True,
                     window: int = 0, group: int = 1, record: bool = False):
    """Prefill: qp (BHp, Sp, D), kp/vp (BHp/group, Sp, D).
    Decode: qd (Bd, K, G, D), caches (Bd, Sk, K, D), kv_positions (Bd, Sk)
    int32, pos (Bd,) int32. Returns (out_p (BHp, Sp, D), out_d (Bd, K, G,
    D)), and with ``record`` the launch's :class:`Schedule` (None if no
    kernel was launched: CPU tensors, or no work).

    CUDA tensors launch the kernel; CPU tensors run the plain version;
    meta tensors get empty outputs (and no schedule)."""
    args = (qp, kp, vp, qd, k_cache, v_cache, kv_positions, pos,
            decode_share, causal, window, group, record)
    if cost.COUNTER is not None:
        with cost.COUNTER.kernel("bullet_attention", lambda: (
                cost.bullet_price(qp, kp, causal, window, group, qd,
                                  kv_positions, pos))):
            return _dispatch_dense(*args)
    return _dispatch_dense(*args)


def _dispatch_dense(qp, kp, vp, qd, k_cache, v_cache, kv_positions, pos,
                    decode_share, causal, window, group, record):
    if qp.device.type == "cpu":
        out = bullet_attention_plain(
            qp, kp, vp, qd, k_cache, v_cache, kv_positions, pos,
            causal=causal, window=window, group=group)
        return (*out, None) if record else out
    build.refuse_grad("bullet_attention",
                      (qp, kp, vp, qd, k_cache, v_cache), "ROADMAP §2 R19")
    code = build.check_inputs("bullet_attention",
                              (qp, kp, vp, qd, k_cache, v_cache),
                              (kv_positions, pos),
                              head_dims=build.PAGED_HEAD_DIMS)
    bh, sp, d = qp.shape
    if (kp.shape != vp.shape or kp.shape[0] * group != bh
            or kp.shape[1] != sp or kp.shape[2] != d):
        raise ValueError(f"bullet_attention: qp {tuple(qp.shape)}, "
                         f"kp {tuple(kp.shape)}, vp {tuple(vp.shape)}, "
                         f"group {group}")
    _check_dense("bullet_attention", qd, k_cache, v_cache, kv_positions, pos)
    b, kh, g, _ = qd.shape
    s = k_cache.shape[1]
    out_p = torch.empty_like(qp)
    out_d = torch.empty_like(qd)
    if (out_p.numel() == 0 and out_d.numel() == 0) or qp.is_meta:
        return (out_p, out_d, None) if record else (out_p, out_d)
    build.check_aligned("bullet_attention",
                        (qp, kp, vp, qd, k_cache, v_cache))
    # the standalone dense decode's pieces, so the outputs stay equal
    n_split, *ws = split_workspace(qd, s)
    n_ctas = grid_ctas(qp.device.index if qp.device.index is not None
                       else torch.cuda.current_device(), code, d, g, 0,
                       dense=True)
    stream = build.stream_of(qp)
    (n_grid, sws, rec, n_dec_sm, lift), sched = _schedule(
        qp, stream, code, n_ctas, b * kh * n_split, out_d.numel() > 0,
        decode_share, causal, window, record)
    rc = build.library().bullet_attention_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out_p.data_ptr(),
        bh, sp, group, int(causal), int(window),
        qd.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_positions.data_ptr(), pos.data_ptr(), out_d.data_ptr(),
        *(None if t is None else t.data_ptr() for t in ws),
        b, kh, g, s, d, code, n_split, n_grid, sws.data_ptr(),
        None if rec is None else rec.data_ptr(), n_dec_sm, lift, stream)
    build.check(rc, "bullet_attention")
    global dense_launches
    dense_launches += 1
    return (out_p, out_d, sched) if record else (out_p, out_d)
