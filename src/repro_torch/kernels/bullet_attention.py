"""Bullet fused prefill+decode attention: the wrapper of the CUDA kernel
``bullet_attention_paged_fwd`` (``csrc/attention.cu``), its launch counter
and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/bullet_attention.py:260``
(``bullet_attention_paged``). On the TPU the two tile streams were
Bresenham-interleaved in one sequential grid by ``decode_share``. On
Hopper one persistent launch holds as many CTAs as the card runs at once
(SMs × CTAs per SM at the kernel's registers and shared memory), of which
``n_dec = round(decode_share·n_ctas)`` (clamped to [1, n_ctas−1] while
both phases have work) loop over the decode work items (slot, kv head) and
the rest over the prefill items (bh, query tile). ``decode_share`` is thus
a share of the launch's CTAs; the hardware places them, and nothing pins
the decode CTAs to particular SMs, so it is the paper's SM partition only
as far as every SM holds the same number of CTAs. The per-item bodies are
the standalone kernels' device functions, so the outputs equal
``flash_attention`` + ``paged_decode_attention`` bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.paged_decode_attention import _check_decode

#: kernel launches since the counter was last reset (plain integer)
launches = 0

#: the plain version: the two phases back to back (ref.py)
bullet_attention_paged_plain = ref.bullet_attention_paged_ref


@functools.lru_cache(maxsize=None)
def grid_ctas(device_index: int, dtype_code: int, d: int, g: int,
              ps: int) -> int:
    """The persistent launch's grid on a device: its SMs times the CTAs of
    the kernel one SM holds at once (so prefill items run at the
    standalone flash kernel's occupancy)."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = build.library().bullet_ctas_per_sm(d, dtype_code, g, ps,
                                                ctypes.byref(per_sm))
    build.check(rc, "bullet_attention_paged")
    n_sm = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    return n_sm * max(per_sm.value, 1)


def decode_ctas(decode_share: float, n_ctas: int, has_prefill: bool,
                has_decode: bool) -> int:
    """CTAs of the persistent launch that take decode items: the share
    ``decode_share`` of its ``n_ctas``, each phase with work keeping at
    least one CTA, a phase without work none."""
    if not has_decode:
        return 0
    if not has_prefill:
        return n_ctas
    return min(max(math.floor(decode_share * n_ctas + 0.5), 1), n_ctas - 1)


def bullet_attention_paged(qp, kp, vp, qd, k_pages, v_pages, block_tables,
                           pos, *, decode_share: float = 0.5,
                           causal: bool = True, window: int = 0,
                           group: int = 1):
    """Prefill: qp (BHp, Sp, D), kp/vp (BHp/group, Sp, D).
    Decode: qd (Bd, K, G, D), pages (P+1, ps, K, D), block_tables (Bd, n_b)
    int32, pos (Bd,) int32. Returns (out_p (BHp, Sp, D), out_d (Bd, K, G,
    D)).

    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    if qp.device.type == "cpu":
        return bullet_attention_paged_plain(
            qp, kp, vp, qd, k_pages, v_pages, block_tables, pos,
            causal=causal, window=window, group=group)
    code = build.check_inputs("bullet_attention_paged",
                              (qp, kp, vp, qd, k_pages, v_pages),
                              (block_tables, pos))
    bh, sp, d = qp.shape
    if (kp.shape != vp.shape or kp.shape[0] * group != bh
            or kp.shape[1] != sp or kp.shape[2] != d):
        raise ValueError(f"bullet_attention_paged: qp {tuple(qp.shape)}, "
                         f"kp {tuple(kp.shape)}, vp {tuple(vp.shape)}, "
                         f"group {group}")
    _check_decode("bullet_attention_paged", qd, k_pages, v_pages,
                  block_tables, pos)
    b, kh, g, _ = qd.shape
    out_p = torch.empty_like(qp)
    out_d = torch.empty_like(qd)
    if out_p.numel() == 0 and out_d.numel() == 0:
        return out_p, out_d
    n_ctas = grid_ctas(qp.device.index if qp.device.index is not None
                       else torch.cuda.current_device(), code, d, g,
                       k_pages.shape[1])
    n_dec = decode_ctas(decode_share, n_ctas, out_p.numel() > 0,
                        out_d.numel() > 0)
    rc = build.library().bullet_attention_paged_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out_p.data_ptr(),
        bh, sp, group, int(causal), int(window),
        qd.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out_d.data_ptr(),
        b, kh, g, k_pages.shape[1], block_tables.shape[1], d, code,
        n_dec, n_ctas, build.stream_of(qp))
    build.check(rc, "bullet_attention_paged")
    global launches
    launches += 1
    return out_p, out_d
