"""The fused kernels' schedule, on the CPU: the Python mirror of the order
in which prefill tickets map to query tiles (``prefill_order``, which the
kernel's ``prefill_item`` computes alike; the card tests hold the two
equal through the launch's record) and the SM split ``decode_sms``.

The weights here are counted from the attention mask itself, tile by
tile, independently of the mirror's ``key_tiles``. The JAX package's
schedule (``build_schedule``) is held beside the port's split: both hand
decode its share while both phases have work and never drop an item."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.kernels.bullet_attention import build_schedule
from repro_torch.kernels import build, geometry
from repro_torch.kernels import bullet_attention as TB

MODES = {"causal": (True, 0), "full": (False, 0), "window 17": (True, 17),
         "window 256": (True, 256), "window 1000": (True, 1000),
         "full, window 256": (False, 256)}


def _mask_tiles(s, causal, window, bq, bk):
    """Key tiles each query tile attends with any of its rows, from the
    (s, s) mask."""
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    m = np.ones((s, s), bool)
    if causal:
        m &= k <= q
    if window > 0:
        m &= k > q - window
    n_qt, n_kt = -(-s // bq), -(-s // bk)
    pad = np.zeros((n_qt * bq, n_kt * bk), bool)
    pad[:s, :s] = m
    return pad.reshape(n_qt, bq, n_kt, bk).any(axis=(1, 3)).sum(axis=1)


@pytest.mark.parametrize("dtype_code", [0, 1], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("s", [1, 127, 128, 1000, 3000])
def test_prefill_order_walks_every_tile_heaviest_first(s, mode, dtype_code):
    causal, window = MODES[mode]
    bh = 3
    bq, bk = TB.FLASH_TILES[dtype_code]
    order = TB.prefill_order(bh, s, causal, window, dtype_code)
    n_qt = -(-s // bq)
    assert sorted(order) == [(h, qt) for h in range(bh)
                             for qt in range(n_qt)]
    tiles = _mask_tiles(s, causal, window, bq, bk)
    w = [tiles[qt] for _, qt in order]
    assert all(a >= b for a, b in zip(w, w[1:])), w
    # the mirror's count is the mask's
    assert [TB.key_tiles(qt, s, causal, window, bq, bk)
            for qt in range(n_qt)] == tiles.tolist()


def test_prefill_order_lifts_a_last_tile_the_window_cuts_short():
    """S = 3000, window 256, bf16: the last query tile (56 rows) attends 5
    key tiles where the full tiles before it attend 6, so it runs after
    them."""
    order = TB.prefill_order(1, 3000, True, 256, 1)
    qts = [qt for _, qt in order]
    assert TB.prefill_lift(3000, True, 256, 128, 64) == 21
    assert qts[:21] == list(range(22, 1, -1))
    assert qts[21] == 23
    assert qts[22:] == [1, 0]


@pytest.mark.parametrize("share,has_prefill,has_decode,want", [
    (0.5, True, True, 66),        # the cases of test_decode_ctas_split_the_sms
    (20 / 132, True, True, 20),
    (0.0, True, True, 1),
    (1.0, True, True, 131),
    (0.3, False, True, 132),
    (0.3, True, False, 0),
    (0.0, False, True, 132),      # no work in a phase: none of the SMs
    (1.0, True, False, 0),
    (0.5, False, False, 0),
])
def test_decode_sms(share, has_prefill, has_decode, want):
    assert TB.decode_sms(share, 132, has_prefill, has_decode) == want


@pytest.mark.parametrize("share", [0.0, 0.25, 0.5, 0.75, 1.0])
def test_decode_sms_follow_the_jax_schedules_share(share):
    """The JAX kernel hands decode ``decode_share`` of its grid slots while
    both streams have tiles, the port ``decode_share`` of its SMs (at least
    one for each phase with work); both run every tile of either phase."""
    n_p, n_d = 128, 256
    phase = build_schedule(n_p, n_d, share)
    assert int((phase == 0).sum()) == n_p and int((phase == 1).sum()) == n_d
    both = np.arange(len(phase)) <= min(np.flatnonzero(phase == 0)[-1],
                                        np.flatnonzero(phase == 1)[-1])
    jax_share = float(phase[both].mean())
    n_sm = 132
    port = TB.decode_sms(share, n_sm, True, True) / n_sm
    # each rounds once: the port to a whole SM, the JAX schedule to a slot
    assert abs(port - jax_share) <= 1 / n_sm + 1 / both.sum()


def test_schedule_geometry_is_stated_once():
    """The schedule workspace's SM slots come from geometry.py: the CUDA
    source states no value of its own (attention.cu refuses to compile
    without the define), nvcc gets it, and the wrapper's workspace is
    sized from the same module."""
    src = (build.CSRC / "attention.cu").read_text()
    cmd = build.compile_command("nvcc", "attention.cu", "attention.o")
    for name, value in geometry.SCHED_DEFINES.items():
        assert not re.search(rf"#\s*define\s+{name}\b", src), name
        assert f"!defined({name})" in src, name
        assert f"-D{name}={value}" in cmd, name
    assert TB.SCHED_WORDS == geometry.SCHED_WORDS == 8 + 2 * \
        geometry.SCHED_SMS


@pytest.mark.parametrize("n_dec_sm,has_prefill,want", [
    (66, True, 264 + 132),     # a decode SM's two slots refilled once each
    (131, True, 264 + 262),
    (0, True, 264),            # no decode SM: one wave
    (132, False, 264),         # no prefill work: nothing to take over
])
def test_grid_adds_the_decode_sms_slots(n_dec_sm, has_prefill, want):
    """One wave of 2 CTAs on each of 132 SMs, and while prefill has work as
    many more as the decode SMs hold: they take the prefill leftovers in
    the slots the leaving decode CTAs free."""
    assert TB.grid(264, 132, n_dec_sm, has_prefill) == want


def _smoke():
    """The repo root's chip_smoke.py as a module (its gates run on any
    tensor; only its main needs a card)."""
    path = pathlib.Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(**bad):
    """A fused launch's record (``bullet_attention.Schedule``) on 4 SMs,
    2 of them decode SMs, 4 decode and 4 prefill tickets: SM ids 10, 3 of
    rank 0, 1 (decode), 7, 5 of rank 2, 3 (prefill); one decode item taken
    by a prefill SM and one prefill item by a decode SM, each from the
    other queue, as the work-conserving launch does. ``bad`` names one
    fault to put in it."""
    rank = {10: 0, 3: 1, 7: 2, 5: 3}
    # (ticket, smid, from the CTA's own queue)
    runs = [(0, 10, 1), (1, 3, 1), (2, 10, 1), (3, 7, 0),
            (4, 7, 1), (5, 5, 1), (6, 3, 0), (7, 5, 1)]
    rec = np.zeros((8, TB.RECORD_INTS), np.int32)
    for t, smid, own in runs:
        rec[t, :5] = (1, t, smid, rank[smid], own)
    if "twice" in bad:
        rec[6, 0] = 2
    if "never" in bad:
        rec[6, 0] = 0
    if "two_ranks" in bad:
        rec[2, 3] = 1           # SM 10 also read as rank 1
    if "decode_on_prefill_sm" in bad:
        rec[3, 4] = 1           # SM 7 (rank 2) took decode as its own
    if "prefill_on_decode_sm" in bad:
        rec[6, 4] = 1           # SM 3 (rank 1) took prefill as its own
    return TB.Schedule(4, 2, 4, torch.from_numpy(rec))


def test_smoke_partition_gate_reads_a_good_record():
    """chip_smoke.py's gate on a launch's record passes one that shows the
    partition, leftovers taken from the other queue included, and says so."""
    got = _smoke().schedule_gate(_record(), "case")
    assert got.startswith("2 SMs took decode items from their own queue "
                          "(n_dec_sm 2 of 4), 2 prefill; 1 of 4 decode and "
                          "1 of 4 prefill items taken from the other queue")


@pytest.mark.parametrize("fault", ["twice", "never", "two_ranks",
                                   "decode_on_prefill_sm",
                                   "prefill_on_decode_sm"])
def test_smoke_partition_gate_fails_a_broken_record(fault):
    """The same gate exits non-zero on each way a record can break the
    partition: an item run twice or never, an SM with two ranks, decode
    items from the decode queue on a prefill SM, prefill items from the
    prefill queue on a decode SM."""
    with pytest.raises(SystemExit) as e:
        _smoke().schedule_gate(_record(**{fault: True}), "case")
    assert e.value.code == 1
