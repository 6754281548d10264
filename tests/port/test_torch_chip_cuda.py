"""Chip granularity on the card (marked ``cuda``; they skip without one).
The file imports no JAX, so it loads on a host without it;
``test_torch_submesh.py`` holds the chip engine against the JAX package on
the CPU.

- ``transfer_pages`` on two streams of one card (the prefill side's and
  the decode side's, as the engine runs it) moves exactly the named pages,
  bit for bit, behind prefill work still queued on the prefill side's
  stream, and leaves every other page as it was.
- Reduced Qwen3-1.7B's chip engine over the group ``("cuda:0",
  "cuda:0")``, fp32: token streams equal to the tile (fused) engine's on
  the card and to the chip engine's on the CPU over ``("cpu", "cpu")``,
  with the same chip cycles and handoffs; one handoff per request, no
  graph dropped or captured twice, the staging pool apart from the decode
  pool.
- On a host with two or more cards (they skip on one): the page copy
  from one card to another on each card's stream, and the chip engine
  over two distinct cards and over every card, ``"chip"`` and ``"auto"``
  (the decode pool re-homed to the decode side's card, and under
  ``"auto"`` back for tile cycles, its graphs dropped and captured again),
  its streams equal to the tile engine's and its counters to the CPU's
  over as many entries."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.config import ControlConfig, ExecConfig, ServerConfig
from repro_torch.core.engine import BulletServer
from repro_torch.core.estimator import (EstimatorParams, HardwareSpec,
                                        PerfEstimator)
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.kvcache.paged import transfer_pages
from repro_torch.models import transformer as T
from repro_torch.serving.request import SLO, Request


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_transfer_pages_on_two_streams_of_one_card(card):
    cfg = get_config("qwen3-1.7b").reduced(n_layers=4)
    src = T.init_paged_cache(cfg, 64, 16, torch.bfloat16, "cuda")
    dst = T.init_paged_cache(cfg, 64, 16, torch.bfloat16, "cuda")
    for t in [t for e in dst["blocks"] for t in e.values()]:
        t.copy_(torch.randn(t.shape, generator=card, device="cuda"))
    before = [t.clone() for e in dst["blocks"] for t in e.values()]
    p_stream, d_stream = torch.cuda.Stream(), torch.cuda.Stream()
    blocks = [3, 17, 40, 41, 63]
    with torch.cuda.stream(p_stream):
        # prefill work still queued when the handoff is: the copy must
        # come after it
        torch.cuda._sleep(2_000_000)
        for t in [t for e in src["blocks"] for t in e.values()]:
            t.copy_(torch.randn(t.shape, generator=card, device="cuda"))
    transfer_pages(src, dst, blocks, torch.device("cuda:0"),
                   streams=(p_stream, d_stream))
    torch.cuda.current_stream().wait_stream(d_stream)
    idx = torch.tensor(blocks, device="cuda")
    rest = torch.tensor([b for b in range(65) if b not in blocks],
                        device="cuda")
    got = [t for e in dst["blocks"] for t in e.values()]
    want = [t for e in src["blocks"] for t in e.values()]
    for g, w, b in zip(got, want, before):
        assert torch.equal(g.index_select(1, idx), w.index_select(1, idx))
        assert torch.equal(g.index_select(1, rest), b.index_select(1, rest))


def _cpu(params):
    return {k: (tuple({n: t.cpu() for n, t in b.items()} for b in v)
                if k == "blocks" else v.cpu()) for k, v in params.items()}


def _serve(cfg, params, device, regime=None, **ex):
    hw, par = regime or ({}, {})
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=PerfEstimator(HardwareSpec(
            n_chips=len(ex.get("devices") or (0, 0)), units_per_chip=8,
            grid_slots=8, **hw), EstimatorParams(**par)),
        max_slots=4, max_len=96, max_prefill_batch=1,
        execution=ExecConfig(**ex),
        control=ControlConfig(sched=SchedulerConfig(
            max_decode_pause_cycles=0))), device=device)
    rng = np.random.default_rng(7)
    for rid in range(6):
        plen = int(rng.integers(8, 60))
        server.submit(Request(rid=rid, arrival=0.0, prompt_len=plen,
                              output_len=10),
                      rng.integers(0, cfg.vocab_size, plen))
    now = 0.0
    while not server.idle:
        server.step(now)
        server.check_invariants()
        now += 1e-3
    return server


@pytest.mark.cuda
def test_chip_engine_on_one_card_named_twice(card):
    cfg = get_config("qwen3-1.7b").reduced(n_layers=4, head_dim=128)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    chip = _serve(cfg, params, "cuda", partition="chip",
                  devices=("cuda:0", "cuda:0"))
    tile = _serve(cfg, params, "cuda")
    host = _serve(cfg, _cpu(params), "cpu", partition="chip",
                  devices=("cpu", "cpu"))
    assert chip.outputs == tile.outputs == host.outputs
    st, hst = chip.stats, host.stats
    assert (st.chip_cycles, st.handoffs) == (hst.chip_cycles, hst.handoffs)
    assert st.chip_cycles > 0 and st.handoffs == 6 and st.fused_cycles == 0
    assert chip.pool.free_blocks == chip.pool.n_blocks
    for g in (chip.graphs, chip.graphs_p):
        keys = [k for k, _ in g.captures]
        assert g.dropped == 0 and len(keys) == len(set(keys))
    assert {k[0] for k, _ in chip.graphs_p.captures} == {"c_group",
                                                        "c_final"}
    leaves = [t.data_ptr() for e in chip.cache["blocks"] for t in e.values()]
    staged = [t.data_ptr() for e in chip.cache_p["blocks"]
              for t in e.values()]
    assert not set(leaves) & set(staged)


@pytest.fixture
def cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    return torch.cuda.device_count()


@pytest.mark.cuda
def test_transfer_pages_between_two_cards(cards):
    cfg = get_config("qwen3-1.7b").reduced(n_layers=4)
    gen = torch.Generator().manual_seed(3)
    src = T.init_paged_cache(cfg, 32, 16, torch.bfloat16, "cuda:0")
    dst = T.init_paged_cache(cfg, 32, 16, torch.bfloat16, "cuda:1")
    for t in [t for e in (src, dst) for b in e["blocks"] for t in b.values()]:
        t.copy_(torch.randn(t.shape, generator=gen))
    before = [t.cpu() for b in dst["blocks"] for t in b.values()]
    streams = (torch.cuda.Stream(torch.device("cuda:0")),
               torch.cuda.Stream(torch.device("cuda:1")))
    blocks = [0, 5, 31, 32]
    transfer_pages(src, dst, blocks, torch.device("cuda:1"),
                   streams=streams)
    torch.cuda.synchronize("cuda:0")
    torch.cuda.synchronize("cuda:1")
    rest = [b for b in range(33) if b not in blocks]
    for g, w, b in zip([t.cpu() for e in dst["blocks"] for t in e.values()],
                       [t.cpu() for e in src["blocks"] for t in e.values()],
                       before):
        assert torch.equal(g[:, blocks], w[:, blocks])
        assert torch.equal(g[:, rest], b[:, rest])


@pytest.mark.cuda
def test_chip_engine_over_distinct_cards(cards):
    cfg = get_config("qwen3-1.7b").reduced(n_layers=4, head_dim=128)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    tile = _serve(cfg, params, "cuda")
    cheap = (dict(ici_bw=1e13), dict(p_c=0.5, p_b=0.5))
    for n, partition, regime in ((2, "chip", None), (cards, "chip", None),
                                 (2, "auto", cheap)):
        group = tuple(f"cuda:{i}" for i in range(n))
        chip = _serve(cfg, params, "cuda", regime, partition=partition,
                      devices=group)
        host = _serve(cfg, _cpu(params), "cpu", regime, partition=partition,
                      devices=("cpu",) * n)
        assert chip.outputs == tile.outputs == host.outputs, group
        st, hst = chip.stats, host.stats
        assert (st.chip_cycles, st.handoffs, st.fused_cycles) == \
            (hst.chip_cycles, hst.handoffs, hst.fused_cycles), group
        assert st.chip_cycles > 0
        assert chip.pool.free_blocks == chip.pool.n_blocks
        # the decode side ran on another card: the params were copied
        # there, and the pool with its graphs went and, under "auto",
        # came back for tile cycles
        assert set(chip._side_params) <= set(map(torch.device, group[1:]))
        assert chip._side_params, group
        if partition == "auto":
            assert chip.graphs.dropped > 0, group
