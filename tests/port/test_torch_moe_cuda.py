"""The mixture-of-experts layer on the card (marked ``cuda``; they skip
without one). The file imports no JAX, so it loads on a host without it;
``test_torch_moe.py`` holds the layer against the JAX package on the CPU.

- The capacity a valid mask gives, computed on the device from the count
  of valid rows, is the Python ``_capacity`` at every count (the card's
  float64 division is IEEE's).
- A paged prefill group of reduced Llama-4 Maverick (a MoE block inside),
  captured as the engine's ``("p_group", rep, Bp, S)`` graph, replays
  bit-equal to the eager step after the allocator has been churned:
  eager MoE calls at many other shapes, their memory freed and refilled
  with garbage, so a graph that read memory it does not own would read
  the garbage."""

import functools

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import engine as E
from repro_torch.core.graphs import StepGraphs
from repro_torch.models import moe as M
from repro_torch.models import transformer as T


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_capacity_on_device_is_the_python_expression_on_the_card(card):
    for n_tokens, e, k, f in [(64, 4, 1, 1.25), (1000, 16, 2, 1.0),
                              (300, 128, 1, 1.25), (97, 8, 2, 0.25),
                              (500, 6, 2, 1.1), (4096, 128, 1, 0.3)]:
        n = torch.arange(n_tokens + 1, device="cuda")
        got = torch.stack([M.capacity_on_device(c, e, k, f)
                           for c in n]).tolist()
        assert got == [M._capacity(i, e, k, f) for i in range(n_tokens + 1)]


def _churn(d_model: int) -> None:
    """Eager masked MoE calls at 70 token counts (each its own limit),
    then the cache's free blocks filled with garbage."""
    e, f = 4, 32
    params = {"router": torch.randn(d_model, e, device="cuda"),
              "w_in": torch.randn(e, d_model, 2 * f, device="cuda"),
              "w_out": torch.randn(e, f, d_model, device="cuda")}
    for t in range(3, 73):
        x = torch.randn(1, t, d_model, device="cuda")
        valid = torch.arange(t, device="cuda")[None] < t - 1
        M.moe_ffn(x, params, n_experts=e, k=1, capacity_factor=1.25,
                  valid=valid)
    junk = [torch.full((n,), 7, dtype=torch.int64, device="cuda")
            for n in (1, 8, 64, 65, 512, 4096, 1 << 16) for _ in range(8)]
    del junk


@pytest.mark.cuda
def test_moe_prefill_group_graph_replays_after_allocator_churn(card):
    """Three batches of two prompts (each row its own length, so each
    group its own capacity limit) through every repeat's graph, the
    allocator churned after each step: activations, MoE sums and the
    pool's pages bit-equal to the eager steps'."""
    cfg = get_config("llama4-maverick-400b-a17b").reduced(
        head_dim=128, moe_capacity_factor=0.25)
    dtype, bp, s, ps = torch.float32, 2, 128, 16
    params = T.init_params(cfg, seed=0, dtype=dtype, device="cuda")
    n_pages = bp * (s // ps)
    eager_cache = T.init_paged_cache(cfg, n_pages, ps, dtype, "cuda")
    graph_cache = T.init_paged_cache(cfg, n_pages, ps, dtype, "cuda")
    graphs = StepGraphs()
    # the engine's persistent buffers, written at each admission
    x = torch.empty((bp, s, cfg.d_model), dtype=dtype, device="cuda")
    positions = torch.arange(s, device="cuda")[None, :]
    lengths = torch.empty((bp,), dtype=torch.int32, device="cuda")
    page_map = torch.arange(n_pages, dtype=torch.int32,
                            device="cuda").reshape(bp, s // ps)
    graphs.keep(x, positions, lengths, page_map)
    reps = range(cfg.n_pattern_repeats)
    eager_stats = [M.MoEStats("cuda") for _ in reps]
    graph_stats = [M.MoEStats("cuda") for _ in reps]
    for lens in ([100, 37], [128, 9], [64, 120]):
        x.copy_(torch.randn((bp, s, cfg.d_model), generator=card,
                            device="cuda"))
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        for rep in reps:
            want, entries = T.prefill_group(params, x.clone(), positions,
                                            rep, cfg, lengths,
                                            eager_stats[rep])
            T.scatter_group_pages(eager_cache, entries, page_map, rep)
            graphs(("p_group", rep, bp, s), functools.partial(
                E._prefill_group_paged, params, graph_cache, cfg=cfg,
                rep=rep, stats=graph_stats[rep]), x, positions, page_map,
                lengths)
            torch.cuda.synchronize()
            assert torch.equal(x, want), (lens, rep)
            assert torch.equal(graph_stats[rep].sums,
                               eager_stats[rep].sums), (lens, rep)
            _churn(cfg.d_model)
    assert len(graphs) == len(reps)
    assert sum(st.read()["dropping_calls"] for st in graph_stats) > 0
    for g, e in zip(graph_cache["blocks"], eager_cache["blocks"]):
        assert torch.equal(g["k"], e["k"]) and torch.equal(g["v"], e["v"])
