"""The decode steps replayed as CUDA graphs (``repro_torch/core/graphs.py``)
and what they need of the rest of the port.

On the CPU: ``embed_tokens`` bit-equal to the JAX function in fp32 and
bf16 at each tied model's width (its scale is a host float now, so no
host-to-device copy breaks a capture); ``StepGraphs`` and ``GraphedDecode``
run CPU tensors eagerly, equal to the direct call; the engine's persistent
staging buffers and per-bucket block tables stay current through a
preempt→resume that changes block ownership, and its streams equal the JAX
engine's (``test_torch_engine.py``'s model and recipes); ``set_cache_mode``
drops the graphs before the old cache goes.

On the card (marked ``cuda``, reduced depth, head dim 128 so the kernels
run): N steps through a ``StepGraphs`` against the module-level step
called directly on a copy of the same cache, bit-equal logits, tokens and
caches after every step, for the paged cache over three table buckets
with the block tables changed between replays, the dense cache, Mamba-2
(its state advanced once per step: the first step is the capture's miss)
and RecurrentGemma's ``decode_step``; the wrappers' launch counters moved
alike by both runs; the split decode's per-stream arrival counters made
before the capture that reads them."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import engine as E
from repro_torch.core.graphs import GraphedDecode, StepGraphs, launch_counts
from repro_torch.kernels import decode_attention as DA
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.models import transformer as T
from repro_torch.serving.request import Phase, Request

TIED = ("qwen3-1.7b", "mamba2-2.7b", "recurrentgemma-2b")

# The tests on the CPU import the JAX package (and test_torch_engine.py,
# which does) inside themselves, so that this module also imports where
# JAX is not installed and only the tests marked cuda run.


@pytest.fixture(scope="module")
def engine_tests():
    import test_torch_engine
    return test_torch_engine


@pytest.fixture(scope="module")
def model(engine_tests):
    return engine_tests._model()


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", TIED)
def test_embed_tokens_bit_equal_to_jax(arch, dtype):
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    jcfg, cfg = jax_config(arch), get_config(arch)
    assert cfg.tie_embeddings and cfg.d_model == jcfg.d_model
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, 64, (3, 5)).astype(np.int32)
    got = T.embed_tokens({"embed": torch.from_numpy(table).to(
        getattr(torch, dtype))}, torch.from_numpy(tokens), cfg)
    want = JT.embed_tokens({"embed": jnp.asarray(table).astype(
        getattr(jnp, dtype))}, jnp.asarray(tokens), jcfg, None)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _rg_cpu():
    cfg = get_config("recurrentgemma-2b").reduced()
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    return cfg, params


@pytest.mark.parametrize("what", ["step", "graphed_decode"])
def test_cpu_tensors_run_eagerly(what):
    if what == "step":
        graphs = StepGraphs()
        calls = []

        def step(x, y):
            calls.append(1)
            return x * 2 + y, x - y
        x, y = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
        got = graphs(("k",), step, x, y)
        want = step(x, y)
        assert len(calls) == 2
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        cfg, params = _rg_cpu()
        caches = [T.init_cache(cfg, 2, 40, torch.float32, "cpu")
                  for _ in range(2)]
        dec = GraphedDecode(params, caches[0], cfg)
        graphs = dec.graphs
        tok = torch.tensor([[3], [7]], dtype=torch.int32)
        for i in range(3):
            pos = torch.tensor([5 + i, 30 + i], dtype=torch.int32)
            got = dec(tok, pos)
            want, _ = T.decode_step(params, caches[1], tok, pos, cfg)
            assert torch.equal(got, want)
            tok = got.argmax(-1).to(torch.int32)[:, None]
        for a, b in zip(_leaves(caches[0]), _leaves(caches[1])):
            assert torch.equal(a, b)
    assert len(graphs) == 0 and graphs.captures == []


def _audited(server, seen):
    """Wrap ``server.step`` so that after every cycle the persistent
    buffers are the same storage as before and, whenever the host tables
    are synced, every bucket's device table equals the host table's
    columns."""
    step = server.step
    bufs = (server._dev_tokens, server._dev_pos, server._dev_active)
    ptrs = [b.data_ptr() for b in bufs]

    def audited(now):
        out = step(now)
        assert [b.data_ptr() for b in bufs] == ptrs
        for n_b, bt in server._dev_tables.items():
            seen.setdefault(n_b, bt.data_ptr())
            assert bt.data_ptr() == seen[n_b]
            if not server._tables_dirty:
                np.testing.assert_array_equal(
                    bt.numpy(), server._host_tables[:, :n_b])
        return out
    server.step = audited


@pytest.mark.parametrize("fused", [False, True])
def test_staged_inputs_follow_ownership_like_jax(engine_tests, model, fused):
    from repro.kvcache.paged import PagedKVPool as JPool
    from repro.serving.request import Phase as JPhase
    from repro.serving.request import Request as JRequest
    te = engine_tests
    js, ts = te._servers(model, fused=fused, max_slots=2, max_len=40,
                         max_prefill_batch=1)
    seen = {}
    _audited(ts, seen)
    cfg = model[1]
    te._preemption_scenario(js, cfg, JPool, JRequest, JPhase)
    te._preemption_scenario(ts, cfg, PagedKVPool, Request, Phase)
    assert ts.outputs == js.outputs
    assert ts.stats.preempted == 1
    # the prompts of 8 and 30 tokens decode over 1-, 2- and 3-page tables
    assert len(seen) >= 2, seen


def test_set_cache_mode_drops_graphs_first(engine_tests, model):
    _, ts = engine_tests._servers(model, fused=False)
    ts.submit(Request(rid=0, arrival=0.0, prompt_len=6, output_len=4),
              np.arange(6))
    ts.step(0.0)
    order = []
    drop = ts.graphs.drop

    def spy():
        order.append("drop" if ts.cache is not None else "drop after")
        drop()
    ts.graphs.drop = spy
    ts.set_cache_mode(False, 1e-3)
    assert not ts.paged and order and order[0] == "drop"
    ts.set_cache_mode(True, 2e-3)
    assert ts.paged and order.count("drop") >= 2
    engine_tests._drive(ts, 3e-3)
    assert len(ts.outputs[0]) == 4


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _fill(cache, gen):
    for t in _leaves(cache):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))


def _spy_counts(monkeypatch, seen):
    """The split decode's arrival counters, taken while a graph captures,
    must already exist for the capturing stream (made by the warm-up)."""
    orig = DA._counts

    def spy(device, n):
        if torch.cuda.is_current_stream_capturing():
            key = (device.index,
                   torch.cuda.current_stream(device).cuda_stream)
            assert key in DA._COUNTS and DA._COUNTS[key].numel() >= n
            seen.append(key)
        return orig(device, n)
    monkeypatch.setattr(DA, "_counts", spy)


def _paged_steps(cfg, gen, dtype):
    """Three table buckets (4, 16, 32 pages of 16 rows), three steps each,
    the tables drawn anew before every step (ownership changes between
    replays of one graph); one inactive slot on the trash page."""
    b, ps, n_pages = 4, 16, 4 * 32
    rng = np.random.default_rng(1)
    steps = []
    for n_b in (4, 16, 32):
        for i in range(3):
            bt = np.full((b, n_b), n_pages, np.int32)
            perm = rng.permutation(n_pages)
            pos = rng.integers(0, n_b * ps, b).astype(np.int32)
            pos[1] = -1
            for s in (0, 2, 3):
                need = int(pos[s]) // ps + 1
                bt[s, :need] = perm[s * 32:s * 32 + need]
            steps.append((("paged", n_b), dict(
                pos=torch.from_numpy(pos).cuda(),
                active=torch.from_numpy(pos >= 0).cuda(),
                block_tables=torch.from_numpy(bt).cuda())))
    return T.init_paged_cache(cfg, n_pages, ps, dtype, "cuda"), steps


def _dense_steps(cfg, dtype, max_len, pos0):
    pos0 = np.asarray(pos0, np.int32)
    steps = [(("dense",), dict(pos=torch.from_numpy(pos0 + i).cuda(),
                               active=torch.ones(len(pos0), dtype=torch.bool,
                                                 device="cuda")))
             for i in range(4)]
    return T.init_cache(cfg, len(pos0), max_len, dtype, "cuda"), steps


CASES = {
    "paged-bf16": ("qwen3-1.7b", torch.bfloat16),
    "paged-fp32": ("qwen3-1.7b", torch.float32),
    "dense-bf16": ("qwen3-1.7b", torch.bfloat16),
    "mamba2-bf16": ("mamba2-2.7b", torch.bfloat16),
    "rg-bf16": ("recurrentgemma-2b", torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graph_replay_equals_eager_step(card, monkeypatch, case):
    arch, dtype = CASES[case]
    # head dim 128 and (RecurrentGemma) a 512-row ring: the kernels' head
    # dims, and rows enough for the bf16 decode to split
    cfg = get_config(arch).reduced(head_dim=128, sliding_window=512)
    params = T.init_params(cfg, seed=0, dtype=dtype, device="cuda")
    if case.startswith("paged"):
        cache, steps = _paged_steps(cfg, card, dtype)
    elif case.startswith("dense"):
        cache, steps = _dense_steps(cfg, dtype, 512, [499, 300, 40, 7])
    elif case.startswith("mamba2"):
        cache, steps = _dense_steps(cfg, dtype, 64, [10, 20, 30, 40])
    else:
        cache, steps = _dense_steps(cfg, dtype, 600, [550, 300, 9, 595])
        steps = [(("rg", 4), s) for _, s in steps]
    _fill(cache, card)
    eager = _clone_tree(cache)
    graphs = StepGraphs()
    seen = []
    _spy_counts(monkeypatch, seen)
    if case.startswith("rg"):
        graphed = GraphedDecode(params, cache, cfg)
        graphs = graphed.graphs
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=card,
                        device="cuda", dtype=torch.int32)
    tok_e = tok.clone()
    moved_e = moved_g = np.zeros(len(launch_counts()), np.int64)
    for key, s in steps:
        c0 = np.array(launch_counts())
        if case.startswith("rg"):
            lg_e, _ = T.decode_step(params, eager, tok_e, s["pos"], cfg)
            nt_e = lg_e.argmax(-1).to(torch.int32)[:, None]
        else:
            nt_e, lg_e = E._decode_iteration(params, eager, tok_e, s["pos"],
                                             s["active"],
                                             s.get("block_tables"), cfg=cfg)
        c1 = np.array(launch_counts())
        if case.startswith("rg"):
            lg_g = graphed(tok, s["pos"])
            nt_g = lg_g.argmax(-1).to(torch.int32)[:, None]
        else:
            args = [tok, s["pos"], s["active"]] + (
                [s["block_tables"]] if "block_tables" in s else [])
            nt_g, lg_g = graphs(key, lambda *a: E._decode_iteration(
                params, cache, *a, cfg=cfg), *args)
        c2 = np.array(launch_counts())
        moved_e, moved_g = moved_e + (c1 - c0), moved_g + (c2 - c1)
        assert torch.equal(lg_g, lg_e), key
        assert torch.equal(nt_g, nt_e), key
        for a, b in zip(_leaves(cache), _leaves(eager)):
            assert torch.equal(a, b), key
        tok, tok_e = nt_g.clone(), nt_e.clone()
    keys = {k for k, _ in steps}
    assert len(graphs) == len(keys) == len(graphs.captures)
    assert (moved_g == moved_e).all()
    if arch != "mamba2-2.7b":           # Mamba-2's decode step is plain ops
        assert moved_e.sum() > 0
    if dtype == torch.bfloat16 and arch != "mamba2-2.7b":
        assert seen, "no split decode launch took its arrival counters"


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone()


class _Cycle:
    """An object in a reference cycle: only the garbage collector frees
    it, as it frees a dropped server and the graphs its ``StepGraphs``
    holds."""


@pytest.mark.cuda
def test_capture_survives_dropped_graphs_in_cycles(card):
    """While a graph captures, the last reference to another graph moves
    into a reference cycle, and the step allocates enough to start
    collections: a collection during the capture would free the dropped
    graph, whose reset is not permitted while a stream captures and
    invalidates the capture. ``StepGraphs`` holds the collector off during
    a capture, so every capture succeeds and replays the step."""
    x = torch.randn(64, 64, generator=card, device="cuda")
    holder = []

    def step(t):
        if torch.cuda.is_current_stream_capturing() and holder:
            cyc = _Cycle()
            cyc.me, cyc.graphs = cyc, holder.pop()
            del cyc                      # only a collection frees it now
            junk = [[i] for i in range(5000)]
            del junk
        return (t @ t).relu()

    for _ in range(5):
        old = StepGraphs()
        old(("sq",), step, x)                          # holds a CUDAGraph
        holder.append(old)
        del old
        g = StepGraphs()
        g(("sq",), step, x)                            # captures
        assert not holder
        assert torch.equal(g(("sq",), step, x), step(x))   # replays
