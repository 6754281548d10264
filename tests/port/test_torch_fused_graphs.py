"""The fused cycle in segments and the paged prefill groups with
prompt-length buckets (``repro_torch/core/engine.py``), and the persistent
inputs ``StepGraphs`` captures in place (``core/graphs.py``).

On the CPU, on a reduced Qwen3 (3 layers, narrow widths): the segmented
fused step (embedding, decode repeats, the eager fused repeat, head, the
activations in persistent buffers) equals ``T.fused_group_decode`` bit for
bit at every ``rep``, fp32 and bf16, and the JAX ``_fused_step``
(``src/repro/core/engine.py:144``, jitted on the CPU as the JAX fused
tests run it) within ``test_torch_transformer.py``'s fused tolerance;
bucketed prefill (prompts on both sides of a bucket edge, batches of 1 and
3) gives the JAX engine's first tokens, greedy streams and prompt K/V in
each request's pages; the prefill page-map buffer follows block ownership
through a preempt→resume; the bucket rule; ``StepGraphs``' bookkeeping of
kept inputs.

On the card (marked ``cuda``, head dim 128 so the kernels run): each new
graph kind against its eager segment, bit-equal, with the launch counters
moved alike; the serial decode graph on kept inputs bit-equal to the eager
step with no input copied; a reduced fused serve through the graphs with
streams equal to the serial serve's."""

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import engine as E
from repro_torch.core.graphs import StepGraphs, launch_counts
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.models import transformer as T
from repro_torch.serving.request import Phase, Request

#: test_torch_transformer.py's tolerance for the fused cycle against JAX
ATOL = 1e-4
N_LAYERS = 3

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
# the bucket rule and StepGraphs' bookkeeping
# ---------------------------------------------------------------------------

def test_prefill_bucket_rule():
    got = {n: E.prefill_bucket(n, 4096, 16)
           for n in (1, 127, 128, 129, 640, 1000, 1024, 1025, 2049, 4095)}
    assert got == {1: 128, 127: 128, 128: 128, 129: 256, 640: 640,
                   1000: 1024, 1024: 1024, 1025: 2048, 2049: 4096,
                   4095: 4096}
    # capped at max_len rounded up to the page size, always a page multiple
    assert E.prefill_bucket(30, 40, 16) == 48
    assert E.prefill_bucket(999, 1000, 16) == 1008
    assert E.prefill_bucket(5, 40, 8) == 40
    for max_len, ps in ((1152, 16), (1000, 16), (300, 8), (40, 16)):
        buckets = {E.prefill_bucket(n, max_len, ps)
                   for n in range(1, max_len)}
        assert len(buckets) <= 10, (max_len, sorted(buckets))
        assert all(b % ps == 0 for b in buckets)
        assert all(E.prefill_bucket(n, max_len, ps) >= n
                   for n in range(1, max_len))


def test_step_graphs_capture_kept_inputs_in_place():
    graphs = StepGraphs()
    kept, other = torch.arange(4.0), torch.ones(3)
    graphs.keep(kept)
    static = graphs.static_inputs((kept, other))
    assert static[0] is kept
    assert static[1] is not other and torch.equal(static[1], other)
    # a replay given the kept buffer copies nothing into it; any other
    # input is copied into its static clone
    fresh = torch.full((3,), 7.0)
    assert StepGraphs.stage(static, (kept, fresh)) == 1
    assert torch.equal(static[1], fresh)
    assert torch.equal(kept, torch.arange(4.0))
    assert StepGraphs.stage(static, static) == 0
    # the registry holds its buffers weakly
    del static
    n = len(graphs._kept)
    del kept
    assert len(graphs._kept) == n - 1
    # CPU tensors still run the step eagerly, capturing nothing
    assert torch.equal(graphs(("k",), lambda x: x * 2, other),
                       torch.full((3,), 2.0))
    assert len(graphs) == 0 and graphs.captures == []


# ---------------------------------------------------------------------------
# the segmented fused step
# ---------------------------------------------------------------------------

PS = 8
#: the trash page of ``_fused_inputs``' pool (its last page)
TRASH = 14


def _fused_inputs(cfg, dtype, device="cpu", seed=2, sp=11):
    """A random page pool, a decode batch over it (contexts 5, 16, 23 and
    an inactive slot, tables of 4 columns, trash past each slot's pages)
    and a prefill batch of 2 rows of ``sp`` tokens scattered into pages
    the decode tables do not name (test_torch_transformer.py's layout)."""
    rng = np.random.default_rng(seed)
    n_pages = TRASH
    shape = (cfg.n_pattern_repeats, n_pages + 1, PS, cfg.n_kv_heads,
             cfg.head_dim)
    pool = {"blocks": tuple(
        {"k": rng.normal(size=shape).astype(np.float32),
         "v": rng.normal(size=shape).astype(np.float32)}
        for _ in cfg.pattern)}
    pos = np.array([5, 16, 23, -1], np.int32)
    bt = np.full((4, 4), n_pages, np.int32)
    bt[0, :1] = [3]
    bt[1, :3] = [0, 7, 9]
    bt[2, :3] = [1, 2, 5]
    n_pm = -(-sp // PS)
    assert n_pm <= 6
    page_map = np.full((2, n_pm), n_pages, np.int32)
    page_map[0] = [4, 6, 10, 11, 12, 13][:n_pm]
    page_map[1, 0] = 8
    tokens = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    x_p = rng.normal(size=(2, sp, cfg.d_model)).astype(np.float32)
    t = functools.partial(torch.as_tensor, device=device)
    dev = dict(pos=t(pos), bt=t(bt), page_map=t(page_map), tokens=t(tokens),
               active=t(pos >= 0), positions=t(np.arange(sp)[None, :]),
               x_p=t(x_p).to(dtype))
    return pool, dev


def _pool_cache(pool, dtype, device="cpu"):
    return {"blocks": tuple({k: torch.as_tensor(v, device=device).to(dtype)
                             for k, v in leaf.items()}
                            for leaf in pool["blocks"])}


def _leaves(cache):
    return [leaf[k] for leaf in cache["blocks"] for k in ("k", "v")]


def _eager_fused(params, cache, d, cfg, rep, share):
    """``T.fused_group_decode`` and the parent engine's masking: (x_p, next
    tokens, logits)."""
    x_p, logits = T.fused_group_decode(
        params, cache, d["x_p"].clone(), d["positions"], d["page_map"],
        d["tokens"], d["pos"], cfg, rep=rep, decode_share=share,
        block_tables=d["bt"])
    nt = logits.argmax(-1).to(torch.int32)
    return x_p, torch.where(d["active"], nt, 0)[:, None], logits


def _segmented_fused(graphs, params, cache, d, cfg, rep, share, x_d=None):
    x_p = d["x_p"].clone()
    if x_d is None:
        x_d = torch.zeros((4, 1, cfg.d_model), dtype=x_p.dtype,
                          device=x_p.device)
    nt, logits = E._fused_step(graphs, params, cache, x_p, d["positions"],
                               d["page_map"], x_d, d["tokens"], d["pos"],
                               d["active"], d["bt"], cfg=cfg, rep=rep,
                               decode_share=share)
    return x_p, nt, logits


@pytest.mark.parametrize("rep", range(N_LAYERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmented_fused_step_equals_fused_group_decode(dtype, rep):
    dtype = getattr(torch, dtype)
    cfg = get_config("qwen3-1.7b").reduced(n_layers=N_LAYERS)
    assert cfg.n_pattern_repeats == N_LAYERS
    params = T.init_params(cfg, seed=0, dtype=dtype, device="cpu")
    pool, d = _fused_inputs(cfg, dtype)
    eager_cache, seg_cache = (_pool_cache(pool, dtype) for _ in range(2))
    want = _eager_fused(params, eager_cache, d, cfg, rep, 0.25)
    graphs = StepGraphs()
    got = _segmented_fused(graphs, params, seg_cache, d, cfg, rep, 0.25)
    for name, a, b in zip(("x_p", "next tokens", "logits"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for a, b in zip(_leaves(seg_cache), _leaves(eager_cache)):
        assert torch.equal(a, b)
    assert len(graphs) == 0            # CPU tensors: every segment eager


@pytest.mark.parametrize("rep", range(N_LAYERS))
def test_segmented_fused_step_matches_jax(rep):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.core import engine as JE
    from repro.models import init_params as jax_init_params
    from repro_torch.bridge import params_from_jax
    jcfg = jax_config("qwen3-1.7b").reduced(n_layers=N_LAYERS)
    cfg = get_config("qwen3-1.7b").reduced(n_layers=N_LAYERS)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    pool, d = _fused_inputs(cfg, torch.float32, seed=4)
    cache = _pool_cache(pool, torch.float32)
    x_p, nt, _ = _segmented_fused(StepGraphs(), params, cache, d, cfg, rep,
                                  0.5)
    np_ = {k: v.numpy() for k, v in d.items()}
    jx, jnt, jcache = JE._fused_step(
        jparams, jax.tree.map(jnp.asarray, pool), jnp.asarray(np_["x_p"]),
        jnp.asarray(np_["positions"]), jnp.asarray(np_["page_map"]),
        jnp.asarray(np_["tokens"]), jnp.asarray(np_["pos"]),
        jnp.asarray(np_["active"]), jnp.asarray(np_["bt"]), cfg=jcfg,
        rep=rep, decode_share=0.5)
    np.testing.assert_allclose(x_p.numpy(), np.asarray(jx), atol=ATOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(jnt))
    trash = pool["blocks"][0]["k"].shape[1] - 1
    for j, leaf in enumerate(cache["blocks"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                leaf[key].numpy()[:, :trash],
                np.asarray(jcache["blocks"][j][key])[:, :trash], atol=ATOL)


# ---------------------------------------------------------------------------
# bucketed prefill in the engine, against the JAX engine
# ---------------------------------------------------------------------------

def _snapshot_prompts(server, pages):
    """Wrap ``server._finish_prefill`` to keep, per request, its prompt's
    K/V out of its pooled pages (the handoff moves no page, so they are the
    pages decode reads): ``pages[rid]`` = [(k, v) per pattern position],
    each (R, len, K, D) numpy."""
    finish = server._finish_prefill

    def snap(task, now):
        for r in task.batch:
            n = server._resume_len(r)
            blocks = list(server.pool.table(r.rid).blocks)
            out = []
            for leaf in server.cache["blocks"]:
                kv = []
                for key in ("k", "v"):
                    t = np.asarray(leaf[key])[:, blocks]
                    kv.append(t.reshape(t.shape[0], -1, *t.shape[3:])[:, :n])
                out.append(kv)
            pages[r.rid] = out
        return finish(task, now)
    server._finish_prefill = snap


@pytest.mark.parametrize("bp", [1, 3])
def test_bucketed_prefill_matches_jax(engine_tests, model, bp):
    from repro.serving.request import Request as JRequest
    te = engine_tests
    js, ts = te._servers(model, fused=True, max_slots=4, max_len=300,
                         max_prefill_batch=bp)
    cfg = model[1]
    rng = np.random.default_rng(7)
    lens = (127, 129, 60)              # both sides of the 128 bucket edge
    for rid, n in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab_size, n)
        js.submit(JRequest(rid=rid, arrival=0.0, prompt_len=n,
                           output_len=5), prompt)
        ts.submit(Request(rid=rid, arrival=0.0, prompt_len=n, output_len=5),
                  prompt)
    jpages, tpages = {}, {}
    _snapshot_prompts(js, jpages)
    _snapshot_prompts(ts, tpages)
    seen = []
    admit = ts._admit_prefill

    def spy(now):
        did = admit(now)
        if did:
            seen.append(tuple(ts.ptask.x.shape[:2]))
        return did
    ts._admit_prefill = spy
    te._drive(js)
    te._drive(ts)
    assert ts.outputs == js.outputs
    assert all(len(v) == 5 for v in ts.outputs.values())
    assert ts.pool.available_blocks == ts.pool.n_blocks
    if bp == 1:
        assert sorted(seen) == [(1, 128), (1, 128), (1, 256)]
    else:
        assert seen == [(3, 256)]
    # the estimator and scheduler see the real tokens, not the padding
    assert ts.stats.prefill_tokens == js.stats.prefill_tokens == sum(lens)
    assert sorted(tpages) == sorted(jpages) == [0, 1, 2]
    for rid in tpages:
        for (tk, tv), (jk, jv) in zip(tpages[rid], jpages[rid]):
            np.testing.assert_allclose(tk, jk, atol=ATOL)
            np.testing.assert_allclose(tv, jv, atol=ATOL)


def _audited_page_map(server, seen):
    """Wrap ``server.step`` so that after every cycle with a prefill in
    flight its page map is the persistent buffer of its (B, padded length)
    and holds, per prompt, its pooled pages then the trash page."""
    step = server.step

    def audited(now):
        out = step(now)
        task = server.ptask
        if task is not None:
            b, s = task.x.shape[:2]
            bufs = server._pbufs[(b, s)]
            assert task.page_map is bufs.page_map and task.x is bufs.x
            ps = server.page_size
            want = np.full(tuple(bufs.page_map.shape), server._trash_page,
                           np.int32)
            for i, r in enumerate(task.batch):
                blocks = server.pool.table(r.rid).blocks
                blocks = blocks[:-(-server._resume_len(r) // ps)]
                want[i, :len(blocks)] = blocks
            np.testing.assert_array_equal(task.page_map.numpy(), want)
            seen.setdefault((b, s), set()).add(want.tobytes())
        return out
    server.step = audited


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_page_map_follows_ownership_like_jax(engine_tests, model,
                                                     fused):
    from repro.kvcache.paged import PagedKVPool as JPool
    from repro.serving.request import Phase as JPhase
    from repro.serving.request import Request as JRequest
    te = engine_tests
    js, ts = te._servers(model, fused=fused, max_slots=2, max_len=40,
                         max_prefill_batch=1)
    seen = {}
    _audited_page_map(ts, seen)
    cfg = model[1]
    te._preemption_scenario(js, cfg, JPool, JRequest, JPhase)
    te._preemption_scenario(ts, cfg, PagedKVPool, Request, Phase)
    assert ts.outputs == js.outputs
    assert ts.stats.preempted == 1
    # one buffer (prompts of 8 and 30 tokens both pad to 48), rewritten
    # for each batch: the preempted request re-prefills on other pages
    assert list(seen) == [(1, 48)]
    assert len(seen[(1, 48)]) >= 2


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _cuda_cfg():
    # head dim 128: the kernels' head dim
    return get_config("qwen3-1.7b").reduced(n_layers=4, head_dim=128)


def _moved(fn):
    c0 = np.array(launch_counts())
    out = fn()
    return out, np.array(launch_counts()) - c0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_segments_replay_equal_eager(card, dtype):
    dtype = getattr(torch, dtype)
    cfg = _cuda_cfg()
    params = T.init_params(cfg, seed=0, dtype=dtype, device="cuda")
    graphs = StepGraphs()
    x_d = torch.zeros((4, 1, cfg.d_model), dtype=dtype, device="cuda")
    graphs.keep(x_d)
    steps = [(rep, share, sp) for sp in (16, 40) for rep in (0, 3, 1)
             for share in (0.25, 0.5)]
    pool, _ = _fused_inputs(cfg, dtype, "cuda", seed=5)
    eager_cache = _pool_cache(pool, dtype, "cuda")
    seg_cache = _pool_cache(pool, dtype, "cuda")
    for i, (rep, share, sp) in enumerate(steps):
        _, d = _fused_inputs(cfg, dtype, "cuda", seed=10 + i, sp=sp)
        want, m_e = _moved(lambda: _eager_fused(params, eager_cache, d, cfg,
                                                rep, share))
        got, m_g = _moved(lambda: _segmented_fused(
            graphs, params, seg_cache, d, cfg, rep, share, x_d))
        # the padded prompt row writes the trash page in no set order on
        # the card, and the inactive slot reads it: pools but the trash
        # page, and the active slots' logits, as test_torch_transformer.py
        act = d["active"]
        for name, a, b in (("x_p", got[0], want[0]),
                           ("next tokens", got[1], want[1]),
                           ("logits", got[2][act], want[2][act])):
            assert torch.equal(a, b), (name, rep, share, sp)
        for a, b in zip(_leaves(seg_cache), _leaves(eager_cache)):
            assert torch.equal(a[:, :TRASH], b[:, :TRASH]), (rep, share, sp)
        assert (m_g == m_e).all() and m_e.sum() > 0, (m_g, m_e)
    kinds = {k[0] for k, _ in graphs.captures}
    assert kinds == {"d_embed", "d_rep", "d_head"}
    # one decode graph per (repeat, bucket) the steps reached: every one
    # but the fused repeat at each bucket (one bucket of 4 columns here)
    assert len([k for k, _ in graphs.captures if k[0] == "d_rep"]) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("bp", [1, 3])
def test_prefill_graphs_replay_equal_eager(card, bp):
    cfg = _cuda_cfg()
    dtype = torch.bfloat16
    params = T.init_params(cfg, seed=0, dtype=dtype, device="cuda")
    n_pages = 3 * 40
    eager_cache = T.init_paged_cache(cfg, n_pages, 16, dtype, "cuda")
    seg_cache = T.init_paged_cache(cfg, n_pages, 16, dtype, "cuda")
    graphs = StepGraphs()
    rng = np.random.default_rng(bp)
    by_len = {}
    for s in (128, 256, 128):
        lens = rng.integers(1, s + 1, bp).astype(np.int32)
        perm = rng.permutation(n_pages)
        pm = np.full((bp, s // 16), n_pages, np.int32)
        for i, n in enumerate(lens):
            need = -(-int(n) // 16)
            pm[i, :need] = perm[i * 16:i * 16 + need]
        x = torch.randn((bp, s, cfg.d_model), generator=card,
                        device="cuda").to(dtype)
        # the persistent buffers of this length, written anew as the
        # engine writes them at each admission
        if s not in by_len:
            by_len[s] = (torch.empty_like(x),
                         torch.arange(s, device="cuda")[None, :],
                         torch.empty((bp,), dtype=torch.int32,
                                     device="cuda"),
                         torch.empty(pm.shape, dtype=torch.int32,
                                     device="cuda"))
            graphs.keep(*by_len[s])
        bufs = by_len[s]
        bufs[0].copy_(x)
        bufs[2].copy_(torch.from_numpy(lens))
        bufs[3].copy_(torch.from_numpy(pm))
        x_e = x.clone()
        for rep in range(cfg.n_pattern_repeats):
            def eager():
                y, entries = T.prefill_group(params, x_e, bufs[1], rep, cfg)
                T.scatter_group_pages(eager_cache, entries, bufs[3], rep)
                return y
            x_e, m_e = _moved(eager)
            _, m_g = _moved(lambda: graphs(
                ("p_group", rep, bp, s), functools.partial(
                    E._prefill_group_paged, params, seg_cache, cfg=cfg,
                    rep=rep), bufs[0], bufs[1], bufs[3]))
            assert torch.equal(bufs[0], x_e), (s, rep)
            assert (m_g == m_e).all() and m_e.sum() > 0
        # but the trash page: the padded rows reach it in no set order
        for a, b in zip(_leaves(seg_cache), _leaves(eager_cache)):
            assert torch.equal(a[:, :n_pages], b[:, :n_pages]), s
        want = E._final_tokens(params, x_e, bufs[2], cfg=cfg)
        got = graphs(("p_final", bp, s), functools.partial(
            E._final_tokens, params, cfg=cfg), bufs[0], bufs[2])
        assert torch.equal(got, want), s
    kinds = sorted({k[0] for k, _ in graphs.captures})
    assert kinds == ["p_final", "p_group"]
    assert len(graphs) == 2 * (cfg.n_pattern_repeats + 1)


@pytest.mark.cuda
def test_serial_decode_graph_on_kept_inputs_bit_equal(card, monkeypatch):
    cfg = _cuda_cfg()
    dtype = torch.bfloat16
    params = T.init_params(cfg, seed=0, dtype=dtype, device="cuda")
    b, ps, n_pages, n_b = 4, 16, 4 * 16, 8
    cache = T.init_paged_cache(cfg, n_pages, ps, dtype, "cuda")
    for t in _leaves(cache):
        t.copy_(torch.randn(t.shape, generator=card, device="cuda"))
    twin = {"blocks": tuple({k: v.clone() for k, v in leaf.items()}
                            for leaf in cache["blocks"])}
    bufs = (torch.zeros((b, 1), dtype=torch.int32, device="cuda"),
            torch.zeros((b,), dtype=torch.int32, device="cuda"),
            torch.zeros((b,), dtype=torch.bool, device="cuda"),
            torch.zeros((b, n_b), dtype=torch.int32, device="cuda"))
    graphs = StepGraphs()
    graphs.keep(*bufs)
    copies = []
    stage = StepGraphs.stage
    monkeypatch.setattr(StepGraphs, "stage", staticmethod(
        lambda static, inputs: copies.append(stage(static, inputs))))
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    for i in range(4):
        pos = rng.integers(0, n_b * ps, b).astype(np.int32)
        pos[2] = -1
        bt = np.full((b, n_b), n_pages, np.int32)
        for s in (0, 1, 3):
            need = int(pos[s]) // ps + 1
            bt[s, :need] = rng.permutation(16)[:need] + 16 * s
        for buf, v in zip(bufs, (tok, pos, pos >= 0, bt)):
            buf.copy_(torch.from_numpy(v))
        nt_e, lg_e = E._decode_iteration(params, twin, *bufs, cfg=cfg)
        nt_g, lg_g = graphs(("paged", n_b), lambda *a: E._decode_iteration(
            params, cache, *a, cfg=cfg), *bufs)
        assert torch.equal(nt_g, nt_e) and torch.equal(lg_g, lg_e), i
        for x, y in zip(_leaves(cache), _leaves(twin)):
            assert torch.equal(x, y), i
        tok = nt_e.cpu().numpy()
    entry = graphs._entries[("paged", n_b)]
    assert all(s is x for s, x in zip(entry.inputs, bufs))
    assert copies == [0, 0, 0]             # three replays, nothing copied


@pytest.mark.cuda
def test_fused_serve_through_graphs_equals_serial(card):
    from repro_torch.core.config import (ControlConfig, ExecConfig,
                                         ServerConfig)
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving.request import SLO
    cfg = _cuda_cfg()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (100, 200, 130, 40)]
    outs = {}
    for fused in (True, False):
        server = E.BulletServer(cfg, params, config=ServerConfig(
            slo=SLO(3.0, 150.0), max_slots=4, max_len=400,
            max_prefill_batch=1, dtype=torch.bfloat16,
            execution=ExecConfig(fused=fused),
            control=ControlConfig(sched=SchedulerConfig(
                max_decode_pause_cycles=0))), device="cuda")
        for rid, p in enumerate(prompts):
            server.submit(Request(rid=rid, arrival=0.0, prompt_len=len(p),
                                  output_len=12), p)
        now = 0.0
        while not server.idle:
            server.step(now)
            server.check_invariants()
            now += 1e-3
        assert server.pool.available_blocks == server.pool.n_blocks
        outs[fused] = dict(server.outputs)
        kinds = {k[0] for k, _ in server.graphs.captures}
        if fused:
            assert server.stats.fused_cycles > 0
            assert {"d_embed", "d_rep", "d_head", "p_group",
                    "p_final"} <= kinds
        else:
            assert kinds == {"paged", "p_group", "p_final"}
    assert outs[True] == outs[False]
