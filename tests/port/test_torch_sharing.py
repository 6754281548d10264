"""Shared-prefix KV reuse in the port (docs/KV_SHARING.md): the suffix
attention over gathered prefix pages (``models/attention.py``
``prefix_suffix_attention``), the in-place suffix splice into the page
pool (``models/transformer.py`` ``scatter_suffix_pages``) and the
engine's hit batches (``core/engine.py`` ``_build_shared_task``).

On the CPU, fp32, with numpy inputs from a seed and the JAX params
bridged: both ops against the JAX functions (an empty prefix, a
copy-on-write tail starting mid-page, padded rows; ``atol`` as
``test_torch_attention.py``'s), and the recipes of
``tests/test_prefix_sharing.py`` and ``tests/test_resilience.py`` (the
paged→dense rung flushing shared pages) on the torch engine, whose
streams, stats and copy-on-write counts equal the JAX engine's.

On the card (marked ``cuda``): a shared admission, its copy-on-write copy
and suffix splice, lands between two replays of a live request's decode
graph, and the streams and page pool equal an eager run's: the pool is
written in place, so no graph reads a dead pool."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.config import CacheConfig, ExecConfig, ServerConfig
from repro_torch.core.engine import BulletServer
from repro_torch.core.graphs import StepGraphs
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serving.request import SLO, Request

#: test_torch_attention.py's fp32 tolerance
ATOL = 2e-5
HW = dict(name="h100-sxm", n_chips=1, peak_flops=989e12, hbm_bw=3.35e12,
          ici_bw=450e9, units_per_chip=8, grid_slots=8)

# JAX is imported inside the CPU tests, so that this module also imports
# where JAX is not installed and only the test marked cuda runs.


# ---------------------------------------------------------------------------
# the ops against the JAX functions
# ---------------------------------------------------------------------------

def _attn_inputs(case, seed=0):
    """(q, k_sfx, v_sfx, k_pre, v_pre, prefix_len, q_positions) numpy:
    B=3, H=4 on K=2, D=16, suffixes of 12 (padded rows in "padded")."""
    rng = np.random.default_rng(seed)
    b, s, h, k, d = 3, 12, 4, 2, 16
    if case == "empty":
        lp, plen = 0, np.zeros(b, np.int32)
    else:
        # "mid_page": prefixes end mid-page (21, 7) and on a page edge (16)
        lp, plen = 32, np.array([21, 7, 16], np.int32)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ks, vs = (rng.standard_normal((b, s, k, d)).astype(np.float32)
              for _ in range(2))
    kp, vp = (rng.standard_normal((b, lp, k, d)).astype(np.float32)
              for _ in range(2))
    pos = (plen[:, None] + np.arange(s)[None]).astype(np.int32)
    if case == "padded":
        # rows of 5 and 9 real tokens in a suffix batch padded to 12
        for i, n in ((1, 5), (2, 9)):
            ks[i, n:] = vs[i, n:] = 0.0
    return q, ks, vs, kp, vp, plen, pos


@pytest.mark.parametrize("case", ["empty", "mid_page", "padded"])
def test_prefix_suffix_attention_matches_jax(case):
    import jax.numpy as jnp
    from repro.models import attention as JA
    args = _attn_inputs(case)
    want = np.asarray(JA.prefix_suffix_attention(
        *(jnp.asarray(a) for a in args)))
    got = A.prefix_suffix_attention(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_empty_prefix_is_the_plain_prefill_path():
    """An empty prefix at positions 0..S-1 is plain causal prefill."""
    q, ks, vs, kp, vp, plen, pos = (torch.from_numpy(a)
                                    for a in _attn_inputs("empty", seed=4))
    got = A.prefix_suffix_attention(q, ks, vs, kp, vp, plen, pos)
    np.testing.assert_allclose(
        got.numpy(), A.flash_ref_attention(q, ks, vs, causal=True).numpy(),
        atol=ATOL)


@pytest.mark.parametrize("stacked", [False, True], ids=["pool", "rep"])
def test_scatter_suffix_pages_matches_jax(stacked):
    """Rows starting mid-page (a copy-on-write tail), on a page edge, and
    a row whose last column is the trash page; every page but the trash
    page compared (duplicate trash writes land in no set order)."""
    import jax.numpy as jnp
    from repro.models import transformer as JT
    rng = np.random.default_rng(1)
    ps, trash = 4, 8
    shape = ((2,) if stacked else ()) + (trash + 1, ps, 2, 8)
    pages = rng.standard_normal(shape).astype(np.float32)
    kv = rng.standard_normal((3, 7, 2, 8)).astype(np.float32)
    page_map = np.array([[5, 0, 3], [6, 2, trash], [1, 7, 4]], np.int32)
    offsets = np.array([3, 0, 2], np.int32)
    rep = 1 if stacked else None
    want = np.asarray(JT.scatter_suffix_pages(
        jnp.asarray(pages), jnp.asarray(kv), jnp.asarray(page_map),
        jnp.asarray(offsets), rep=rep))
    got = torch.from_numpy(pages.copy())
    out = T.scatter_suffix_pages(got, torch.from_numpy(kv),
                                 torch.from_numpy(page_map),
                                 torch.from_numpy(offsets), rep=rep)
    assert out is got                           # in place
    np.testing.assert_array_equal(got.numpy()[..., :trash, :, :, :],
                                  want[..., :trash, :, :, :])


# ---------------------------------------------------------------------------
# the engine recipes of tests/test_prefix_sharing.py and test_resilience.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    import test_torch_engine
    return test_torch_engine._model()


def _servers(model, **kw):
    """A JAX and a port server with the same ServerConfig fields (and the
    same HardwareSpec fields in both estimators)."""
    from repro.core import config as JC
    from repro.core.engine import BulletServer as JServer
    from repro.core.estimator import HardwareSpec as JHardwareSpec
    from repro.core.estimator import PerfEstimator as JPerfEstimator
    from repro.serving.request import SLO as JSLO
    from repro_torch.core.estimator import HardwareSpec, PerfEstimator
    jcfg, cfg, jparams, params = model
    cache = dict(paged=kw.pop("paged", True),
                 page_size=kw.pop("page_size", 16),
                 share_prefix=kw.pop("share_prefix", False))
    fused = kw.pop("fused", None)
    base = dict(max_slots=4, max_len=48)
    base.update(kw)
    js = JServer(jcfg, jparams, config=JC.ServerConfig(
        slo=JSLO(3.0, 150.0), est=JPerfEstimator(JHardwareSpec(**HW)),
        cache=JC.CacheConfig(**cache), execution=JC.ExecConfig(fused=fused),
        **base))
    ts = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=PerfEstimator(HardwareSpec(**HW)),
        cache=CacheConfig(**cache), execution=ExecConfig(fused=fused),
        **base), device="cpu")
    return js, ts


def _drain(srv, now=0.0):
    while not srv.idle:
        srv.step(now)
        srv.check_invariants()
        now += 1e-3
    return now


def _multiturn(srv, req_cls, vocab):
    """tests/test_prefix_sharing.py's three turns: turn 2 is turn 1's
    prompt, its actual outputs and 5 fresh tokens; turn 3 diverges
    mid-page (copy-on-write)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, 20, dtype=np.int32)
    srv.submit(req_cls(rid=0, arrival=0.0, prompt_len=20, output_len=6),
               base)
    _drain(srv)
    p1 = np.concatenate([base, np.asarray(srv.outputs[0], np.int32),
                         rng.integers(0, vocab, 5, np.int32)]).astype(np.int32)
    srv.submit(req_cls(rid=1, arrival=0.0, prompt_len=len(p1),
                       output_len=6), p1)
    _drain(srv)
    p2 = p1.copy()
    p2[-3] = (int(p2[-3]) + 7) % vocab
    srv.submit(req_cls(rid=2, arrival=0.0, prompt_len=len(p2),
                       output_len=5), p2)
    _drain(srv)
    assert srv.pool.available_blocks == srv.pool.n_blocks
    return dict(srv.outputs)


def _sharing_stats(srv):
    st = srv.stats
    return (st.prefill_tokens, st.reused_prefill_tokens, st.prefix_hits,
            srv.pool.ops.cow_copies, srv.pool.ops.shared_hits)


@pytest.mark.parametrize("share", [False, True], ids=["off", "on"])
def test_multiturn_streams_match_jax(model, share):
    from repro.serving.request import Request as JRequest
    vocab = model[1].vocab_size
    js, ts = _servers(model, share_prefix=share)
    want = _multiturn(js, JRequest, vocab)
    got = _multiturn(ts, Request, vocab)
    assert got == want
    assert _sharing_stats(ts) == _sharing_stats(js)
    if share:
        assert ts.stats.prefix_hits == 2
        assert ts.stats.reused_prefill_tokens > 0
        assert ts.pool.ops.cow_copies >= 1
        # the JAX acceptance: at least 2x fewer prefilled tokens
        _, off = _servers(model)
        assert _multiturn(off, Request, vocab) == got
        assert off.stats.prefill_tokens >= 2 * ts.stats.prefill_tokens


def test_share_prefix_requires_paged(model):
    _, cfg, _, params = model
    with pytest.raises(ValueError, match="paged"):
        BulletServer(cfg, params, config=ServerConfig(
            slo=SLO(3.0, 150.0),
            cache=CacheConfig(paged=False, share_prefix=True)), device="cpu")


def test_shared_task_observation_charges_suffix_only(model):
    """A hit batch's cycle observation carries the reused prefix, so the
    refit loop and the virtual clock charge suffix-only prefill."""
    _, ts = _servers(model, share_prefix=True, fused=False)
    vocab = model[1].vocab_size
    rng = np.random.default_rng(2)
    base = rng.integers(0, vocab, 33, dtype=np.int32)
    ts.submit(Request(rid=0, arrival=0.0, prompt_len=33, output_len=2), base)
    now = _drain(ts)
    p = np.concatenate([base, rng.integers(0, vocab, 4, np.int32)])
    ts.submit(Request(rid=1, arrival=now, prompt_len=len(p), output_len=2),
              p)
    ts.step(now)
    obs = ts.last_cycle_observation()
    assert ts.ptask is not None and ts.ptask.prefix_map is not None
    assert (obs.n_tokens, obs.reused_tokens) == (5, 32)


def test_frontend_interactions_share_on_off_match_jax(model):
    """Closed-loop sessions through the OnlineFrontend on the virtual
    clock priced by the estimator: the port's streams are the JAX
    engine's, sharing changes no token, and reuse fires across turns."""
    from repro.serving import frontend as JF
    from repro.serving.workload import generate_interactions as jgen
    from repro_torch.serving import frontend as TF
    from repro_torch.serving.workload import generate_interactions
    streams = {}
    for share in (False, True):
        for srv, F, gen in zip(_servers(model, share_prefix=share,
                                        page_size=4), (JF, TF),
                               (jgen, generate_interactions)):
            fe = F.OnlineFrontend(
                srv, F.VirtualClock(), cycle_cost=F.estimator_cycle_cost,
                on_cycle=lambda s, now: s.check_invariants())
            fe.submit_interactions(
                gen(2, rate_s=100.0, turns=2, new_tokens=10,
                    output_tokens=4, seed=3), model[1].vocab_size, seed=3)
            fe.run()
            done = [r for r in fe.requests if r.phase.name == "FINISHED"]
            assert len(done) >= 3               # follow-up turns issued
            streams[share, F is TF] = (
                {r.rid: list(srv.outputs[r.rid]) for r in done},
                srv.stats.reused_prefill_tokens)
    assert streams[True, True] == streams[True, False]
    assert streams[False, True] == streams[False, False]
    assert streams[True, True][0] == streams[False, True][0]
    assert streams[True, True][1] > 0


def test_paged_to_dense_rung_flushes_shared_prefix(model):
    """tests/test_resilience.py's recipe on both engines: flushing under
    live readers refuses; set_cache_mode unwinds them first, the index
    empties, the requeued requests finish on the dense cache with the JAX
    engine's streams, and the probe back starts from an empty index."""
    from repro.serving.request import Request as JRequest
    vocab = model[1].vocab_size
    runs = []
    for srv, req_cls in zip(_servers(model, share_prefix=True, fused=False,
                                     page_size=4, max_prefill_batch=2),
                            (JRequest, Request)):
        rng = np.random.default_rng(0)
        base = rng.integers(0, vocab, 16, dtype=np.int32)
        srv.submit(req_cls(rid=0, arrival=0.0, prompt_len=16, output_len=4),
                   base)
        now = _drain(srv)
        hist = np.concatenate([base, np.asarray(srv.outputs[0], np.int32)])
        readers = []
        for rid in (1, 2):
            p = np.concatenate([hist, rng.integers(0, vocab, 2 + rid,
                                                   np.int32)]).astype(np.int32)
            r = req_cls(rid=rid, arrival=now, prompt_len=len(p), output_len=6)
            srv.submit(r, p)
            readers.append(r)
        while not all(r.phase.name == "DECODE" for r in readers):
            srv.step(now)
            now += 1e-3
        assert all(srv.pool.table(r.rid).shared_tokens > 0 for r in readers)
        with pytest.raises(RuntimeError):
            srv.pool.flush_shared()         # 2 live readers per page
        srv.set_cache_mode(False, now)      # unwinds readers, then flushes
        assert not srv.paged and srv.pool.cached_blocks == 0
        srv.check_invariants()
        now = _drain(srv, now)
        assert all(len(srv.outputs[r.rid]) == r.output_len for r in readers)
        srv.set_cache_mode(True, now)       # probe-back: fresh empty index
        srv.check_invariants()
        assert srv.pool.available_blocks == srv.pool.n_blocks
        runs.append((dict(srv.outputs), _sharing_stats(srv)))
    assert runs[1] == runs[0]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

class _Eager(StepGraphs):
    """Every step eagerly, on the card too: the reference of the graphs."""

    def __call__(self, key, fn, *inputs):
        return fn(*inputs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["serial", "fused"])
def test_shared_admission_between_decode_replays_equals_eager(card, fused):
    """Request 0 (three pages of prompt, indexed at its migration) decodes
    through graphs (captured, then replayed); request 1, its first 40
    tokens and 9 fresh ones, hits the prefix index and diverges mid-page:
    its copy-on-write copy, suffix groups and first token run between
    request 0's decode replays; request 2 misses and prefills through the
    ``p_group`` graphs. Streams and every page but the trash page equal
    an eager run's, bit for bit."""
    cfg = get_config("qwen3-1.7b").reduced(n_layers=4, head_dim=128)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    p0 = rng.integers(0, cfg.vocab_size, 48).astype(np.int32)
    p1 = np.concatenate([p0[:40], rng.integers(0, cfg.vocab_size, 9)])
    p2 = rng.integers(0, cfg.vocab_size, 30).astype(np.int32)
    runs = []
    for graphed in (True, False):
        srv = BulletServer(cfg, params, config=ServerConfig(
            slo=SLO(3.0, 150.0), max_slots=4, max_len=256,
            cache=CacheConfig(share_prefix=True),
            execution=ExecConfig(fused=fused)), device="cuda")
        if not graphed:
            srv.graphs = _Eager()
        srv.submit(Request(rid=0, arrival=0.0, prompt_len=48,
                           output_len=24), p0)
        now = 0.0
        while srv.stats.decode_iterations < 3:
            srv.step(now)
            now += 1e-3
        srv.submit(Request(rid=1, arrival=now, prompt_len=len(p1),
                           output_len=8), p1)
        srv.submit(Request(rid=2, arrival=now, prompt_len=30,
                           output_len=8), p2)
        hit = False
        while not srv.idle:
            srv.step(now)
            srv.check_invariants()
            t = srv.ptask
            if t is not None and t.prefix_map is not None:
                hit = True
                assert t.x.is_cuda and t.prefix_map.is_cuda
            now += 1e-3
        assert hit and srv.stats.prefix_hits == 1
        assert srv.pool.ops.cow_copies == 1
        assert srv.pool.available_blocks == srv.pool.n_blocks
        if graphed:
            assert {k[0] for k, _ in srv.graphs.captures} >= (
                {"d_rep"} if fused else {"paged"})
        pool = [leaf[key][:, :-1].clone() for leaf in srv.cache["blocks"]
                for key in ("k", "v")]
        runs.append((dict(srv.outputs), pool))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
