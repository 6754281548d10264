"""Head dim 64 and the three architectures of this slice on the CPU:
Granite-3.0-2B (paged, D = 64, G = 4), SeamlessM4T-Large-v2 (encoder,
cross-attention, D = 64, G = 1) and InternVL2-76B (its frontend projector).

- The port's plain attention at D = 64 (what every wrapper runs for CPU
  tensors, and what the CUDA kernels are held against on the card)
  against the JAX package's Pallas kernels in interpret mode, fp32, atol
  ``ATOL`` = 2e-5 (the attention tests' tolerance): flash non-causal with
  Sq != Sk (the cross-attention's shape) and causal at G = 4, dense decode
  over a cross cache whose every row is attended and over a wrapped ring,
  paged decode, both fused kernels at three decode shares, and the bf16
  split bodies' plain split-and-merge mirrors (``kernels/ref.py``).
- The param and cache trees of ``init_params`` / ``init_cache`` against
  the JAX package's, leaf for leaf (the encoder stack, ``encoder_norm``,
  ``frontend_proj``, ``ln_cross`` and ``cwq/cwk/cwv/cwo``, the cross
  cache), and ``param_count`` against the JAX one.
- Reduced Granite (its own 32 query heads on 8 kv heads, D = 64) through
  the port's ``BulletServer`` against the JAX one, fused and serial:
  greedy streams and per-cycle observations identical; the launcher
  serves it at D = 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import estimator as JE
from repro.core.config import ControlConfig as JControlConfig
from repro.core.config import ExecConfig as JExecConfig
from repro.core.config import ServerConfig as JServerConfig
from repro.core.engine import BulletServer as JServer
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.kernels import bullet_attention_op as jax_bullet_op
from repro.kernels import bullet_attention_paged_op as jax_bullet_paged_op
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as jax_paged
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import param_count as jax_param_count
from repro.serving.request import Request as JRequest
from repro.serving.request import SLO as JSLO
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.config import ControlConfig, ExecConfig, ServerConfig
from repro_torch.core.engine import BulletServer
from repro_torch.core.estimator import HardwareSpec, PerfEstimator
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.kernels import decode_attention as TD
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as TP
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving.request import SLO, Request

ATOL = 2e-5
D = 64
ARCHS = ("granite-3-2b", "seamless-m4t-large-v2", "internvl2-76b")


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the plain kernels at D = 64 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal,sq,sk", [(False, 64, 256), (True, 256, 256)],
                         ids=["cross", "causal"])
def test_flash_d64_matches_pallas(causal, sq, sk, g):
    """Kernel layout, 2 kv heads of ``g`` query heads: non-causal with 64
    queries over 256 keys (the cross-attention's Sq != Sk; G = 1 is
    Seamless's), and causal at Sq = Sk (G = 4 is Granite's)."""
    rng = np.random.default_rng(sq + g)
    q = _normal(rng, 2 * g, sq, D)
    k, v = _normal(rng, 2, sk, D), _normal(rng, 2, sk, D)
    got = TF.flash_attention(_t(q), _t(k), _t(v), causal=causal, group=g)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=64, block_k=128, group=g,
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def _dense_cases(seed, b=3, kh=2, g=4, s=200):
    """Three slots over S = 200 rows: the cross cache (positions 0..S-1,
    pos S-1: every row attended, as decode reads Seamless's cross cache), a
    linear cache with rows past pos, and a ring that has wrapped."""
    rng = np.random.default_rng(seed)
    j = np.arange(s)
    pos = np.array([s - 1, 150, 450], np.int32)
    kvpos = np.stack([j, j, pos[2] - np.remainder(pos[2] - j, s)]).astype(
        np.int32)
    return (_normal(rng, b, kh, g, D), _normal(rng, b, s, kh, D),
            _normal(rng, b, s, kh, D), kvpos, pos)


@pytest.mark.parametrize("g", [1, 4])
def test_dense_decode_d64_matches_pallas(g):
    """The plain version and the bf16 body's split mirror (1, 2 and 7
    pieces over the 4 row tiles) against the Pallas decode kernel."""
    args = _dense_cases(g, g=g)
    want = _np(jax_decode(*map(jnp.asarray, args), block_s=64,
                          interpret=True))
    targs = [_t(a) for a in args]
    np.testing.assert_allclose(TD.decode_attention(*targs).numpy(), want,
                               atol=ATOL)
    for n in (1, 2, 7):
        np.testing.assert_allclose(
            ref.decode_attention_split_ref(*targs, n).numpy(), want,
            atol=ATOL)


def _paged_case(seed, ps=16, kh=2, g=4, rows=256):
    """4 slots over a pool of ``ps``-row pages: contexts 1, 64, 150 and an
    inactive slot, the pages shuffled, the trash page past each slot's
    live pages full of large garbage."""
    rng = np.random.default_rng(seed)
    contexts = (1, 64, 150, 0)
    need = [-(-c // ps) for c in contexts]
    n_pages = sum(need) + 2
    kp, vp = _normal(rng, n_pages + 1, ps, kh, D), \
        _normal(rng, n_pages + 1, ps, kh, D)
    kp[n_pages], vp[n_pages] = 1e4, -1e4
    perm = rng.permutation(n_pages)
    bt = np.full((len(contexts), rows // ps), n_pages, np.int32)
    used = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[used:used + n]
        used += n
    pos = np.array([c - 1 for c in contexts], np.int32)
    return _normal(rng, len(contexts), kh, g, D), kp, vp, bt, pos


def test_paged_decode_d64_matches_pallas():
    """Active slots (the inactive one: zeros from the kernels and their
    split mirror, the mean of V from the plain version, as at every D)."""
    args = _paged_case(3)
    want = _np(jax_paged(*map(jnp.asarray, args), interpret=True))
    targs = [_t(a) for a in args]
    act = args[4] >= 0
    np.testing.assert_allclose(TP.paged_decode_attention(*targs).numpy()[act],
                               want[act], atol=ATOL)
    for n in (1, 3, 7):
        got = ref.paged_decode_attention_split_ref(*targs, n).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("share", [0.1, 0.5, 0.9])
def test_fused_d64_matches_pallas(share):
    """Both fused kernels in model layout (a prefill batch of 2 x 128
    tokens, 8 query heads on 2 kv heads): the paged one over
    ``_paged_case``'s pool, the dense one over ``_dense_cases``' caches."""
    rng = np.random.default_rng(int(share * 10))
    qp = _normal(rng, 2, 128, 8, D)
    kp, vp = _normal(rng, 2, 128, 2, D), _normal(rng, 2, 128, 2, D)
    qd, kpg, vpg, bt, pos = _paged_case(5)
    qd = qd.reshape(qd.shape[0], 1, -1, D)
    op, od = ops.bullet_attention_paged_op(
        *map(_t, (qp, kp, vp, qd, kpg, vpg, bt, pos)), decode_share=share)
    pp, pd = jax_bullet_paged_op(*map(jnp.asarray, (qp, kp, vp, qd, kpg,
                                                    vpg, bt, pos)),
                                 decode_share=share, interpret=True)
    act = pos >= 0
    np.testing.assert_allclose(op.numpy(), _np(pp), atol=ATOL)
    np.testing.assert_allclose(od.numpy()[act], _np(pd)[act], atol=ATOL)
    q, kc, vc, kvpos, dpos = _dense_cases(7)
    q = q.reshape(q.shape[0], 1, -1, D)
    op, od = ops.bullet_attention_op(
        *map(_t, (qp, kp, vp, q, kc, vc, kvpos, dpos)), decode_share=share)
    pp, pd = jax_bullet_op(*map(jnp.asarray, (qp, kp, vp, q, kc, vc, kvpos,
                                              dpos)),
                           decode_share=share, interpret=True)
    np.testing.assert_allclose(op.numpy(), _np(pp), atol=ATOL)
    np.testing.assert_allclose(od.numpy(), _np(pd), atol=ATOL)


# ---------------------------------------------------------------------------
# the param and cache trees
# ---------------------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(v) for v in tree)
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_match_jax(arch):
    """``init_params`` and ``init_cache`` give the JAX package's trees
    (names, nesting and shapes), and ``param_count`` its count."""
    jcfg = jax_config(arch).reduced(head_dim=D)
    cfg = get_config(arch).reduced(head_dim=D)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    assert _shapes(params) == _shapes(jparams)
    assert T.param_count(params) == jax_param_count(jparams)
    cache = T.init_cache(cfg, 2, 40, torch.float32, "cpu")
    assert _shapes(cache) == _shapes(jax_init_cache(jcfg, 2, 40,
                                                    jnp.float32))
    assert ("encoder" in params) == ("cross" in cache) == (
        arch == "seamless-m4t-large-v2")
    assert ("frontend_proj" in params) == (arch != "granite-3-2b")


def test_granite_is_served_at_its_head_dim():
    cfg = serve.model_config("granite-3-2b")
    assert cfg.head_dim == 64 and T.supports_paged_cache(cfg)
    full = get_config("granite-3-2b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim) == (40, 2048, 32, 8, 64)


# ---------------------------------------------------------------------------
# reduced Granite through both engines
# ---------------------------------------------------------------------------

#: test_torch_engine.py's spec fields: a small partition table
HW = dict(name="h100-sxm", n_chips=1, peak_flops=989e12, hbm_bw=3.35e12,
          ici_bw=450e9, units_per_chip=8, grid_slots=8)


def _granite():
    """Reduced Granite at its own heads (32 on 8, G = 4) and D = 64."""
    kw = dict(head_dim=D, n_heads=32, n_kv_heads=8)
    jcfg = jax_config("granite-3-2b").reduced(**kw)
    cfg = get_config("granite-3-2b").reduced(**kw)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _drive(server, max_cycles=600):
    """Step until idle on the virtual clock (cycle i at i ms), auditing
    every cycle; returns the per-cycle (CycleObservation, fused?) trace."""
    trace, now = [], 0.0
    for _ in range(max_cycles):
        if server.idle:
            break
        server.step(now)
        server.check_invariants()
        trace.append((server.last_cycle_observation(), server.last_fused))
        now += 1e-3
    assert server.idle
    return trace


@pytest.mark.parametrize("fused", [False, True], ids=["serial", "fused"])
def test_granite_streams_match_jax(fused):
    """6 requests of 4-40 tokens, 8 out each, 4 slots, one prompt per
    prefill batch, the pause off: the port's greedy streams and per-cycle
    observations equal the JAX engine's (and the fused run fuses)."""
    jcfg, cfg, jparams, params = _granite()
    base = dict(max_slots=4, max_len=64, max_prefill_batch=1)
    js = JServer(jcfg, jparams, config=JServerConfig(
        slo=JSLO(3.0, 150.0), est=JE.PerfEstimator(JE.HardwareSpec(**HW)),
        execution=JExecConfig(fused=fused),
        control=JControlConfig(
            sched=JSchedulerConfig(max_decode_pause_cycles=0)), **base))
    ts = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=PerfEstimator(HardwareSpec(**HW)),
        execution=ExecConfig(fused=fused),
        control=ControlConfig(sched=SchedulerConfig(
            max_decode_pause_cycles=0)), **base), device="cpu")
    assert ts.paged and js.paged
    rng = np.random.default_rng(0)
    for rid in range(6):
        plen = int(rng.integers(4, 40))
        prompt = rng.integers(0, cfg.vocab_size, plen)
        js.submit(JRequest(rid=rid, arrival=0.0, prompt_len=plen,
                           output_len=8), prompt)
        ts.submit(Request(rid=rid, arrival=0.0, prompt_len=plen,
                          output_len=8), prompt)
    jtrace, ttrace = _drive(js), _drive(ts)
    assert ts.outputs == js.outputs
    assert all(len(v) == 8 for v in ts.outputs.values())
    assert ttrace == jtrace
    assert ts.stats.fused_cycles == js.stats.fused_cycles
    assert (ts.stats.fused_cycles > 0) == fused


def test_serve_host_granite_on_cpu(capsys):
    assert serve.main(["--arch", "granite-3-2b", "--mode", "host",
                       "--device", "cpu", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert "KV pool clean: True" in out
