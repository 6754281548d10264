"""The sharded runtime (ROADMAP §1 item 8d) on the CPU, over gloo ranks:
``launch/mesh.run_on_mesh`` spawns one process a rank, one spawn a mesh
(``tests/port/sharded_recipes.py`` holds the rank programs), while this
process runs the JAX package's single-device functions and the port's own
on the same numpy inputs.

- ``tests/test_sharded_numerics.py``'s recipes on the 2×4 mesh (qwen3
  8/4; granite 8/1 and codeqwen 6/3, sequence parallel; mixtral 8/4,
  token-parallel and with 2D expert weights; mamba2) and reduced
  RecurrentGemma 4/1, on the 2×2×2 multipod mesh qwen3 8/2 and mixtral
  8/2: the gathered ``forward``, ``prefill`` and ``decode_step`` logits
  within the JAX script's bound of 5e-3 of the logits' scale of the JAX
  single-device functions, within 1e-4 of it of the port's unsharded ones
  (measured: a few 1e-6; sums in another order), the gathered cache
  within 1e-4 of its scale of the unsharded one, and every policy flag as
  the JAX script asserts it;
- ``tests/test_models.py``'s sequence-parallel decode (atol 1e-5 of the
  JAX ``decode_attention``) and ring write (equal to the JAX
  ``write_cache_slot``) on a 1×4 mesh;
- two sharded AdamW steps and one Adafactor step with FSDP of reduced
  qwen3 on 2×4 against the JAX unsharded step: loss and grad norm within
  1e-5 relative, the params within 1e-6 of each leaf's scale (AdamW's
  ``eps`` at 1e-3 on both sides, so that the first step's update
  g / (|g| + eps) is smooth in the gradient: at the default 1e-8 it is
  the gradient's sign, which a rounding flips on the leaves' near-zero
  entries);
- ``shard_tree`` then ``gather_tree`` is the identity (packed leaves
  included), the policy's seeded init equals the cut, each rank's bytes
  equal ``sharded_resident_gb``;
- the runtime's own rules: the backend from the device list, a failing
  rank fails the run.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_recipes as R
from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.training.trainer import make_train_step as jax_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.sharding import make_policy
from repro_torch.training.tree import leaves, leaves_with_paths

#: the JAX script's bound, of the logits' scale
JAX_TOL = 5e-3
#: against the port's unsharded functions, of the scale
PORT_TOL = 1e-4
#: the train steps: loss and grad norm relative, params of each leaf's
#: scale
TRAIN_TOL, PARAM_TOL = 1e-5, 1e-6
STEP_KW = dict(lr=1e-3, warmup=1, remat=True)

#: name -> (arch, heads, kv, policy kwargs, seq_parallel_decode expected)
MODELS = {
    "qwen3": ("qwen3-1.7b", 8, 4, {}, False),
    "granite": ("granite-3-2b", 8, 1, {}, True),
    "codeqwen": ("codeqwen1.5-7b", 6, 3, {}, True),
    "mixtral": ("mixtral-8x22b", 8, 4, {}, False),
    "mixtral_2d": ("mixtral-8x22b", 8, 4, {"moe_2d_weights": True}, False),
    "mamba2": ("mamba2-2.7b", 0, 0, {}, False),
    "recurrentgemma": ("recurrentgemma-2b", 4, 1, {}, True),
}
MULTIPOD = {
    "qwen3_pod": ("qwen3-1.7b", 8, 2, {}, False),
    "mixtral_pod": ("mixtral-8x22b", 8, 2, {}, None),
}
#: name -> (arch, heads, kv, policy kwargs, step kwargs, steps); the MoE
#: step takes the whole-batch dispatch, as the JAX train step does
TRAIN = {
    "adamw": ("qwen3-1.7b", 8, 4, {}, dict(optimizer="adamw", eps=1e-3),
              2),
    "adafactor_fsdp": ("qwen3-1.7b", 8, 4, {"fsdp": True},
                       dict(optimizer="adafactor"), 1),
    "mixtral_adamw": ("mixtral-8x22b", 8, 4, {"moe_token_shard_map": False},
                      dict(optimizer="adamw", eps=1e-3), 1),
}
#: placement cases: packed leaves (gated MLP, MoE 2D, SSD sections,
#: RG-LRU) under FSDP and 2D layouts
PLACEMENT = {
    "qwen3_fsdp": ("qwen3-1.7b", 8, 4, {"fsdp": True}),
    "mixtral_2d": ("mixtral-8x22b", 8, 4, {"moe_2d_weights": True}),
    "mamba2_fsdp": ("mamba2-2.7b", 0, 0, {"fsdp": True}),
    "recurrentgemma": ("recurrentgemma-2b", 4, 1, {}),
}


def _jcfg(arch, heads, kv):
    cfg = jax_config(arch).reduced(n_heads=heads, n_kv_heads=kv,
                                   d_model=128, head_dim=32)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    return cfg


@functools.lru_cache(maxsize=None)
def _inputs(arch, heads, kv):
    """The JAX params (numpy) and the seeded tokens of one config."""
    cfg = _jcfg(arch, heads, kv)
    params = JT.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (R.B, R.S), dtype=np.int32)
    return jax.tree.map(np.asarray, params), toks


def _jax_single(arch, heads, kv):
    cfg = _jcfg(arch, heads, kv)
    params, toks = _inputs(arch, heads, kv)
    lens = jnp.array([R.S0] * R.B)
    fwd = jax.jit(lambda p, t: JT.forward(p, t, cfg)[0])(params, toks)
    cache = JT.init_cache(cfg, R.B, R.S + 4, jnp.float32)
    pre, cache = jax.jit(lambda p, t, n, c: JT.prefill(p, t, n, c, cfg))(
        params, toks[:, :R.S0], lens, cache)
    dec, _ = jax.jit(lambda p, c, t, q: JT.decode_step(p, c, t, q, cfg))(
        params, cache, toks[:, R.S0:R.S0 + 1], lens)
    return {k: np.asarray(v) for k, v in
            (("forward", fwd), ("prefill", pre), ("decode", dec))}


def _port_single(arch, heads, kv):
    cfg = R.reduced(arch, heads, kv)
    params, toks = _inputs(arch, heads, kv)
    p = params_from_jax(params, device="cpu")
    t = torch.from_numpy(toks)
    lens = torch.full((R.B,), R.S0, dtype=torch.int32)
    with torch.no_grad():
        fwd, _ = T.forward(p, t, cfg)
        cache = T.init_cache(cfg, R.B, R.S + 4, torch.float32, "cpu")
        pre, cache = T.prefill(p, t[:, :R.S0], lens, cache, None, cfg)
        dec, cache = T.decode_step(p, cache, t[:, R.S0:R.S0 + 1],
                                   lens.clone(), cfg)
    return {"forward": fwd.numpy(), "prefill": pre.numpy(),
            "decode": dec.numpy(), "cache": cache}


def _model_jobs(table):
    return [(name, arch, h, k, kw, *_inputs(arch, h, k))
            for name, (arch, h, k, kw, _) in table.items()]


def _train_cases():
    rng = np.random.default_rng(2)
    cases = []
    for name, (arch, h, k, kw, step_kw, steps) in TRAIN.items():
        params, _ = _inputs(arch, h, k)
        cfg = _jcfg(arch, h, k)
        batches = [{key: rng.integers(0, cfg.vocab_size, (R.B, R.S),
                                      dtype=np.int32)
                    for key in ("tokens", "labels")} for _ in range(steps)]
        cases.append((name, arch, h, k, kw, dict(STEP_KW, **step_kw),
                      params, batches))
    return cases


def _jax_train(case):
    _, arch, h, k, _, step_kw, params, batches = case
    cfg = _jcfg(arch, h, k)
    init_fn, step_fn = jax_train_step(cfg, **step_kw)
    step_fn = jax.jit(step_fn)
    state = init_fn(jax.tree.map(jnp.asarray, params))
    metrics = []
    for batch in batches:
        state, m = step_fn(state, batch)
        metrics.append(tuple(float(m[key]) for key in
                             ("loss", "aux", "grad_norm")))
    return metrics, jax.tree.map(np.asarray, state.params)


def _seq_inputs():
    """tests/test_models.py's recipes, the cache long enough to split."""
    rng = np.random.default_rng(3)
    b, s, h, k, d = 2, 32, 8, 2, 16
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, k, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, k, d)).astype(np.float32)
    kvpos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    pos = np.array([10, 31], dtype=np.int32)
    new = rng.normal(size=(b, 1, k, d)).astype(np.float32)
    slot = np.array([3, 15], dtype=np.int32)
    return q, kc, vc, kvpos, pos, new, slot


@pytest.fixture(scope="module")
def runs():
    """The three spawns, one after another in a thread of this process
    (at most 8 ranks at once), while the JAX and port references run
    here."""
    jobs_2x4 = {"models": ("models", (_model_jobs(MODELS),)),
                "train": ("train", (_train_cases(),)),
                "placement": ("placement", ([
                    (n, *c) for n, c in PLACEMENT.items()],))}
    jobs_pod = {"models": ("models", (_model_jobs(MULTIPOD),))}
    jobs_seq = {"seq": ("seq_parallel", _seq_inputs())}
    spawns = {"2x4": ((2, 4), jobs_2x4), "pod": ((2, 2, 2), jobs_pod),
              "seq": ((1, 4), jobs_seq)}

    def run_all():
        return {key: M.run_on_mesh(R.suite, M.mesh_shape(sizes), jobs,
                                   device="cpu")[0]
                for key, (sizes, jobs) in spawns.items()}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_all)
        refs = {}
        for name, (arch, h, k, _, _) in {**MODELS, **MULTIPOD}.items():
            refs[name] = (_jax_single(arch, h, k), _port_single(arch, h, k))
        train = {c[0]: _jax_train(c) for c in _train_cases()}
        out = fut.result()
    return out, refs, train


def _scale(a) -> float:
    return max(float(np.abs(a).max()), 1.0)


@pytest.mark.parametrize("name", list(MODELS) + list(MULTIPOD))
def test_sharded_model_matches_jax_and_unsharded(runs, name):
    out, refs, _ = runs
    got = out["pod" if name in MULTIPOD else "2x4"]["models"][name]
    arch, heads, kv, kw, seq_par = {**MODELS, **MULTIPOD}[name]
    if seq_par is not None:
        assert got["policy"]["seq_parallel_decode"] == seq_par
    jax_ref, port_ref = refs[name]
    # the padded vocab's -1e30 is no scale
    scale = _scale(jax_ref["forward"][..., :_jcfg(arch, heads, kv).vocab_size])
    for what in ("forward", "prefill", "decode"):
        err = float(np.abs(got[what] - jax_ref[what]).max())
        assert err < JAX_TOL * scale, (name, what, err, scale)
        err = float(np.abs(got[what] - port_ref[what]).max())
        assert err < PORT_TOL * scale, (name, what, err, scale)
    for (path, want), have in zip(leaves_with_paths(port_ref["cache"]),
                                  leaves(got["cache"])):
        want = want.numpy()
        err = float(np.abs(have - want).max())
        assert err <= PORT_TOL * _scale(want), (name, path, err)


def test_policy_flags_as_the_jax_script_asserts(runs):
    out, _, _ = runs
    flags = {n: r["policy"] for n, r in out["2x4"]["models"].items()}
    assert flags["qwen3"]["shard_heads"] and flags["qwen3"]["shard_kv_heads"]
    assert flags["granite"]["shard_heads"]
    assert not flags["granite"]["shard_kv_heads"]
    assert not flags["codeqwen"]["shard_heads"]
    assert flags["mixtral"]["shard_experts"]
    assert all(f["shard_vocab"] and f["shard_batch"] for f in flags.values())


def test_sequence_parallel_decode_and_ring_write(runs):
    out, _, _ = runs
    o, cache = out["seq"]["seq"]
    q, kc, vc, kvpos, pos, new, slot = _seq_inputs()
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(kvpos),
                               jnp.asarray(pos))
    np.testing.assert_allclose(o, np.asarray(want), atol=1e-5, rtol=0)
    ring = JA.write_cache_slot(jnp.asarray(kc), jnp.asarray(new),
                               jnp.asarray(slot))
    np.testing.assert_array_equal(cache, np.asarray(ring))


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_step_matches_jax(runs, name):
    out, _, train = runs
    got_m, got_p = out["2x4"]["train"][name]
    want_m, want_p = train[name]
    for g, w in zip(got_m, want_m):
        assert abs(g[0] - w[0]) <= TRAIN_TOL * abs(w[0]), (g, w)
        assert abs(g[2] - w[2]) <= TRAIN_TOL * abs(w[2]), (g, w)
    for (path, w), g in zip(leaves_with_paths(want_p), leaves(got_p)):
        err = float(np.abs(g - w).max())
        assert err <= PARAM_TOL * _scale(w), (name, path, err)


# ---------------------------------------------------------------------------
# the dry-run's per-device terms
# ---------------------------------------------------------------------------

def test_dryrun_per_device_terms_on_the_multipod_mesh():
    from repro_torch.launch import dryrun
    r = dryrun.run_one("qwen3-1.7b", "decode_32k", multi_pod=True,
                       verbose=False)
    dev = r["roofline_per_device"]
    assert dev["devices"] == 512
    assert dev["terms"]["collective_s"] > 0
    assert dev["flops"] * dev["devices"] >= r["roofline"]["flops"]
    # 8 KV heads on a 16-wide model axis: the sequence-parallel decode,
    # whose partial is plain PyTorch (kernel 4 does not run)
    assert r["policy"]["seq_parallel_decode"]
    assert "decode_attention" not in dev["kernels"]


@pytest.mark.parametrize("sizes,sharded", [((1, 1), False), ((1, 2), True)])
def test_collectives_exactly_where_the_policy_shards(sizes, sharded):
    from repro_torch.launch.dryrun import trace
    from repro_torch.launch.specs import build_dryrun
    with M.fake_mesh(M.mesh_shape(sizes)) as mesh:
        fn, args, *_ = build_dryrun("qwen3-1.7b", "decode_32k", mesh)
        counter, _ = trace(fn, args)
    coll = counter.report.terms()["collective_s"]
    assert (coll > 0) == sharded, (sizes, coll)


@pytest.mark.parametrize("name", list(PLACEMENT))
def test_shard_then_gather_is_the_identity(runs, name):
    out, _, _ = runs
    err, same, nbytes, resident = out["2x4"]["placement"][name]
    assert err == 0.0
    assert same
    assert nbytes == resident


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        M.run_on_mesh(R.fail_on_rank, M.mesh_shape((1, 2)), 1,
                      device="cpu", timeout=120)


def test_a_mesh_shape_runs_nothing():
    cfg = R.reduced("qwen3-1.7b", 8, 4)
    policy = make_policy(cfg, M.mesh_shape((2, 4)), global_batch=R.B)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.zeros((R.B, R.S), dtype=torch.int32)
    with pytest.raises(ValueError, match="runs no ranks"):
        T.forward(params, toks, cfg, policy=policy)


def test_backend_from_the_device_list():
    assert M.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert M.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert M.backend_for(["cpu"] * 4) == "gloo"
    assert M.rank_devices(4, device="cpu") == ["cpu"] * 4
    assert M.rank_devices(2, ["cuda:0", "cuda:0"]) == ["cuda:0", "cuda:0"]
    with pytest.raises(ValueError):
        M.rank_devices(3, ["cuda:0"])
