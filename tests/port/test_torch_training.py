"""The port's training path on the CPU (``repro_torch.training``,
``repro_torch.data``, ``repro_torch.launch.train``): the recipes of
tests/test_training.py run on the port (reduced Granite-3.0-2B, its params
bridged from the JAX init), and the port held against the JAX package:
the synthetic batches bit for bit, the weight-decay mask leaf by leaf,
each optimizer's update fed the same gradients (fp32, rtol 1e-5 and atol
1e-7: elementwise ops in the same order, XLA may fuse a multiply-add),
checkpoints written by either package loaded by the other bit for bit,
the launcher's host mode and ``run``'s refusal of ``--mode dryrun`` (the
dry-run goes through ``main``, tests/port/test_torch_dryrun.py); and
per-block remat against none (the same gradients bit for bit, the MoE aux
loss counted once)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import init_params as jax_init_params
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, list_configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launcher
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as TC
from repro_torch.training import optimizer as TO
from repro_torch.training.trainer import cross_entropy, make_train_step
from repro_torch.training.tree import leaves, leaves_with_paths

CFG = get_config("granite-3-2b").reduced()
JCFG = jax_config("granite-3-2b").reduced()


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _batches(n, bs=8, seq=32):
    data = SyntheticLM(DataConfig(CFG.vocab_size, seq_len=seq, batch_size=bs,
                                  n_symbols=64))
    for _, b in zip(range(n), data.batches()):
        yield {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# tests/test_training.py's recipes on the port
# ---------------------------------------------------------------------------

def test_loss_decreases_adamw(params):
    init_fn, step_fn = make_train_step(CFG, optimizer="adamw", remat=False,
                                       lr=2e-3, warmup=10)
    state = init_fn(params)
    losses = []
    for batch in _batches(35):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0


def test_loss_decreases_adafactor(params):
    init_fn, step_fn = make_train_step(CFG, optimizer="adafactor",
                                       remat=True, lr=5e-3, warmup=5)
    state = init_fn(params)
    losses = []
    for batch in _batches(25):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.8


def test_grad_accum_matches_full_batch(params):
    batch = next(iter(_batches(1, bs=8)))
    results = {}
    for acc in (1, 2, 4):
        init_fn, step_fn = make_train_step(CFG, optimizer="adamw",
                                           remat=True, accum_steps=acc)
        _, m = step_fn(init_fn(params), batch)
        results[acc] = (float(m["loss"]), float(m["grad_norm"]))
    for acc in (2, 4):
        assert results[acc][0] == pytest.approx(results[1][0], rel=1e-4)
        assert results[acc][1] == pytest.approx(results[1][1], rel=1e-3)


def test_init_copies_and_step_updates_the_state_in_place(params):
    before = [p.clone() for p in leaves(params)]
    init_fn, step_fn = make_train_step(CFG, optimizer="adamw", lr=1e-3,
                                       warmup=1)
    state = init_fn(params)
    ptrs = [p.data_ptr() for p in leaves(state.params)]
    new, _ = step_fn(state, next(iter(_batches(1))))
    assert [p.data_ptr() for p in leaves(new.params)] == ptrs
    assert int(new.opt_state.step) == 1
    for a, b in zip(leaves(params), before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_adafactor_memory_is_factored(params):
    init, _ = TO.make_adafactor()
    st = init(params)
    n_params = sum(x.numel() for x in leaves(params))
    n_state = sum(x.numel() for x in leaves((st.vr, st.vc)))
    assert n_state < 0.1 * n_params


def test_optimizer_selection_by_size():
    assert TO.optimizer_for(8e9) == "adamw"
    assert TO.optimizer_for(140e9) == "adafactor"
    for name in list_configs():
        assert TO.optimizer_for(get_config(name).n_params) == \
            JO.optimizer_for(jax_config(name).n_params)


def test_cross_entropy_matches_manual_and_jax():
    from repro.training.trainer import cross_entropy as jce
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 4, 16)).astype(np.float32)
    labels = rng.integers(0, 16, (2, 4)).astype(np.int32)
    mask = (rng.random((2, 4)) < 0.7).astype(np.float32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    manual = -torch.log_softmax(lt, -1).gather(-1, yt.long()[..., None]).mean()
    assert float(cross_entropy(lt, yt)) == pytest.approx(float(manual),
                                                         rel=1e-5)
    for m in (None, mask):
        want = jce(jnp.asarray(logits), jnp.asarray(labels),
                   None if m is None else jnp.asarray(m))
        got = cross_entropy(lt, yt, None if m is None else torch.from_numpy(m))
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_checkpoint_roundtrip(params, tmp_path):
    path = os.path.join(tmp_path, "ckpt.npz")
    TC.save_checkpoint(path, params, step=7)
    restored, step = TC.load_checkpoint(path, params)
    assert step == 7
    for a, b in zip(leaves(params), leaves(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_synthetic_data_learnable_structure():
    """The Markov source must be lower-entropy than uniform."""
    data = SyntheticLM(DataConfig(512, seq_len=64, batch_size=4,
                                  n_symbols=32))
    b = next(iter(data.batches()))
    toks = b["tokens"].ravel()
    _, counts = np.unique(toks, return_counts=True)
    assert len(counts) <= 32            # restricted symbol set
    assert b["tokens"].shape == (4, 64)
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,n_symbols", [(0, 512, 32),
                                                  (3, 151936, 256)])
def test_synthetic_batches_equal_jax(seed, vocab, n_symbols):
    ours = SyntheticLM(DataConfig(vocab, seq_len=33, batch_size=3,
                                  n_symbols=n_symbols, seed=seed)).batches()
    theirs = JSyntheticLM(JDataConfig(vocab, seq_len=33, batch_size=3,
                                      n_symbols=n_symbols,
                                      seed=seed)).batches()
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", list_configs())
def test_wd_mask_and_keys_match_jax_leaf_by_leaf(name):
    jp = jax.eval_shape(lambda: jax_init_params(
        jax_config(name).reduced(), jax.random.PRNGKey(0), jnp.float32))
    ours = T.init_params(get_config(name).reduced(), seed=0,
                         dtype=torch.float32, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = list(leaves_with_paths(ours))
    assert len(jl) == len(tl)
    for (jpath, jleaf), (tpath, tleaf) in zip(jl, tl):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in jpath)
        assert key == "/".join(str(k) for k in tpath)
        assert tuple(tleaf.shape) == jleaf.shape, key
        assert TO._wd_mask(tpath) == JO._wd_mask(jpath), key


def _random_grads(jp, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32) * 1e-2, jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_update_matches_jax(jparams, opt):
    """Three updates of each optimizer fed the same gradients (numpy):
    the port's params and moments equal the JAX update's."""
    kw = dict(lr=1e-2, warmup=2)
    j_init, j_update = JO.make_optimizer(opt, **kw)
    t_init, t_update = TO.make_optimizer(opt, **kw)
    jp = jparams
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    js, ts = j_init(jp), t_init(tp)
    j_update = jax.jit(j_update)
    for i in range(3):
        g = _random_grads(jp, i)
        jp, js = j_update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = t_update(params_from_jax(g, device="cpu"), ts, tp)
        assert int(ts.step) == int(js.step) == i + 1
    for a, b in zip(jax.tree.leaves((jp, js[1:])), leaves((tp, ts[1:]))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)


def test_checkpoints_load_across_packages(jparams, params, tmp_path):
    path_j = os.path.join(tmp_path, "jax.npz")
    JC.save_checkpoint(path_j, jparams, step=3, extra={"from": "jax"})
    restored, step = TC.load_checkpoint(path_j, params)
    assert step == 3
    for a, b in zip(jax.tree.leaves(jparams), leaves(restored)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    path_t = os.path.join(tmp_path, "torch")        # np.savez adds .npz
    TC.save_checkpoint(path_t, params, step=5)
    back, step = JC.load_checkpoint(path_t + ".npz", jparams)
    assert step == 5
    for a, b in zip(leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
    with np.load(path_t + ".npz") as ours, np.load(path_j) as theirs:
        assert sorted(ours.files) == sorted(theirs.files)


def test_launcher_host_mode_on_cpu(capsys, tmp_path):
    ckpt = os.path.join(tmp_path, "run.npz")
    run = launcher.run(launcher.parse_args(
        ["--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
         "--checkpoint", ckpt]))
    out = capsys.readouterr().out
    assert "training qwen3-1.7b-reduced" in out
    assert "step    0 loss" in out and "step   10 loss" in out \
        and "step   11 loss" in out
    assert f"saved {ckpt}" in out
    assert len(run.losses) == 12 and run.peak_bytes is None
    assert all(np.isfinite(run.losses)) and run.losses[-1] < run.losses[0]
    restored, step = TC.load_checkpoint(ckpt, run.state.params)
    assert step == 12
    for a, b in zip(leaves(run.state.params), leaves(restored)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_launcher_dryrun_raises():
    with pytest.raises(ValueError, match="main"):
        launcher.run(launcher.parse_args(["--mode", "dryrun"]))


@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b",
                                  "seamless-m4t-large-v2"])
def test_remat_gives_the_same_gradients_and_counts_aux_once(name):
    """Per-block remat recomputes each block in the backward; the MoE aux
    loss, an output of the checkpointed block, is counted once."""
    from repro_torch.training.trainer import compute_grads
    cfg = get_config(name).reduced()
    p = T.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.n_encoder_layers:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.frontend_embed_dim)).astype(
                np.float32))
    (g0, m0), (g1, m1) = (compute_grads(p, batch, cfg, remat=r)
                          for r in (False, True))
    assert float(m0["aux"]) == float(m1["aux"])
    assert (float(m1["aux"]) > 0) == cfg.has_ff("moe")
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(leaves(g0), leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_keeps_a_bf16_leaf_exactly(tmp_path):
    """numpy has no bf16: a bf16 leaf is stored as float32 (which holds it
    exactly) and rounded back to the dtype of the tree it loads into."""
    tree = {"a": torch.randn(3, 4).bfloat16(), "b": (torch.randn(2),)}
    path = os.path.join(tmp_path, "bf16.npz")
    TC.save_checkpoint(path, tree, step=1)
    with np.load(path) as data:
        assert data["a"].dtype == np.float32 and "b/0" in data.files
    restored, _ = TC.load_checkpoint(path, tree)
    assert restored["a"].dtype == torch.bfloat16
    torch.testing.assert_close(restored["a"], tree["a"], rtol=0, atol=0)
    torch.testing.assert_close(restored["b"][0], tree["b"][0], rtol=0,
                               atol=0)
