"""One train step of every registered architecture (reduced, B 2, S 16, the
tests/test_smoke_archs.py recipe: random tokens and labels, a random
frontend where the config has one), the port against the JAX package on
the CPU, params bridged from the JAX init, remat on, in fp32 (the cases
named by the arch alone) and in bf16 (``-bf16``):

- the loss, the aux loss and every gradient leaf against
  ``jax.value_and_grad(loss_fn)``: the loss within rtol 1e-5, each leaf
  within 2e-5 of its own scale max|g| (measured up to 3.7e-6, on
  RecurrentGemma; both sides sum fp32 products in other orders);
- the port's ``step_fn`` (AdamW, lr 1e-3, warmup 2): its grad norm
  against the JAX step's (the norm of the JAX gradients, rtol 1e-5), and
  its updated params against the JAX optimizer's update of the JAX
  gradients clipped as the JAX step clips them, compared apart from the
  gradients: Adam's first step moves each param by about lr_t·sign(g), so
  an element whose gradient is near 0 may step the other way in the two
  frameworks. Elements with |g| above 1e-3 of the leaf's scale must agree
  within 1e-6; every element within 2·lr_t + 1e-6.

In bf16 both sides start from the JAX ``init_params(..., jnp.bfloat16)``
(the port keeps ``A_log`` and ``lambda`` in fp32, holding the same
values) and run the model in bf16, rounding at other places (XLA's
fusions against PyTorch's ops, the JAX attention's bf16 intermediates
against the port's plain backward in fp32; JAX holds RG-LRU's ``lambda``
in bf16, the port in fp32): the loss and aux within rtol 2e-3 (measured
up to 5.8e-4), each gradient leaf within 1e-1 of its scale (measured up to
5.7e-2, RecurrentGemma's (64,) ``lambda``; 2.5e-2 elsewhere) and within
6e-2 of its norm in L2 (measured up to 4.8e-2, the same leaf; 2.5e-2
elsewhere), the grad norm within rtol 1e-2 (measured up to 3.8e-3). The
step's update is fp32 and cast back to bf16 on both sides, each rounding
once: every element within 2·lr_t and one bf16 ulp of the JAX value (a
gradient near 0 may step the other way), and elements whose JAX gradient
is above BF16_SURE of the leaf's scale (Adam's first step then moves them
by about lr_t·sign(g) on both sides) within one bf16 ulp (of the param
before or after the step: a step that nearly cancels the param leaves
the difference of the two sides' updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.training import optimizer as JO
from repro.training.trainer import loss_fn as jax_loss_fn
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, list_configs
from repro_torch.training.trainer import compute_grads, make_train_step
from repro_torch.training.tree import leaves

B, S = 2, 16
LR, WARMUP = 1e-3, 2
GRAD_TOL = 2e-5
#: bf16: loss and aux, each gradient leaf's max error of its scale and its
#: L2 error of its norm, the grad norm; and the share of a leaf's scale
#: above which a gradient's sign is sure on both sides
BF16_LOSS_TOL, BF16_GRAD_TOL, BF16_NORM_TOL = 2e-3, 1e-1, 6e-2
BF16_GNORM_TOL, BF16_SURE = 1e-2, 0.1
#: every registered arch in fp32 (its name alone, as before) and in bf16
CASES = ([pytest.param(n, "float32", id=n) for n in list_configs()]
         + [pytest.param(n, "bfloat16", id=f"{n}-bf16")
            for n in list_configs()])


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
    fe = (cfg.encoder_seq_len if cfg.n_encoder_layers
          else cfg.frontend_embed_len)
    if fe:
        batch["frontend"] = rng.standard_normal(
            (B, fe, cfg.frontend_embed_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("name,dtype", CASES)
def test_train_step_matches_jax(name, dtype):
    if dtype == "bfloat16":
        return _bf16_step_matches_jax(name)
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads_fn = jax.jit(lambda p, b: jax.value_and_grad(
        jax_loss_fn, has_aux=True)(p, b, jcfg, remat=True))
    (jtotal, jm), jg = grads_fn(jp, jb)

    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    g, m = compute_grads(params, tb, cfg, remat=True)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["aux"]) == pytest.approx(float(jm["aux"]), rel=1e-5,
                                            abs=1e-7)
    jgl = [np.asarray(x) for x in jax.tree.leaves(jg)]
    assert len(jgl) == len(leaves(g))
    for want, got in zip(jgl, leaves(g)):
        scale = float(np.abs(want).max())
        assert np.isfinite(got.numpy()).all()
        assert np.abs(got.numpy() - want).max() <= GRAD_TOL * scale + 1e-30

    # one step: the port's step_fn against the JAX optimizer's update of
    # the JAX gradients, clipped as the JAX step clips them
    init_fn, step_fn = make_train_step(cfg, optimizer="adamw", remat=True,
                                       lr=LR, warmup=WARMUP)
    state, metrics = step_fn(init_fn(params), tb)
    jgnorm = jnp.sqrt(sum(jnp.sum(jnp.square(x))
                          for x in jax.tree.leaves(jg)))
    assert float(metrics["grad_norm"]) == pytest.approx(float(jgnorm),
                                                        rel=1e-5)
    scale = jnp.minimum(1.0, 1.0 / jnp.maximum(jgnorm, 1e-6))
    j_init, j_update = JO.make_adamw(lr=LR, warmup=WARMUP)
    jnew, _ = jax.jit(j_update)(jax.tree.map(lambda x: x * scale, jg),
                                j_init(jp), jp)
    lr_t = LR * 0.5                         # the schedule at step 1
    for want, got, gj in zip(jax.tree.leaves(jnew), leaves(state.params),
                             jgl):
        want, got = np.asarray(want), got.numpy()
        assert np.isfinite(got).all()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * lr_t + 1e-6
        sure = np.abs(gj) > 1e-3 * float(np.abs(gj).max())
        assert (diff[sure] <= 1e-6).all()


def _f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def _bf16_step_matches_jax(name):
    """The bf16 case (the module docstring): the JAX bf16 init, the batch's
    frontend rounded to bf16 on both sides."""
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "frontend" in batch:
        jb["frontend"] = jb["frontend"].astype(jnp.bfloat16)
        tb["frontend"] = tb["frontend"].to(torch.bfloat16)
    grads_fn = jax.jit(lambda p, b: jax.value_and_grad(
        jax_loss_fn, has_aux=True)(p, b, jcfg, remat=True))
    (_, jm), jg = grads_fn(jp, jb)

    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=torch.bfloat16)
    g, m = compute_grads(params, tb, cfg, remat=True)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=BF16_LOSS_TOL)
    assert float(m["aux"]) == pytest.approx(float(jm["aux"]),
                                            rel=BF16_LOSS_TOL, abs=1e-7)
    jgl = [_f32(x) for x in jax.tree.leaves(jg)]
    assert len(jgl) == len(leaves(g))
    for want, got, p in zip(jgl, leaves(g), leaves(params)):
        assert got.dtype == p.dtype          # each leaf's own dtype
        got = got.float().numpy()
        assert np.isfinite(got).all()
        assert (np.abs(got - want).max()
                <= BF16_GRAD_TOL * float(np.abs(want).max()) + 1e-30)
        assert (np.linalg.norm(got - want)
                <= BF16_NORM_TOL * np.linalg.norm(want) + 1e-30)

    init_fn, step_fn = make_train_step(cfg, optimizer="adamw", remat=True,
                                       lr=LR, warmup=WARMUP)
    state, metrics = step_fn(init_fn(params), tb)
    jgnorm = jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                          for x in jax.tree.leaves(jg)))
    assert float(metrics["grad_norm"]) == pytest.approx(float(jgnorm),
                                                        rel=BF16_GNORM_TOL)
    scale = jnp.minimum(1.0, 1.0 / jnp.maximum(jgnorm, 1e-6))
    j_init, j_update = JO.make_adamw(lr=LR, warmup=WARMUP)
    jnew, _ = jax.jit(j_update)(
        jax.tree.map(lambda x: x.astype(jnp.float32) * scale, jg),
        j_init(jp), jp)
    lr_t = LR * 0.5                         # the schedule at step 1
    for want, got, gj, p0 in zip(jax.tree.leaves(jnew),
                                 leaves(state.params), jgl, leaves(params)):
        want, got = _f32(want), got.float().numpy()
        assert np.isfinite(got).all()
        diff = np.abs(got - want)
        # one bf16 ulp of the param, before or after the step, at most
        ulp = np.maximum(np.abs(want), np.abs(p0.float().numpy())) \
            * 2.0 ** -7 + 1e-30
        assert (diff <= 2 * lr_t + ulp).all()
        sure = np.abs(gj) > BF16_SURE * float(np.abs(gj).max())
        assert (diff[sure] <= ulp[sure]).all()
