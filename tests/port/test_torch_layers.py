"""Port layers vs the JAX package's ``models/layers.py``: the same numpy
inputs through both, fp32, allclose at atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(2, 7, 64), (3, 5, 4, 32)])
def test_rms_norm_matches_jax(shape):
    rng = _rng()
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    scale = rng.normal(size=shape[-1:]).astype(np.float32) * 0.1
    want = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = _rng(1)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    # prefill positions (1, S) and per-slot decode positions (B, 1)
    for pos in (np.arange(9)[None, :], np.array([[5], [200]])):
        want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        theta))
        got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_apply_rope_rotates_split_halves():
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0                       # first half, pair partner is dim 4
    out = TL.apply_rope(x, torch.tensor([[1]]), 10_000.0)
    assert out[..., 4].abs().item() > 0.5     # rotated into the other half
    assert out[..., 1].abs().item() == 0.0


def test_gated_mlp_matches_jax():
    rng = _rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    wi = rng.normal(size=(32, 2 * 48)).astype(np.float32) * 0.2
    wo = rng.normal(size=(48, 32)).astype(np.float32) * 0.2
    want = np.asarray(JL.gated_mlp(jnp.asarray(x), jnp.asarray(wi),
                                   jnp.asarray(wo)))
    got = TL.gated_mlp(torch.from_numpy(x), torch.from_numpy(wi),
                       torch.from_numpy(wo))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_init_distributions_match_jax_scale():
    """dense_init/embed_init draw the JAX package's distributions (no bit
    parity): std 1/sqrt(fan_in) and 0.02."""
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, (256, 512), torch.float32)
    e = TL.embed_init(gen, (512, 256), torch.float32)
    assert abs(w.std().item() - 256 ** -0.5) < 3e-3
    assert abs(e.std().item() - 0.02) < 1e-3
    assert abs(w.mean().item()) < 3e-3
