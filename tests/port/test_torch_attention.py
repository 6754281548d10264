"""Port attention (plain versions, reached through the kernel wrappers on
CPU tensors) vs the JAX package: each case against the Pallas op in
interpret mode and against the XLA reference, fp32, atol 2e-5.

Inactive decode slots (pos < 0) split the two JAX implementations: the
Pallas kernel returns zeros, the XLA reference the mean of V. The port's
plain versions follow the XLA reference (its CUDA kernels follow the
Pallas contract), so kernel comparisons use active slots only and a
separate test pins the split."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import (bullet_attention_paged_op, flash_attention_op,
                           paged_decode_attention_op)
from repro.kernels import ref as JR
from repro.models import attention as JA
from repro_torch.kernels import bullet_attention as TB
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.models import attention as TA

ATOL = 2e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _qkv(rng, b, s, h, kh, d):
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kh, d)).astype(np.float32),
            rng.normal(size=(b, s, kh, d)).astype(np.float32))


@pytest.mark.parametrize("s", [128, 200])
@pytest.mark.parametrize("window", [0, 17])
def test_flash_matches_pallas_and_xla(s, window):
    rng = np.random.default_rng(s + window)
    q, k, v = _qkv(rng, 2, s, 4, 2, 32)
    got = ops.flash_attention_op(_t(q), _t(k), _t(v), causal=True,
                                 window=window).numpy()
    pallas = flash_attention_op(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                interpret=True)
    xla = JA.flash_ref_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=window)
    np.testing.assert_allclose(got, _np(pallas), atol=ATOL)
    np.testing.assert_allclose(got, _np(xla), atol=ATOL)
    ref = TA.flash_ref_attention(_t(q), _t(k), _t(v), causal=True,
                                 window=window, block_size=64)
    np.testing.assert_allclose(ref.numpy(), _np(xla), atol=ATOL)


def test_oracles_match_jax_oracles():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(4, 40, 32)).astype(np.float32)
    k = rng.normal(size=(4, 40, 32)).astype(np.float32)
    v = rng.normal(size=(4, 40, 32)).astype(np.float32)
    np.testing.assert_allclose(
        TR.flash_attention_ref(_t(q), _t(k), _t(v), window=9).numpy(),
        _np(JR.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=9)), atol=ATOL)
    qd, kp, vp, bt, pos = _paged_case(rng)
    b, h, d = qd.shape[0], qd.shape[2], qd.shape[3]
    qk = qd[:, 0].reshape(b, 2, h // 2, d)
    np.testing.assert_allclose(
        TR.paged_decode_attention_ref(_t(qk), _t(kp), _t(vp), _t(bt),
                                      _t(pos)).numpy(),
        _np(JR.paged_decode_attention_ref(
            jnp.asarray(qk), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(pos))), atol=ATOL)


def _paged_case(rng, ps=8, kh=2, h=4, d=32):
    """4 slots over a shared pool: contexts 1, 8 (page edge), 19, and an
    inactive slot; the table is bucketed to 4 columns with the trash page
    (garbage-filled) past each slot's live pages."""
    contexts = [1, 8, 19, 0]
    n_b = 4
    n_pages = 9
    trash = n_pages
    kp = rng.normal(size=(n_pages + 1, ps, kh, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages + 1, ps, kh, d)).astype(np.float32)
    kp[trash] = 50.0
    vp[trash] = -50.0
    perm = rng.permutation(n_pages)
    bt = np.full((len(contexts), n_b), trash, np.int32)
    used = 0
    for i, c in enumerate(contexts):
        need = -(-c // ps)
        bt[i, :need] = perm[used:used + need]
        used += need
    pos = np.array([c - 1 for c in contexts], np.int32)
    q = rng.normal(size=(len(contexts), 1, h, d)).astype(np.float32)
    return q, kp, vp, bt, pos


def test_paged_decode_matches_pallas_and_xla():
    rng = np.random.default_rng(4)
    q, kp, vp, bt, pos = _paged_case(rng)
    got = ops.paged_decode_attention_op(_t(q), _t(kp), _t(vp), _t(bt),
                                        _t(pos)).numpy()
    pallas = _np(paged_decode_attention_op(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), interpret=True))
    xla = _np(JA.paged_decode_ref(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(bt),
                                  jnp.asarray(pos)))
    act = pos >= 0
    np.testing.assert_allclose(got[act], pallas[act], atol=ATOL)
    np.testing.assert_allclose(got, xla, atol=ATOL)      # incl. inactive


def test_inactive_slot_reference_split_is_pinned():
    """The reference-side inconsistency the port records: for pos < 0 the
    Pallas kernel returns zeros, the XLA path (and the port's plain
    version) the mean of V over the slot's table."""
    rng = np.random.default_rng(5)
    q, kp, vp, bt, pos = _paged_case(rng)
    pallas = _np(paged_decode_attention_op(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), interpret=True))
    got = ops.paged_decode_attention_op(_t(q), _t(kp), _t(vp), _t(bt),
                                        _t(pos)).numpy()
    idle = int(np.flatnonzero(pos < 0)[0])
    assert np.all(pallas[idle] == 0.0)
    gathered = vp[bt[idle]].reshape(-1, vp.shape[2], vp.shape[3])
    mean_v = gathered.mean(axis=0)                         # (K, D)
    want = np.repeat(mean_v, q.shape[2] // vp.shape[2], axis=0)
    np.testing.assert_allclose(got[idle, 0], want, atol=1e-4)


def test_write_paged_kv_matches_jax():
    rng = np.random.default_rng(6)
    _, kp, vp, bt, pos = _paged_case(rng)
    kn = rng.normal(size=(4, 1, 2, 32)).astype(np.float32)
    vn = rng.normal(size=(4, 1, 2, 32)).astype(np.float32)
    jk, jv = JA.write_paged_kv(jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(bt), jnp.asarray(pos))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    TA.write_paged_kv(tk, tv, _t(kn), _t(vn), _t(bt), _t(pos))
    live = np.arange(kp.shape[0]) != kp.shape[0] - 1        # not the trash
    np.testing.assert_array_equal(tk.numpy()[live], _np(jk)[live])
    np.testing.assert_array_equal(tv.numpy()[live], _np(jv)[live])


@pytest.mark.parametrize("share", [0.1, 0.5, 0.9])
def test_bullet_paged_matches_pallas_and_xla(share):
    rng = np.random.default_rng(7)
    qp, kpp, vpp = _qkv(rng, 2, 128, 4, 2, 32)
    qd, kp, vp, bt, pos = _paged_case(rng)
    op, od = ops.bullet_attention_paged_op(
        _t(qp), _t(kpp), _t(vpp), _t(qd), _t(kp), _t(vp), _t(bt), _t(pos),
        decode_share=share)
    pp, pd = bullet_attention_paged_op(
        *(jnp.asarray(a) for a in (qp, kpp, vpp, qd, kp, vp, bt, pos)),
        decode_share=share, interpret=True)
    xp = JA.flash_ref_attention(jnp.asarray(qp), jnp.asarray(kpp),
                                jnp.asarray(vpp))
    xd = JA.paged_decode_ref(jnp.asarray(qd), jnp.asarray(kp),
                             jnp.asarray(vp), jnp.asarray(bt),
                             jnp.asarray(pos))
    act = pos >= 0
    np.testing.assert_allclose(op.numpy(), _np(pp), atol=ATOL)
    np.testing.assert_allclose(od.numpy()[act], _np(pd)[act], atol=ATOL)
    np.testing.assert_allclose(op.numpy(), _np(xp), atol=ATOL)
    np.testing.assert_allclose(od.numpy(), _np(xd), atol=ATOL)


def test_decode_ctas_split_the_sms():
    """The fused kernel's CTA split: round(share·n_ctas), each phase with
    work keeping at least one CTA, a phase without work none; at two CTAs
    per SM a tile-table share of m SMs gets 2·m CTAs."""
    assert TB.decode_ctas(0.5, 132, True, True) == 66
    assert TB.decode_ctas(20 / 132, 264, True, True) == 40
    assert TB.decode_ctas(0.0, 132, True, True) == 1
    assert TB.decode_ctas(1.0, 132, True, True) == 131
    assert TB.decode_ctas(0.3, 132, False, True) == 132
    assert TB.decode_ctas(0.3, 132, True, False) == 0


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    """A wrapper takes the plain version only for CPU tensors; a tensor on
    any other device goes to the kernel path, which refuses it."""
    q = torch.zeros(2, 8, 32, device="meta")
    from repro_torch.kernels import flash_attention as TF
    with pytest.raises(ValueError, match="CUDA"):
        TF.flash_attention(q, q[:1], q[:1], group=2)
