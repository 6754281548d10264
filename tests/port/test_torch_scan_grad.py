"""The gradients of kernels 6 and 7 (the SSD chunk scan and the RG-LRU
scan), on seeded numpy inputs, in fp32:

- the plain backwards (``ref.ssd_scan_bwd_ref``, ``ref.rglru_scan_bwd_ref``:
  what ``SsdScan`` and ``RglruScan`` run for CPU tensors) against torch
  autograd of the plain forwards (``ssd_scan_plain``, ``rglru_scan_plain``),
  each gradient within 1e-5 of its scale max(1, max|g|) (measured up to
  2.2e-7: the same fp32 products summed in other orders);
- the model-level functions through the Functions (``models.ssm.ssd_chunked``
  and ``models.rglru.rglru_scan``, params bridged through numpy) against
  ``jax.vjp`` of the JAX package's ``repro.models.ssm.ssd_chunked`` (its
  ``lax.scan``) and ``repro.models.rglru.rglru_scan`` (its associative
  scan), the gradients the JAX package trains through, each within 1e-4 of
  its scale (measured up to 3.3e-6): several chunks with a padded tail, a
  starting state with its gradient, a final state's gradient, h0, and
  ragged lengths (the port's padded batch against JAX runs of each row cut
  to its length, the outputs past a row's length given no gradient).

The last CPU test pins the reference-side split (ROADMAP §3): ``jax.grad``
through the JAX Pallas ``ssd_scan`` and ``rglru_scan`` (interpret mode)
raises, as it does through the Pallas flash kernel.

The card tests (marked ``cuda``, skip without a device) hold the CUDA
backwards ``ssd_scan_bwd`` and ``rglru_scan_bwd`` against the plain
backwards at the smoke's TOL, and check that a gradient through the
wrappers on the card launches them and that bf16 raises. Run them on a
GPU host:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/port/test_torch_scan_grad.py

JAX is imported inside the CPU tests, so the file loads on a card's host
without JAX."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels import rglru_scan as TR
from repro_torch.kernels import ssd_scan as TS
from repro_torch.models import rglru as port_rglru
from repro_torch.models import ssm as port_ssm

PLAIN_TOL = 1e-5
MODEL_TOL = 1e-4
#: the card tests' tolerance of scale (chip_smoke.py's TOL[float32])
CARD_TOL = 1e-4


def _close(got, want, tol, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} at scale {scale}"


# ---------------------------------------------------------------------------
# the plain backwards against autograd of the plain forwards
# ---------------------------------------------------------------------------

#: (B, NC, Q, H, P, N, state0, dstate)
SSD_CASES = [
    (2, 3, 16, 3, 8, 5, True, True),
    (1, 1, 7, 2, 4, 3, False, False),
    (1, 2, 70, 2, 8, 16, False, True),
]


def _ssd_kernel_inputs(b, nc, q, h, p, n, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    cum = np.cumsum(-rng.uniform(0.0, 0.3, (b, nc, q, h)),
                    axis=2).astype(np.float32)
    bm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    cm = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = rng.standard_normal((b, nc, q, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return [torch.from_numpy(x) for x in (xw, cum, bm, cm, s0, dy, ds)]


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=[f"b{c[0]}nc{c[1]}q{c[2]}-s0{c[6]:d}-ds{c[7]:d}"
                              for c in SSD_CASES])
def test_plain_ssd_backward_matches_autograd(case):
    b, nc, q, h, p, n, with_s0, with_ds = case
    xw, cum, bm, cm, s0, dy, ds = _ssd_kernel_inputs(b, nc, q, h, p, n, 0)
    s0 = s0 if with_s0 else None
    ds = ds if with_ds else None
    leaves = [t.clone().requires_grad_() for t in (xw, cum, bm, cm)]
    if s0 is not None:
        leaves.append(s0.clone().requires_grad_())
    y, st = TS.ssd_scan_plain(*leaves[:4], leaves[4] if with_s0 else None)
    want = torch.autograd.grad(
        (y, st), leaves, (dy, torch.zeros_like(st) if ds is None else ds))
    got = kref.ssd_scan_bwd_ref(xw, cum, bm, cm, s0, dy, ds)
    assert (got[4] is None) == (s0 is None)
    for g, w, name in zip(got, want, ("dxw", "dcum", "dB", "dC", "dstate0")):
        _close(g, w, PLAIN_TOL, name)


#: (B, S, W, h0, dh_last)
RG_CASES = [(2, 11, 7, True, True), (1, 1, 5, False, False),
            (3, 40, 16, True, False)]


@pytest.mark.parametrize("case", RG_CASES,
                         ids=[f"b{c[0]}s{c[1]}-h0{c[3]:d}-dh{c[4]:d}"
                              for c in RG_CASES])
def test_plain_rglru_backward_matches_autograd(case):
    b, s, w, with_h0, with_dh = case
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.2, 1.0, (b, s, w)).astype(np.float32))
    bb = torch.from_numpy(rng.standard_normal((b, s, w)).astype(np.float32))
    h0 = (torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32))
          if with_h0 else None)
    dy = torch.from_numpy(rng.standard_normal((b, s, w)).astype(np.float32))
    dh = (torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32))
          if with_dh else None)
    leaves = [t.clone().requires_grad_() for t in (a, bb)]
    if with_h0:
        leaves.append(h0.clone().requires_grad_())
    y, h_t = TR.rglru_scan_plain(*leaves[:2], leaves[2] if with_h0 else None)
    want = torch.autograd.grad(
        (y, h_t), leaves, (dy, torch.zeros_like(h_t) if dh is None else dh))
    got = kref.rglru_scan_bwd_ref(a, y.detach(), h0, dy, dh)
    assert (got[2] is None) == (h0 is None)
    for g, w_, name in zip(got, want, ("da", "db", "dh0")):
        _close(g, w_, PLAIN_TOL, name)


# ---------------------------------------------------------------------------
# the model-level functions against jax.vjp of the JAX package's
# ---------------------------------------------------------------------------

#: (B, S, H, P, N, chunk, state0, dstate)
SSD_MODEL_CASES = [
    (2, 37, 3, 8, 5, 16, False, True),    # 3 chunks, padded tail
    (2, 37, 3, 8, 5, 16, True, True),     # from a state, both gradients
    (1, 10, 2, 4, 6, 16, True, False),    # one chunk of Q = S rows
]


def _ssd_model_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(-1.0, 0.5, (h,))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal((h,)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, A, bm, cm, D), s0, dy, ds


def _port_ssd_grads(args, s0, dy, ds, chunk, valid=None):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    st0 = None if s0 is None else torch.from_numpy(s0).requires_grad_()
    x, dt, A, bm, cm, D = leaves
    if valid is not None:
        # past each row's length dt = 0, as ssd_block masks a padded batch
        dt = torch.where(torch.from_numpy(valid)[..., None], dt, 0.0)
    before = TS.bwd_launches
    y, st = port_ssm.ssd_chunked(x, dt, A, bm, cm, D, chunk=chunk,
                                 state0=st0)
    wrt = leaves + ([] if st0 is None else [st0])
    grads = torch.autograd.grad(
        (y, st), wrt, (torch.from_numpy(dy),
                       torch.zeros_like(st) if ds is None
                       else torch.from_numpy(ds)))
    assert TS.bwd_launches == before          # no kernel on the CPU
    return [g.numpy() for g in grads]


def _jax_ssd_grads(args, s0, dy, ds, chunk):
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked

    def fn(*a):
        st = a[6] if s0 is not None else None
        return ssd_chunked(*a[:6], chunk=chunk, state0=st)

    @jax.jit
    def grads(primals, dy_, ds_):
        (y, st), vjp = jax.vjp(fn, *primals)
        return vjp((dy_, jnp.zeros_like(st) if ds_ is None else ds_))

    primals = [jnp.asarray(a) for a in args]
    if s0 is not None:
        primals.append(jnp.asarray(s0))
    return [np.asarray(g) for g in grads(
        primals, jnp.asarray(dy), None if ds is None else jnp.asarray(ds))]


@pytest.mark.parametrize("case", SSD_MODEL_CASES,
                         ids=["pad-tail", "state0", "one-chunk"])
def test_ssd_chunked_gradients_match_jax_vjp(case):
    b, s, h, p, n, chunk, with_s0, with_ds = case
    args, s0, dy, ds = _ssd_model_inputs(b, s, h, p, n, 2)
    s0 = s0 if with_s0 else None
    ds = ds if with_ds else None
    got = _port_ssd_grads(args, s0, dy, ds, chunk)
    want = _jax_ssd_grads(args, s0, dy, ds, chunk)
    assert len(got) == len(want)
    for g, w, name in zip(got, want, ("x", "dt", "A", "B", "C", "D",
                                      "state0")):
        _close(g, w, MODEL_TOL, f"d{name}")


def test_ssd_chunked_ragged_lengths_match_jax_rows():
    """A padded batch (dt = 0 past each row's length, as ``ssd_block``
    masks it) against JAX runs of each row cut to its length: the
    outputs past a row's length get no gradient, the final state's
    gradient enters at the row's length."""
    b, s, h, p, n, chunk = 3, 37, 2, 4, 5, 16
    lens = np.array([37, 20, 5])
    args, _, dy, ds = _ssd_model_inputs(b, s, h, p, n, 3)
    valid = np.arange(s)[None, :] < lens[:, None]
    dy = dy * valid[..., None, None]
    got = _port_ssd_grads(args, None, dy, ds, chunk, valid=valid)
    x, dt, A, bm, cm, D = args
    want = [np.zeros_like(g) for g in got]
    for r, ln in enumerate(lens):
        row = (x[r:r + 1, :ln], dt[r:r + 1, :ln], A, bm[r:r + 1, :ln],
               cm[r:r + 1, :ln], D)
        g = _jax_ssd_grads(row, None, dy[r:r + 1, :ln], ds[r:r + 1], chunk)
        for i in (0, 1, 3, 4):
            want[i][r:r + 1, :ln] = g[i]
        want[2] += g[2]
        want[5] += g[5]
    for g, w, name in zip(got, want, ("x", "dt", "A", "B", "C", "D")):
        _close(g, w, MODEL_TOL, f"d{name}")


def _rglru_params(w, seed):
    rng = np.random.default_rng(seed)
    return {"w_a": (rng.standard_normal((w, w)) / np.sqrt(w)).astype(
                np.float32),
            "w_x": (rng.standard_normal((w, w)) / np.sqrt(w)).astype(
                np.float32),
            "b_a": rng.standard_normal((w,)).astype(np.float32),
            "b_x": rng.standard_normal((w,)).astype(np.float32),
            "lambda": rng.uniform(0.5, 3.0, (w,)).astype(np.float32)}


PARAM_KEYS = ("w_a", "w_x", "b_a", "b_x", "lambda")


def _port_rglru_grads(x, params, h0, dy, dh, lengths=None):
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    h0t = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    before = TR.bwd_launches
    y, h_t = port_rglru.rglru_scan(
        xt, pt, h0t, None if lengths is None else torch.from_numpy(lengths))
    wrt = [xt] + [pt[k] for k in PARAM_KEYS] + (
        [] if h0t is None else [h0t])
    grads = torch.autograd.grad(
        (y, h_t), wrt, (torch.from_numpy(dy),
                        torch.zeros_like(h_t) if dh is None
                        else torch.from_numpy(dh)))
    assert TR.bwd_launches == before          # no kernel on the CPU
    return [g.numpy() for g in grads]


def _jax_rglru_grads(x, params, h0, dy, dh):
    import jax
    import jax.numpy as jnp
    from repro.models.rglru import rglru_scan

    def fn(x_, p_, *h):
        return rglru_scan(x_, p_, h[0] if h else None)

    @jax.jit
    def grads(primals, dy_, dh_):
        (y, h_t), vjp = jax.vjp(fn, *primals)
        return vjp((dy_, jnp.zeros_like(h_t) if dh_ is None else dh_))

    primals = [jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}]
    if h0 is not None:
        primals.append(jnp.asarray(h0))
    g = grads(primals, jnp.asarray(dy), None if dh is None
              else jnp.asarray(dh))
    out = [np.asarray(g[0])] + [np.asarray(g[1][k]) for k in PARAM_KEYS]
    if h0 is not None:
        out.append(np.asarray(g[2]))
    return out


@pytest.mark.parametrize("with_h0,with_dh", [(False, True), (True, True),
                                             (True, False)],
                         ids=["dh", "h0-dh", "h0"])
def test_rglru_scan_gradients_match_jax_vjp(with_h0, with_dh):
    b, s, w = 2, 29, 16
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    params = _rglru_params(w, 5)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal((b, s, w)).astype(np.float32)
    dh = rng.standard_normal((b, w)).astype(np.float32) if with_dh else None
    got = _port_rglru_grads(x, params, h0, dy, dh)
    want = _jax_rglru_grads(x, params, h0, dy, dh)
    assert len(got) == len(want)
    for g, w_, name in zip(got, want, ("x",) + PARAM_KEYS + ("h0",)):
        _close(g, w_, MODEL_TOL, f"d{name}")


def test_rglru_scan_ragged_lengths_match_jax_rows():
    """The port's padded batch with ``lengths`` (a = 1, b = 0 past each
    row's length) against JAX runs of each row cut to its length, from h0,
    with the final state's gradient; the outputs past a row's length get
    no gradient."""
    b, s, w = 3, 23, 16
    lens = np.array([23, 9, 1], dtype=np.int64)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    params = _rglru_params(w, 7)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    valid = np.arange(s)[None, :] < lens[:, None]
    dy = rng.standard_normal((b, s, w)).astype(np.float32) * valid[..., None]
    dh = rng.standard_normal((b, w)).astype(np.float32)
    got = _port_rglru_grads(x, params, h0, dy, dh, lengths=lens)
    want = [np.zeros_like(g) for g in got]
    for r, ln in enumerate(lens):
        g = _jax_rglru_grads(x[r:r + 1, :ln], params, h0[r:r + 1],
                             dy[r:r + 1, :ln], dh[r:r + 1])
        want[0][r:r + 1, :ln] = g[0]
        for i in range(1, 6):
            want[i] += g[i]
        want[6][r:r + 1] = g[6]
    for g, w_, name in zip(got, want, ("x",) + PARAM_KEYS + ("h0",)):
        _close(g, w_, MODEL_TOL, f"d{name}")


def test_pallas_scan_gradient_split_is_pinned():
    """ROADMAP §3: ``jax.grad`` through the JAX Pallas ``ssd_scan`` and
    ``rglru_scan`` (interpret mode) raises; the JAX models never call them,
    so their XLA scans are the reference the tests above hold the port
    against."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
    from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
    xw, cum, bm, cm, *_ = _ssd_kernel_inputs(1, 2, 8, 2, 4, 3, 8)
    xs = [jnp.asarray(t.numpy()) for t in (xw, cum, bm, cm)]

    def ssd_loss(x, c, b_, cc):
        return jnp.sum(pallas_ssd(x, c, b_, cc, interpret=True))

    # the Pallas call's JVP rule asserts (jax 0.9.0, interpret mode)
    with pytest.raises(AssertionError):
        jax.grad(ssd_loss, argnums=(0, 1, 2, 3))(*xs)
    rng = np.random.default_rng(9)
    a = jnp.asarray(rng.uniform(0.2, 1.0, (1, 8, 128)).astype(np.float32))
    bb = jnp.asarray(rng.standard_normal((1, 8, 128)).astype(np.float32))

    def rg_loss(a_, b_):
        return jnp.sum(pallas_rglru(a_, b_, interpret=True))

    with pytest.raises(AssertionError):
        jax.grad(rg_loss, argnums=(0, 1))(a, bb)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1.0)).item()


#: (B, NC, Q, H, P, N, state0, dstate): Mamba-2-2.7B's widths, a ragged
#: chunk, the reduced config's
SSD_CARD_CASES = [
    (1, 4, 256, 8, 64, 128, True, True),
    (2, 3, 100, 3, 40, 70, False, True),
    (2, 8, 16, 2, 32, 16, True, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CARD_CASES)
def test_cuda_ssd_backward_matches_plain(case):
    gen = _card()
    b, nc, q, h, p, n, with_s0, with_ds = case

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    xw, bm, cm = rn(b, nc, q, h, p), rn(b, nc, q, n), rn(b, nc, q, n)
    cum = torch.cumsum(-0.3 * torch.rand(b, nc, q, h, generator=gen,
                                         device="cuda"), dim=2)
    s0 = rn(b, h, p, n) if with_s0 else None
    dy = rn(b, nc, q, h, p)
    ds = rn(b, h, p, n) if with_ds else None
    before = TS.bwd_launches
    got = TS.ssd_scan_bwd(xw, cum, bm, cm, s0, dy, ds)
    torch.cuda.synchronize()
    assert TS.bwd_launches == before + 1
    want = TS.ssd_scan_bwd_plain(xw, cum, bm, cm, s0, dy, ds)
    again = TS.ssd_scan_bwd(xw, cum, bm, cm, s0, dy, ds)
    for g, w, g2 in zip(got, want, again):
        if w is None:
            assert g is None
            continue
        assert _rel(g, w) <= CARD_TOL
        assert torch.equal(g, g2)            # no atomics: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w,with_h0", [(4, 3000, 2560, True),
                                           (2, 37, 100, False)])
def test_cuda_rglru_backward_matches_plain(b, s, w, with_h0):
    gen = _card()
    a = torch.rand(b, s, w, generator=gen, device="cuda") * 0.8 + 0.2
    bb = torch.randn(b, s, w, generator=gen, device="cuda")
    h0 = (torch.randn(b, w, generator=gen, device="cuda") if with_h0
          else None)
    y, _ = TR.rglru_scan(a, bb, h0)
    dy = torch.randn(b, s, w, generator=gen, device="cuda")
    dh = torch.randn(b, w, generator=gen, device="cuda")
    before = TR.bwd_launches
    got = TR.rglru_scan_bwd(a, y, h0, dy, dh)
    torch.cuda.synchronize()
    assert TR.bwd_launches == before + 1
    want = TR.rglru_scan_bwd_plain(a, y, h0, dy, dh)
    for g, w_ in zip(got, want):
        if w_ is None:
            assert g is None
            continue
        assert torch.equal(g, w_)            # the plain order, bit for bit


@pytest.mark.cuda
def test_cuda_scan_gradients_go_through_the_kernels():
    """A gradient through the wrappers on the card launches each backward
    once and agrees with the plain backward; a bf16 input that needs a
    gradient raises at the forward and names R18."""
    gen = _card()
    xw = torch.randn(1, 2, 32, 2, 8, generator=gen, device="cuda")
    cum = torch.cumsum(-0.3 * torch.rand(1, 2, 32, 2, generator=gen,
                                         device="cuda"), dim=2)
    bm = torch.randn(1, 2, 32, 4, generator=gen, device="cuda")
    cm = torch.randn(1, 2, 32, 4, generator=gen, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (xw, cum, bm, cm)]
    before = TS.bwd_launches
    y, st = TS.ssd_scan(*leaves)
    grads = torch.autograd.grad((y.sum() + st.sum()), leaves)
    assert TS.bwd_launches == before + 1
    want = TS.ssd_scan_bwd_plain(xw, cum, bm, cm, None, torch.ones_like(y),
                                 torch.ones_like(st))
    for g, w in zip(grads, want):
        assert _rel(g, w) <= CARD_TOL
    a = (torch.rand(2, 9, 16, generator=gen, device="cuda") * 0.8
         + 0.2).requires_grad_()
    bb = torch.randn(2, 9, 16, generator=gen, device="cuda",
                     requires_grad=True)
    before = TR.bwd_launches
    y, h_t = TR.rglru_scan(a, bb)
    torch.autograd.grad(y.sum() + h_t.sum(), (a, bb))
    assert TR.bwd_launches == before + 1
    with pytest.raises(ValueError, match="R18"):
        TS.ssd_scan(leaves[0].detach().bfloat16().requires_grad_(), cum,
                    bm.bfloat16(), cm.bfloat16())
    with pytest.raises(ValueError, match="R18"):
        TR.rglru_scan(a.detach().bfloat16().requires_grad_(), bb.bfloat16())
