"""The bf16 SSD chunk scan's numerics on the CPU: ``ssd_scan_tc_ref``
(``repro_torch/kernels/ref.py``), the plain mirror of the bf16 CUDA body
(C Bᵀ once per row and chunk in fp32, (C Bᵀ ⊙ L) rounded to bf16, the
state rounded to bf16 for the inter term, the state update through a
hi + lo bf16 split of xw ⊙ e^{total − cum}), held against the Pallas
``ssd_scan`` (interpret mode, as ``test_torch_ssm.py`` runs it) and the
port's ``ssd_scan_plain``, on bf16 inputs made with numpy from a seed.

Tolerances, over the reference's scale max(1, max|ref|): y 1e-2 (y is
rounded to bf16, one ulp is up to 2^-7 of the scale, and the mirror rounds
(C Bᵀ ⊙ L) too), the fp32 final state 1e-4: the gates ``chip_smoke.py`` and
``test_torch_kernels_cuda.py`` hold the kernel to against the plain
version. The bf16 SSD geometry (``kernels/geometry.py``) is stated once
and reaches nvcc as defines."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import build, geometry
from repro_torch.kernels import ref as TR
from repro_torch.kernels import ssd_scan as TK

Y_TOL = 1e-2
STATE_TOL = 1e-4

#: (b, s, h, p, n, chunk, decay): decay scales A, so "strong" takes the
#: within-chunk cumulative log decay below -200
CASES = {
    "one_chunk": (2, 40, 3, 16, 32, 64, 1.0),            # Q = S = 40
    "padded_tail": (2, 45, 3, 16, 16, 16, 1.0),          # 3 dt = 0 steps
    "strong_decay": (1, 64, 2, 16, 16, 32, 40.0),
    "small_state": (1, 128, 2, 32, 8, 64, 1.0),          # N = 8 < 128
    "p_off_slice": (2, 96, 2, 40, 16, 32, 1.0),          # P = 40
    "tiny_p_and_n": (1, 48, 2, 4, 4, 16, 1.0),           # P = 4, N = 4
    "mamba2_widths": (1, 300, 2, 64, 128, 256, 1.0),     # P, N, Q of 2.7B
}


def _inputs(b, s, h, p, n, chunk, decay, seed=0):
    """The kernel layout from the model layout, as ``ops.ssd_chunk_inputs``
    makes it, in numpy: S padded to the chunk with dt = 0 steps, xw = x·dt
    rounded to bf16, cum the within-chunk cumulative log decay (fp32), B
    and C rounded to bf16. Returns numpy fp32 arrays (bf16 values where
    the kernel reads bf16) and the unpadded model-layout inputs of the
    sequential oracle."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    u = rng.uniform(0.1, 0.9, h)
    A = (-decay * u / (1 - u)).astype(np.float32)
    B_ = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    q = min(chunk, s)
    pad = (q - s % q) % q
    nc = (s + pad) // q

    def padded(a):
        return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))

    def bf16(a):
        return torch.from_numpy(a).bfloat16().float().numpy()
    dtp = padded(dt)
    cum = np.cumsum((dtp * A).reshape(b, nc, q, h), axis=2,
                    dtype=np.float32)
    xw = bf16(padded(x) * dtp[..., None]).reshape(b, nc, q, h, p)
    Bc = bf16(padded(B_)).reshape(b, nc, q, n)
    Cc = bf16(padded(C)).reshape(b, nc, q, n)
    # the sequential oracle's unpadded model layout
    seq = (xw.reshape(b, -1, h, p)[:, :s],
           np.cumsum(dt * A, axis=1, dtype=np.float32),
           Bc.reshape(b, -1, n)[:, :s], Cc.reshape(b, -1, n)[:, :s])
    return (xw, cum, Bc, Cc), seq


def _torch(arrs):
    xw, cum, Bc, Cc = arrs
    return (torch.from_numpy(xw).bfloat16(), torch.from_numpy(cum),
            torch.from_numpy(Bc).bfloat16(), torch.from_numpy(Cc).bfloat16())


def _scaled_err(out, ref) -> float:
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / max(1.0, np.abs(ref).max()))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_mirror_matches_pallas_kernel_and_plain(case):
    arrs, _ = _inputs(*CASES[case])
    xw, cum, Bc, Cc = _torch(arrs)
    y, st = TR.ssd_scan_tc_ref(xw, cum, Bc, Cc)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert np.isfinite(_np(y)).all() and np.isfinite(_np(st)).all()
    # the Pallas kernel (interpret mode) on the same bf16 values
    jy = jax_ssd_scan(*(jnp.asarray(a).astype(jnp.bfloat16)
                        if i != 1 else jnp.asarray(a)
                        for i, a in enumerate(arrs)), interpret=True)
    assert _scaled_err(_np(y), np.asarray(jy, np.float32)) <= Y_TOL
    py, pst = TK.ssd_scan_plain(xw, cum, Bc, Cc)
    assert _scaled_err(_np(y), _np(py)) <= Y_TOL
    assert _scaled_err(_np(st), _np(pst)) <= STATE_TOL


@pytest.mark.parametrize("case", ["padded_tail", "strong_decay",
                                  "mamba2_widths"])
def test_mirror_state_matches_the_sequential_oracle(case):
    """The final state against the JAX package's one-step-per-position
    oracle over the real rows only: past them the padded dt = 0 steps pass
    the state through unchanged."""
    arrs, seq = _inputs(*CASES[case])
    _, st = TR.ssd_scan_tc_ref(*_torch(arrs))
    _, js = JR.ssd_scan_ref(*map(jnp.asarray, seq))
    assert _scaled_err(_np(st), np.asarray(js)) <= STATE_TOL


def test_strong_decay_case_reaches_minus_200():
    """The strong-decay case really takes cum below -200 inside a chunk,
    so L's e^{cum_i - cum_j} and e^{cum_i} underflow to 0 there."""
    (_, cum, _, _), _ = _inputs(*CASES["strong_decay"])
    assert cum.min() <= -200.0


def test_one_rounding_of_the_state_input_would_fail_the_gate():
    """Why the state update takes xw ⊙ e^{total − cum} as a hi + lo bf16
    pair: rounded once to bf16, the final state misses the 1e-4 gate at
    Mamba-2's widths; the pair holds it with an order of magnitude to
    spare."""
    arrs, _ = _inputs(*CASES["mamba2_widths"])
    xw, cum, Bc, Cc = _torch(arrs)
    _, pst = TK.ssd_scan_plain(xw, cum, Bc, Cc)
    b, nc, q, h, p = xw.shape
    once = torch.zeros(b, h, p, Bc.shape[-1])
    for ci in range(nc):
        cum_c, b_c = cum[:, ci], Bc[:, ci].float()
        v = TR._bf16(xw[:, ci].float()
                     * torch.exp(cum_c[:, -1:] - cum_c)[..., None])
        once = (once * torch.exp(cum_c[:, -1])[..., None, None]
                + torch.einsum("bjn,bjhp->bhpn", b_c, v))
    _, st = TR.ssd_scan_tc_ref(xw, cum, Bc, Cc)
    assert _scaled_err(_np(once), _np(pst)) > STATE_TOL
    assert _scaled_err(_np(st), _np(pst)) <= STATE_TOL / 10


def test_ssd_geometry_is_stated_once():
    """ssd_scan.cu states no value of SSD_TILE or SSD_P_SLICE (it refuses to
    compile without them), the nvcc command carries them as defines, they
    are part of the library's digest, and the wrapper sizes its C Bᵀ
    workspace and checks the slice with the same module."""
    source = (build.CSRC / "ssd_scan.cu").read_text()
    cmd = build.compile_command("nvcc", "ssd_scan.cu", "ssd_scan.o")
    for name, value in geometry.SSD_DEFINES.items():
        assert not re.search(rf"#\s*define\s+{name}\b", source), name
        assert not re.search(rf"\b{name}\s*=\s*\d", source), name
        assert f"!defined({name})" in source, name
        assert f"-D{name}={value}" in cmd, name
    assert geometry.SSD_P_SLICE in geometry.SSD_P_SLICES
    assert TK.SSD_TILE == geometry.SSD_TILE
    assert TK.SSD_P_SLICES == geometry.SSD_P_SLICES
    for width in geometry.SSD_P_SLICES:
        assert f"case {width}: return launch_out<{width}>" in source


def test_ssd_geometry_is_part_of_the_digest(monkeypatch):
    """Changing the SSD slice names another library, so it rebuilds."""
    before = build.library_path()
    monkeypatch.setitem(geometry.SSD_DEFINES, "SSD_P_SLICE", 32)
    assert build.library_path() != before
