"""Kernel 1's gradient: the plain backward (``ref.flash_attention_bwd_ref``,
what ``FlashAttention`` runs for CPU tensors) against ``jax.vjp`` of the
JAX ``flash_ref_attention`` (the gradient the JAX package trains
through, XLA) and against torch autograd of the plain forward, on seeded
numpy inputs: causal, windowed, non-causal with Sq != Sk, G 1/2/4, D
32/64/128, RecurrentGemma's local attention (D 256, G 10, a window),
ragged lengths. fp32, atol 2e-5 and rtol 1e-4 (both sides sum
fp32 products of the same inputs in other orders; measured under 3e-6).

The same plain backward on bf16 inputs is held against ``jax.vjp`` of the
JAX function run in bf16, each gradient within 2e-2 of its max abs.

The card tests (marked ``cuda``, skip without a device) hold the CUDA
backwards against the plain backward: ``flash_attention_bwd`` (fp32) at
the smoke's TOL, two runs bit-equal, a launch with its dK/dV items forced
over 2 and 3 CTAs within TOL of the unsplit one;
``flash_attention_bwd_tc`` (bf16, on the same inputs rounded to bf16, the
plain in fp32) within 2e-2 of each gradient's max abs, two runs
bit-equal; and, in both dtypes, the training forward that feeds them,
``flash_attention_fwd_lse``: its output bit-equal to the serving
forward's (and in bf16 within 2e-2 of the plain one), its log2-sum-exp2
within 1e-3 of ``ref.flash_lse_ref`` (held against numpy in float64 on
the CPU), the backward given it bit-equal to the one that runs it.
Run them on a GPU host:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/port/test_torch_flash_grad.py

The last test pins the reference-side split (ROADMAP §3): with
``REPRO_FORCE_PALLAS=1`` the JAX ``attention_prefill`` sends S = 128 to
its Pallas kernel, and ``jax.grad`` through it raises; the port's
gradient equals the XLA path's. JAX is imported inside the CPU tests, so
the file loads on a card's host without JAX."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

ATOL, RTOL = 2e-5, 1e-4
#: (causal, window, B, Sq, Sk, H, K, D)
CASES = [
    (True, 0, 2, 37, 37, 4, 4, 32),       # G 1, ragged
    (True, 0, 1, 70, 70, 4, 2, 64),       # G 2
    (True, 9, 2, 41, 41, 8, 2, 32),       # window, G 4
    (True, 16, 1, 64, 64, 2, 1, 128),     # window, G 2, D 128
    (False, 0, 2, 12, 29, 4, 4, 64),      # cross: Sq != Sk, G 1
    (False, 0, 1, 33, 17, 4, 2, 32),      # non-causal, Sq > Sk, G 2
    (False, 0, 1, 24, 24, 8, 2, 128),     # encoder, G 4, D 128
    (True, 24, 1, 50, 50, 10, 1, 256),    # window, G 10, D 256
    (True, 40, 2, 70, 70, 10, 1, 256),    # window, G 10, D 256, B 2
]
IDS = [f"{'c' if c else 'nc'}-w{w}-sq{sq}-sk{sk}-h{h}k{k}-d{d}"
       for c, w, _, sq, sk, h, k, d in CASES]


def _inputs(b, sq, sk, h, k, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kk = rng.standard_normal((b, sk, k, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, k, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, kk, v, do


def _port_grads(q, k, v, do, causal, window):
    """Model layout through ``ops.flash_attention_op`` (the Function and
    its plain backward on the CPU)."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention_op(qt, kt, vt, causal=causal, window=window)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    import jax
    import jax.numpy as jnp
    from repro.models.attention import flash_ref_attention
    causal, window, b, sq, sk, h, k, d = case
    q, kk, v, do = _inputs(b, sq, sk, h, k, d)
    before = TF.bwd_launches
    out, grads = _port_grads(q, kk, v, do, causal, window)
    assert TF.bwd_launches == before          # no kernel on the CPU

    @jax.jit
    def out_and_vjp(a, b_, c, dout):
        o, vjp = jax.vjp(lambda x, y, z: flash_ref_attention(
            x, y, z, causal=causal, window=window), a, b_, c)
        return o, vjp(dout)

    jout, jgrads = out_and_vjp(*(jnp.asarray(x) for x in (q, kk, v, do)))
    np.testing.assert_allclose(out, np.asarray(jout), atol=ATOL, rtol=RTOL)
    for got, want, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


#: bf16: the plain backward (on bf16 inputs, in fp32) against jax.vjp of
#: the JAX flash_ref_attention run in bf16 (its q·scale, probabilities and
#: PV blocks rounded to bf16 as its forward rounds them): each gradient's
#: max error over its max abs (measured up to 8.4e-3; the smoke's bf16
#: attention tolerance)
BF16_TOL = 2e-2
#: the bf16 training forward's log2-sum-exp2 against the plain one on the
#: card, absolute (the smoke's LSE_TOL: the kernel's exp2 is the
#: hardware's approximate one)
LSE_TOL = 1e-3


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_bf16_matches_jax_vjp(case):
    import jax
    import jax.numpy as jnp
    from repro.models.attention import flash_ref_attention
    causal, window, b, sq, sk, h, k, d = case
    q, kk, v, do = (x.astype(jnp.bfloat16) for x in _inputs(b, sq, sk, h,
                                                            k, d, seed=3))

    @jax.jit
    def vjp(a, b_, c, dout):
        _, f = jax.vjp(lambda x, y, z: flash_ref_attention(
            x, y, z, causal=causal, window=window), a, b_, c)
        return f(dout)

    want = [np.asarray(g).astype(np.float32) for g in vjp(
        *(jnp.asarray(x) for x in (q, kk, v, do)))]
    ts = [torch.from_numpy(np.asarray(x).astype(np.float32)).to(
        torch.bfloat16) for x in (q, kk, v, do)]
    leaves = [t.clone().requires_grad_() for t in ts[:3]]
    out = ops.flash_attention_op(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, ts[3])
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16
        err = float(np.abs(g.float().numpy() - w).max() / np.abs(w).max())
        assert err <= BF16_TOL, f"d{name}: {err}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd_of_plain_forward(case):
    causal, window, b, sq, sk, h, k, d = case
    q, kk, v, do = _inputs(b, sq, sk, h, k, d, seed=1)
    g = h // k
    hm = lambda x: torch.from_numpy(x).transpose(1, 2).reshape(  # noqa: E731
        -1, x.shape[1], d).contiguous()
    qt, kt, vt, dot = hm(q), hm(kk), hm(v), hm(do)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out = kref.flash_attention_ref(*leaves, causal=causal, window=window,
                                   group=g)
    want = torch.autograd.grad(out, leaves, dot)
    got = kref.flash_attention_bwd_ref(qt, kt, vt, out.detach(), dot,
                                       causal=causal, window=window,
                                       group=g)
    for a, b_, name in zip(got, want, "qkv"):
        torch.testing.assert_close(a, b_, atol=ATOL, rtol=RTOL,
                                   msg=f"d{name}")


#: the plain log2-sum-exp2 against numpy's in float64, absolute (log2
#: units; fp32 sums of D products)
LSE_ATOL = 1e-5


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_lse_matches_numpy(case):
    """``ref.flash_lse_ref`` (what the bf16 training forward writes for
    the backward) against each row's log2-sum-exp2 of its scaled logits
    over the keys it sees, computed in float64 with numpy."""
    causal, window, b, sq, sk, h, k, d = case
    q, kk, _, _ = _inputs(b, sq, sk, h, k, d, seed=4)
    g = h // k
    hm = lambda x: torch.from_numpy(x).transpose(1, 2).reshape(  # noqa: E731
        -1, x.shape[1], d).contiguous()
    got = kref.flash_lse_ref(hm(q), hm(kk), causal=causal, window=window,
                             group=g).numpy()
    qh = q.astype(np.float64).transpose(0, 2, 1, 3)       # (B, H, Sq, D)
    kh = np.repeat(kk.astype(np.float64).transpose(0, 2, 1, 3), g, axis=1)
    s = qh @ kh.transpose(0, 1, 3, 2) / np.sqrt(d)         # (B, H, Sq, Sk)
    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    seen = np.ones((sq, sk), bool)
    if causal:
        seen &= j <= i
    if window:
        seen &= j > i - window
    s = np.where(seen, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))) / np.log(2.0)
    np.testing.assert_allclose(got, want.reshape(b * h, sq), atol=LSE_ATOL,
                               rtol=0)


def test_offset_and_card_dtype_refusals():
    q = torch.zeros(2, 8, 64, requires_grad=True)
    kv = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="q_offset"):
        TF.flash_attention(q, kv, kv, group=2, q_offset=3)
    # no gradient needed: the offset runs as before
    with torch.no_grad():
        TF.flash_attention(q, kv, kv, group=2, q_offset=3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES[1:], ids=IDS[1:])
def test_cuda_backward_matches_plain(case, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    causal, window, b, sq, sk, h, k, d = case
    if d not in build.BWD_HEAD_DIMS:
        pytest.skip(f"the backward is built for D in {build.BWD_HEAD_DIMS}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b * h, sq, d, device="cuda", generator=gen)
    kk = torch.randn(b * k, sk, d, device="cuda", generator=gen)
    v = torch.randn(b * k, sk, d, device="cuda", generator=gen)
    do = torch.randn(b * h, sq, d, device="cuda", generator=gen)
    kw = dict(causal=causal, window=window, group=h // k)
    o = TF.flash_attention(q, kk, v, **kw)
    # the fp32 training forward: the serving output bit for bit, each
    # row's log2-sum-exp2 within LSE_TOL of the plain one
    o_l, lse = TF._forward_lse(q, kk, v, **kw)
    assert torch.equal(o_l, o)
    assert (lse - TF.flash_lse_plain(q, kk, **kw)).abs().max() <= LSE_TOL
    before = TF.bwd_launches
    got = TF.flash_attention_bwd(q, kk, v, o, do, **kw)
    torch.cuda.synchronize()
    assert TF.bwd_launches == before + 1
    want = TF.flash_attention_bwd_plain(q, kk, v, o, do, **kw)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=0)
    # two runs, and the run given the forward's log-sum-exp, bit-equal
    for again in (TF.flash_attention_bwd(q, kk, v, o, do, **kw),
                  TF.flash_attention_bwd(q, kk, v, o, do, lse=lse, **kw)):
        assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
    # the dK/dV items shared over 2 and 3 CTAs: within the smoke's TOL of
    # the unsplit launch, each output over its scale max(1, max|unsplit|)
    monkeypatch.setattr(TF, "bwd_split", lambda *a, **k_: 1)
    one = TF.flash_attention_bwd(q, kk, v, o, do, lse=lse, **kw)
    for n in (2, 3):
        monkeypatch.setattr(TF, "bwd_split", lambda *a, n=n, **k_: n)
        split = TF.flash_attention_bwd(q, kk, v, o, do, lse=lse, **kw)
        for a, b_ in zip(split, one):
            assert ((a - b_).abs().max() / b_.abs().max().clamp(min=1)
                    <= 1e-4)
    monkeypatch.undo()
    # bf16 (the tensor-core body) against the plain backward on the same
    # bf16 inputs in fp32; two runs give the same bits
    q16, k16, v16, do16 = (t.bfloat16() for t in (q, kk, v, do))
    o16 = TF.flash_attention(q16, k16, v16, **kw)
    # the training forward: the serving output bit for bit, within the
    # smoke's bf16 attention tolerance of the plain forward, and each
    # row's log2-sum-exp2 within LSE_TOL of the plain one
    o_l, lse = TF._forward_lse(q16, k16, v16, **kw)
    assert torch.equal(o_l, o16)
    plain = TF.flash_attention_plain(q16, k16, v16, **kw)
    assert (o_l.float() - plain.float()).abs().max() <= BF16_TOL
    assert (lse - TF.flash_lse_plain(q16, k16, **kw)).abs().max() <= LSE_TOL
    assert torch.equal(TF.flash_attention_bwd(q16, k16, v16, o16, do16,
                                              lse=lse, **kw)[0],
                       TF.flash_attention_bwd(q16, k16, v16, o16, do16,
                                              **kw)[0])
    got = TF.flash_attention_bwd(q16, k16, v16, o16, do16, **kw)
    again = TF.flash_attention_bwd(q16, k16, v16, o16, do16, **kw)
    want = TF.flash_attention_bwd_plain(
        *(t.float() for t in (q16, k16, v16, o16, do16)), **kw)
    for a, a2, b_ in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, a2)
        assert ((a.float() - b_).abs().max() / b_.abs().max()
                <= BF16_TOL)


#: chip_smoke.py's BWD_SHAPES, the kernel table's backward rows: (B, Sq,
#: Sk, H, K, D, causal, window)
BWD_SHAPES = {
    "training": (8, 128, 128, 16, 8, 128, True, 0),
    "s2048": (1, 2048, 2048, 16, 8, 128, True, 0),
    "mixtral": (1, 1024, 1024, 48, 8, 128, True, 256),
    "d64": (1, 1024, 1024, 32, 8, 64, True, 0),
    "cross": (4, 128, 1024, 16, 16, 64, False, 0),
    "d256": (1, 3000, 3000, 10, 1, 256, True, 2048),
}
#: the H100's SMs
SMS = 132


def _hand_split(shape, tile, slots):
    """``bwd_split``'s rule on a count of its own: each key tile's items
    are G x the query tiles holding a seen (query, key) pair, read off the
    element mask itself; split = round(heaviest / mean a slot), at most
    8, 1 where the heaviest holds at most 8."""
    b, sq, sk, h, kh, d, causal, window = shape
    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    seen = np.ones((sq, sk), bool)
    if causal:
        seen &= j <= i
    if window:
        seen &= j > i - window
    n_qt, n_kt = -(-sq // tile), -(-sk // tile)
    pad = np.zeros((n_qt * tile, n_kt * tile), bool)
    pad[:sq, :sk] = seen
    meet = pad.reshape(n_qt, tile, n_kt, tile).any(axis=(1, 3))
    loads = (h // kh) * meet.sum(axis=0)
    if loads.max() <= 8:
        return 1
    mean = b * kh * loads.sum() / slots
    return max(1, min(8, round(loads.max() / mean)))


#: the fp32 body's split at each shape on an H100 (one CTA an SM), and the
#: bf16 body's (two CTAs an SM, one at D = 256)
FP32_SPLITS = {"training": 1, "s2048": 1, "mixtral": 1, "d64": 2,
               "cross": 1, "d256": 2}
BF16_SPLITS = {"training": 1, "s2048": 2, "mixtral": 2, "d64": 4,
               "cross": 1, "d256": 4}


@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_fp32_bwd_split_matches_a_hand_count(name):
    """``bwd_split`` at the fp32 body's tile (``geometry.rt_bwd_tile``: 64
    rows at D <= 128, 32 at D = 256) and one CTA an SM against a count
    from the element mask; unsplit at the training shape (S = 128)."""
    from repro_torch.kernels import geometry
    b, sq, sk, h, kh, d, causal, window = BWD_SHAPES[name]
    tile = geometry.rt_bwd_tile(d)
    assert tile == (32 if d == 256 else 64)
    got = TF.bwd_split(sq, sk, h // kh, b * kh, causal, window, SMS, tile)
    assert got == _hand_split(BWD_SHAPES[name], tile, SMS)
    assert got == FP32_SPLITS[name]


@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_bf16_bwd_split_unchanged_at_its_tile(name):
    """The bf16 body's split at BWD_TILE (its default tile), two CTAs an
    SM below D = 256: the splits its PR measured (PERF.md's kernel table),
    and the same count from the element mask."""
    b, sq, sk, h, kh, d, causal, window = BWD_SHAPES[name]
    slots = SMS * (1 if d == 256 else 2)
    got = TF.bwd_split(sq, sk, h // kh, b * kh, causal, window, slots)
    assert got == TF.bwd_split(sq, sk, h // kh, b * kh, causal, window,
                               slots, TF.BWD_TILE)
    assert got == _hand_split(BWD_SHAPES[name], TF.BWD_TILE, slots)
    assert got == BF16_SPLITS[name]


def test_fp32_bwd_geometry_is_stated_once():
    """flash_attention_bwd.cu states no value of its tile heights (it
    refuses to compile without them), the nvcc command carries them as
    defines, and the wrapper's split count reads the same module."""
    import re
    from repro_torch.kernels import geometry
    source = (build.CSRC / "flash_attention_bwd.cu").read_text()
    cmd = build.compile_command("nvcc", "flash_attention_bwd.cu", "bwd.o")
    for name, value in geometry.BWD_DEFINES.items():
        assert not re.search(rf"#\s*define\s+{name}\b", source), name
        assert not re.search(rf"\b{name}\s*=\s*\d", source), name
        assert f"!defined({name})" in source, name
        assert f"-D{name}={value}" in cmd, name
    assert [geometry.rt_bwd_tile(d) for d in build.BWD_HEAD_DIMS] == [
        geometry.RT_BWD_TILE, geometry.RT_BWD_TILE,
        geometry.RT_BWD_TILE_WIDE]


def test_fp32_bwd_geometry_is_part_of_the_digest(monkeypatch):
    """Changing a tile height names another library, so it rebuilds."""
    from repro_torch.kernels import geometry
    before = build.library_path()
    monkeypatch.setitem(geometry.BWD_DEFINES, "RT_BWD_TILE_WIDE", 16)
    assert build.library_path() != before


def test_pallas_gradient_split_is_pinned(monkeypatch):
    """ROADMAP §3: ``jax.grad`` through the JAX Pallas flash kernel (the
    route ``attention_prefill`` takes at S % 128 == 0 under
    REPRO_FORCE_PALLAS=1, interpret mode here) fails; the port's
    gradient equals the XLA path's (the variable unset)."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as JA
    b, s, h, k, d = 1, 128, 4, 2, 32
    q, kk, v, do = _inputs(b, s, s, h, k, d, seed=2)
    args = (jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v))

    def loss(a, b_, c):
        return jnp.sum(JA.attention_prefill(a, b_, c, causal=True)
                       * jnp.asarray(do))

    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    assert JA.use_pallas_kernels()
    # the Pallas call's JVP rule asserts (jax 0.9.0, interpret mode)
    with pytest.raises(AssertionError):
        jax.grad(loss, argnums=(0, 1, 2))(*args)
    monkeypatch.delenv("REPRO_FORCE_PALLAS")
    assert not JA.use_pallas_kernels()
    want = jax.grad(loss, argnums=(0, 1, 2))(*args)
    _, got = _port_grads(q, kk, v, do, True, 0)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b_), atol=ATOL, rtol=RTOL)


def test_refuse_grad_raises_only_where_a_gradient_is_needed():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match=r"decode_attention.*R19"):
        build.refuse_grad("decode_attention", (None, x), "ROADMAP §2 R19")
    with torch.no_grad():
        build.refuse_grad("decode_attention", (None, x), "ROADMAP §2 R19")
    build.refuse_grad("decode_attention", (None, x.detach()),
                      "ROADMAP §2 R19")


@pytest.mark.cuda
def test_cuda_wrappers_refuse_gradients():
    """On the card kernels 2-5 raise when an input requires grad, so no
    wrapper returns a result cut off from the graph; kernel 1 in bf16
    (D = 256 too) trains through its Function."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import bullet_attention as TB
    from repro_torch.kernels import decode_attention as TD
    from repro_torch.kernels import paged_decode_attention as TP
    dev = "cuda"
    b, kh, g, d, s, ps = 2, 2, 2, 128, 32, 16
    qd = torch.randn(b, kh, g, d, device=dev, requires_grad=True)
    cache = torch.randn(b, s, kh, d, device=dev)
    kvpos = torch.arange(s, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    pages = torch.randn(b * s // ps + 1, ps, kh, d, device=dev)
    tables = torch.arange(b * s // ps, dtype=torch.int32,
                          device=dev).reshape(b, -1)
    qp = torch.randn(kh * g, 16, d, device=dev, requires_grad=True)
    kp = torch.randn(kh, 16, d, device=dev)
    calls = {
        "decode_attention": lambda: TD.decode_attention(
            qd, cache, cache, kvpos, pos),
        "paged_decode_attention": lambda: TP.paged_decode_attention(
            qd, pages, pages, tables, pos),
        "bullet_attention_paged": lambda: TB.bullet_attention_paged(
            qp, kp, kp, qd, pages, pages, tables, pos, group=g),
        "bullet_attention": lambda: TB.bullet_attention(
            qp, kp, kp, qd, cache, cache, kvpos, pos, group=g),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
    # kernel 1 in bf16 under grad (D = 256 too) runs its Function: the
    # gradient comes from the bf16 backward kernel, in bf16
    q256 = torch.randn(2, 8, 256, device=dev).bfloat16().requires_grad_()
    k256 = torch.randn(1, 8, 256, device=dev).bfloat16().requires_grad_()
    before = TF.bwd_launches
    out = TF.flash_attention(q256, k256, k256, group=2)
    grads = torch.autograd.grad(out.float().sum(), (q256, k256))
    assert TF.bwd_launches == before + 1
    assert all(g.dtype == torch.bfloat16 for g in grads)
