"""The port's dry-run tools (``repro_torch.launch.{mesh,specs,dryrun,perf}``,
``models/sharding.py``, the spec halves of ``models/transformer.py`` and
``training/trainer.py``) on the CPU, against the JAX package's
``launch/specs.build_dryrun`` run in-process on a
``jax.sharding.AbstractMesh`` (nothing compiled):

- for every registered config (11) × input shape (4) × production mesh
  (16×16 and 2×16×16): the policy's fields, the inputs' keys, shapes and
  dtypes, and every leaf's partition spec in and out (params, cache, the
  train state, the batch) equal the JAX ones, leaf for leaf; every arg's
  shape equals the JAX arg's;
- ``resident_gb`` equals the JAX ``sharded_resident_gb`` plus the bytes of
  the two param leaves the port keeps in fp32 whatever the dtype (Mamba-2's
  ``A_log``, RG-LRU's ``lambda``), at every shape: the serving steps' bf16
  params, and ``train_4k``'s bf16 train state (both trees' optimizer
  moments fp32); Granite-3.0-2B's ``decode_32k`` reads under 16 GB a
  device on 16×16, as tests/test_system.py holds the JAX dry-run;
- every config traces at full width on the meta device at ``decode_32k``
  (and Qwen3-1.7B, RecurrentGemma-2B and SeamlessM4T at ``train_4k``; the
  full 44-combination matrix at full depth runs in chip_smoke.py's dryrun
  phase, where it fits the time);
- both launchers' ``--mode dryrun``, the results file, a failure's exit
  code, and ``perf.run``.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

import repro.launch.specs as JS
from repro.configs import INPUT_SHAPES
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import dryrun, perf
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import specs as TS
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import (MeshShape, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer as T
from repro_torch.models.sharding import spec_leaves
from repro_torch.training.tree import leaves

ARCHS = list_configs()
MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
POLICY_FIELDS = ("data_axes", "model_axis", "shard_heads", "shard_kv_heads",
                 "shard_experts", "shard_vocab", "seq_parallel_decode",
                 "shard_batch", "fsdp", "moe_token_shard_map",
                 "moe_2d_weights")


@pytest.fixture(scope="module")
def jax_build(request):
    """The JAX ``build_dryrun`` with each config's abstract params made
    once (its own ``abstract_params`` per call, cached here)."""
    made = {}
    orig = JS.abstract_params

    def cached(cfg):
        if cfg.name not in made:
            made[cfg.name] = orig(cfg)
        return made[cfg.name]
    mp = pytest.MonkeyPatch()
    mp.setattr(JS, "abstract_params", cached)
    request.addfinalizer(mp.undo)
    return JS.build_dryrun


def _norm(spec, ndim):
    """A JAX or port spec as a plain tuple of ``ndim`` entries."""
    parts = tuple(spec)
    return parts + (None,) * (ndim - len(parts))


def _jax_specs(tree):
    return [s.spec for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_residency_equal_jax(arch, jax_build):
    cfg = get_config(arch)
    for multi_pod, jmesh in MESHES.items():
        tmesh = make_production_mesh(multi_pod=multi_pod)
        assert tmesh.shape == dict(jmesh.shape)
        for shape in INPUT_SHAPES:
            what = (arch, shape, tmesh.name)
            _, j_args, j_in, j_out, j_pol = jax_build(arch, shape, jmesh)
            _, t_args, t_in, t_out, t_pol = TS.build_dryrun(arch, shape,
                                                            tmesh)
            for f in POLICY_FIELDS:
                assert getattr(t_pol, f) == getattr(j_pol, f), (what, f)
            j_leaves = jax.tree.leaves(j_args)
            t_leaves = leaves(t_args)
            assert [tuple(a.shape) for a in j_leaves] == \
                [tuple(t.shape) for t in t_leaves], what
            assert all(t.is_meta for t in t_leaves), what
            for j_tree, t_tree in ((j_in, t_in), (j_out, t_out)):
                js, ts = _jax_specs(j_tree), spec_leaves(t_tree)
                assert len(js) == len(ts), what
                for a, b in zip(js, ts):
                    n = max(len(tuple(a)), len(b))
                    assert _norm(a, n) == _norm(b, n), (what, a, b)
            # inputs: the JAX keys, shapes and dtypes
            j_ins = JS.input_specs(arch, shape)
            t_ins = TS.input_specs(arch, shape)
            assert list(j_ins) == list(t_ins), what
            for k in j_ins:
                assert tuple(j_ins[k].shape) == tuple(t_ins[k].shape)
                assert str(j_ins[k].dtype) == \
                    str(t_ins[k].dtype).split(".")[1], (what, k)
            got = TS.sharded_resident_gb(t_args, t_in, tmesh)
            want = JS.sharded_resident_gb(j_args, j_in, jmesh)
            # the param leaves the port keeps in fp32 where the JAX params
            # are bf16: 2 more bytes an element over their shards (the
            # train state's moments are fp32 in both)
            train = INPUT_SHAPES[shape].kind == "train"
            params, pspecs = ((t_args[0].params, t_in[0].params) if train
                              else (t_args[0], t_in[0]))
            extra = 0.0
            for t, spec in zip(leaves(params), spec_leaves(pspecs)):
                if t.dtype == torch.float32:
                    shards = np.prod([tmesh.shape[ax] for part in spec
                                      if part is not None for ax in
                                      (part if isinstance(part, tuple)
                                       else (part,))])
                    extra += 2 * t.numel() / shards
            assert got == pytest.approx(want + extra / 2**30, rel=1e-12), \
                what
            recurrent = {"ssd", "rglru"} & {
                blk.mixer for blk in cfg.pattern + cfg.pattern_tail}
            assert (extra > 0) == bool(recurrent), what


def test_granite_decode_resident_under_16gb():
    r = dryrun.run_one("granite-3-2b", "decode_32k", multi_pod=False,
                       verbose=False)
    assert r["memory"]["resident_gb"] < 16.0
    assert r["mesh"] == "16x16"


def test_meshes():
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    m = make_production_mesh(multi_pod=True)
    assert (m.size, m.name) == (512, "2x16x16")
    h = make_host_mesh(4, 4)
    n = max(torch.cuda.device_count(), 1)
    assert h.size <= n and h.axis_names == ("data", "model")


def test_meta_init_matches_the_seeded_tree():
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        real = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
        fake = T.init_params(cfg, dtype=torch.bfloat16, device="meta")
        assert [(t.shape, t.dtype) for t in leaves(real)] == \
            [(t.shape, t.dtype) for t in leaves(fake)], arch
        assert all(t.is_meta for t in leaves(fake))


def _check_row(r, arch, shape):
    assert (r["arch"], r["shape"], r["mesh"]) == (arch, shape, "16x16")
    m = r["memory"]
    for k in ("argument_gb", "output_gb", "temp_gb", "alias_gb",
              "one_card_gb", "resident_gb"):
        assert np.isfinite(m[k]) and m[k] >= 0, (arch, shape, k)
    assert m["one_card_gb"] == pytest.approx(
        m["argument_gb"] + m["temp_gb"] + m["output_gb"] - m["alias_gb"])
    roof = r["roofline"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert roof["terms"]["collective_s"] == 0.0
    # rank 0's local step on the 256 devices: the policy shards, so it
    # runs collectives, and the devices do at least the whole step's work
    dev = r["roofline_per_device"]
    assert dev["devices"] == 256
    assert dev["terms"]["collective_s"] > 0
    assert sum(dev["collective_bytes"].values()) > 0
    assert dev["flops"] * dev["devices"] >= roof["flops"]
    return roof["kernels"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_traces_at_full_width(arch):
    r = dryrun.run_one(arch, "decode_32k", multi_pod=False, verbose=False)
    kernels = _check_row(r, arch, "decode_32k")
    cfg = get_config(arch)
    attn = sum(blk.mixer in ("attn", "swa") for blk in cfg.pattern) \
        * cfg.n_pattern_repeats \
        + sum(blk.mixer in ("attn", "swa") for blk in cfg.pattern_tail)
    assert kernels.get("decode_attention", {}).get("launches", 0) == \
        attn * (2 if cfg.cross_attention else 1)
    # the cache is updated in place: its bytes alias the arguments
    assert r["memory"]["alias_gb"] > 0 or attn == 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_train_traces_at_full_width(arch):
    r = dryrun.run_one(arch, "train_4k", multi_pod=False, verbose=False)
    kernels = _check_row(r, arch, "train_4k")
    assert kernels["flash_attention_bwd"]["launches"] > 0
    if not get_config(arch).n_encoder_layers:
        # every attention block is checkpointed: its forward runs twice
        assert kernels["flash_attention"]["launches"] == \
            2 * kernels["flash_attention_bwd"]["launches"]
    if arch == "recurrentgemma-2b":
        assert kernels["rglru_scan_bwd"]["launches"] > 0
    # the bf16 step's products run in bf16; RecurrentGemma's RG-LRU gates
    # multiply in fp32, as the JAX package's _gates do
    assert r["roofline"]["flops_by_dtype"].keys() == (
        {"bfloat16", "float32"} if arch == "recurrentgemma-2b"
        else {"bfloat16"})


def _rows(path):
    return {(r["arch"], r["shape"]) for r in json.loads(path.read_text())}


def test_launchers_dryrun(tmp_path, monkeypatch, capsys):
    results = tmp_path / "dryrun.json"
    monkeypatch.setattr(dryrun, "RESULTS", results)
    assert serve_launcher.main(["--mode", "dryrun",
                                "--arch", "granite-3-2b"]) == 0
    train_launcher.main(["--mode", "dryrun", "--arch", "seamless-m4t-large-v2"])
    out = capsys.readouterr().out
    assert out.count("[OK] ") == 3
    assert _rows(results) == {("granite-3-2b", "prefill_32k"),
                              ("granite-3-2b", "decode_32k"),
                              ("seamless-m4t-large-v2", "train_4k")}
    # idempotent: a cached combination is skipped
    train_launcher.main(["--mode", "dryrun", "--arch", "seamless-m4t-large-v2"])
    assert "[skip]" in capsys.readouterr().out


def test_dryrun_failure_exits_1(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                     "--results", str(tmp_path / "r.json")])
    assert e.value.code == 1
    assert "[FAIL]" in capsys.readouterr().out


def test_perf_run_top_traffic(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(perf, "OUT", tmp_path / "perf.json")
    r = perf.run("mixtral-8x22b", "decode_32k", "baseline")
    off = perf.run("mixtral-8x22b", "decode_32k", "no-2d-no-fsdp",
                   moe_2d=False, fsdp=False)
    assert r["policy"] == {"moe_2d_weights": True, "fsdp": True}
    assert off["policy"] == {"moe_2d_weights": False, "fsdp": False}
    assert r["resident_gb"] < off["resident_gb"]
    assert r["terms_ms"] == off["terms_ms"]        # the same one-card step
    assert len(json.loads((tmp_path / "perf.json").read_text())) == 2
    out = capsys.readouterr().out
    assert "[baseline] mixtral-8x22b decode_32k" in out
    assert "GB" in out.splitlines()[1]
