"""Dry-run of every (architecture × input shape × production mesh): the
port of the JAX package's ``launch/dryrun.py``.

Each step is traced on the meta device at full width under the roofline
counter (``launch/roofline.py``): nothing is allocated on any device. A
row holds the JAX row's fields where they mean the same:

- ``memory``: ``argument_gb``, ``output_gb``, ``temp_gb`` and
  ``alias_gb`` of the whole step on one card (``temp_gb`` the peak of the
  bytes the step allocates, less its own outputs), ``one_card_gb`` =
  argument + temp + output − alias (the JAX per-device formula, here for
  the whole step on one card) and ``resident_gb``, the params and cache
  (or train state) per device on the mesh under the sharding policy (the
  JAX ``tpu_resident_gb``);
- ``cost_analysis`` (the counted FLOPs and bytes), ``roofline`` (the
  whole step's terms at one H100's peaks, with every kernel's launches)
  and ``policy``;
- ``roofline_per_device``: rank 0's local step on the mesh, traced on the
  meta device under the ``fake`` process group (``launch/mesh.fake_mesh``:
  every collective runs, moving nothing) with the sharded runtime
  (ROADMAP §1 item 8d): its FLOPs, HBM bytes and collective bytes by type,
  and its terms, ``collective_s`` at the NVLink rate (``roofline.ICI_BW``,
  450 GB/s each way; a 16-wide model axis spans two 8-card hosts, whose
  link is slower, so that term is a lower bound). The JAX dry-run's
  numbers are per device too (post-SPMD HLO).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # 11 x 4, 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape decode_32k [--multi-pod] [--jobs 8]
Results go to launch_results/torch_dryrun.json (one row per combination,
kept across runs; ``--force`` traces a cached one again).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.launch.roofline import Counter
from repro_torch.launch.specs import build_dryrun, sharded_resident_gb
from repro_torch.training.tree import leaves

RESULTS = (Path(__file__).resolve().parents[3] / "launch_results"
           / "torch_dryrun.json")


def trace(fn, args):
    """Run ``fn(*args)`` under a :class:`Counter` with grad mode off (the
    train step turns it on for its own gradients). Returns (counter,
    out)."""
    with torch.no_grad(), Counter() as counter:
        out = fn(*args)
    return counter, out


def _storages(tree) -> dict:
    """Storage id -> bytes over a tree's tensors (a shared storage once)."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in leaves(tree) if isinstance(t, torch.Tensor)}


def memory_gb(args, out, counter: Counter) -> dict:
    """The step's memory on one card in GiB, the JAX ``memory_analysis``
    fields: ``temp_gb`` is the counter's peak of allocated bytes less the
    step's own (not aliased) outputs, so ``one_card_gb`` = argument +
    temp + output − alias = argument + that peak."""
    arg = _storages(args)
    outs = _storages(out)
    alias = sum(n for k, n in outs.items() if k in arg)
    fresh = sum(outs.values()) - alias
    gb = 2.0 ** 30
    return {"argument_gb": sum(arg.values()) / gb,
            "output_gb": sum(outs.values()) / gb,
            "temp_gb": (counter.peak_bytes - fresh) / gb,
            "alias_gb": alias / gb,
            "one_card_gb": (sum(arg.values()) + counter.peak_bytes) / gb}


def policy_row(policy) -> dict:
    return {k: getattr(policy, k) for k in (
        "shard_heads", "shard_kv_heads", "seq_parallel_decode",
        "shard_experts", "shard_vocab", "shard_batch", "fsdp")}


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            verbose: bool = True, **policy_kw) -> dict:
    """Trace one combination on the meta device; its row (printed with the
    JAX ``[OK]`` line when ``verbose``)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    fn, args, in_specs, _, policy = build_dryrun(arch, shape_name, mesh,
                                                 **policy_kw)
    counter, out = trace(fn, args)
    rep = counter.report
    memory = memory_gb(args, out, counter)
    memory["resident_gb"] = sharded_resident_gb(args, in_specs, mesh)
    del out
    with fake_mesh(mesh) as rank0:
        fn, largs, *_ = build_dryrun(arch, shape_name, rank0, **policy_kw)
        local, _ = trace(fn, largs)
    per_device = local.report
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh.name,
        "trace_s": round(time.time() - t0, 1),
        "memory": memory,
        "cost_analysis": {"flops": rep.flops, "bytes accessed": rep.hbm_bytes},
        "roofline": rep.to_json(),
        "roofline_per_device": dict(per_device.to_json(),
                                    devices=mesh.size),
        "policy": policy_row(policy),
    }
    if verbose:
        t = rep.terms()
        print(f"[OK] {arch:28s} {shape_name:12s} {mesh.name:8s} "
              f"trace={result['trace_s']:6.1f}s "
              f"one_card={memory['one_card_gb']:8.2f}GB "
              f"resident={memory['resident_gb']:5.2f}GB "
              f"compute={t['compute_s']*1e3:10.2f}ms "
              f"memory={t['memory_s']*1e3:9.2f}ms "
              f"coll={t['collective_s']*1e3:5.2f}ms "
              f"dom={rep.dominant()}", flush=True)
        d = per_device.terms()
        print(f"     per device (rank 0 of {mesh.size}): "
              f"compute={d['compute_s']*1e3:.3f}ms "
              f"memory={d['memory_s']*1e3:.3f}ms "
              f"coll={d['collective_s']*1e3:.3f}ms "
              f"dom={per_device.dominant()}; collective bytes "
              f"{ {k: f'{v / 1e9:.3f} GB' for k, v in per_device.collective_bytes.items()} }",
              flush=True)
        kernels = ", ".join(f"{k} x{v['launches']}"
                            for k, v in rep.kernels.items())
        print(f"     memory: argument={memory['argument_gb']:.2f}GB "
              f"output={memory['output_gb']:.2f}GB "
              f"temp={memory['temp_gb']:.2f}GB "
              f"alias={memory['alias_gb']:.2f}GB; kernels: {kernels}",
              flush=True)
    return result


def load_results(path: Path) -> list:
    if path.exists():
        return json.loads(path.read_text())
    return []


def save_results(results: list, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1))


def _run_quiet(arch: str, shape: str, multi_pod: bool):
    """A worker's combination: (row or None, its output lines or the
    failure's traceback)."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            row = run_one(arch, shape, multi_pod=multi_pod)
        return row, buf.getvalue()
    except Exception:                  # noqa: BLE001 - reported by main
        return None, buf.getvalue() + traceback.format_exc()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, one process each")
    ap.add_argument("--results", default=str(RESULTS),
                    help="the results file (JSON rows)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_configs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    path = Path(args.results)
    results = load_results(path)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    todo = []
    for mp in meshes:
        mesh_name = make_production_mesh(multi_pod=mp).name
        for arch in archs:
            for shape in shapes:
                if (arch, shape, mesh_name) in done and not args.force:
                    print(f"[skip] {(arch, shape, mesh_name)} (cached)")
                else:
                    todo.append((arch, shape, mp))
    failures = []

    def record(key, row, text):
        nonlocal results
        print(text, end="", flush=True)
        if row is None:
            failures.append(key)
            print(f"[FAIL] {key}", flush=True)
            return
        results = [x for x in results
                   if (x["arch"], x["shape"], x["mesh"]) != key]
        results.append(row)
        save_results(results, path)

    if args.jobs > 1:
        # the longest traces first (train steps, deepest configs), so the
        # pool ends together
        known = set(list_configs())
        todo.sort(key=lambda c: (INPUT_SHAPES[c[1]].kind != "train",
                                 -(get_config(c[0]).n_layers
                                   if c[0] in known else 0)))
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            futures = [(c, pool.submit(_run_quiet, *c)) for c in todo]
            for (arch, shape, mp), fut in futures:
                key = (arch, shape, make_production_mesh(multi_pod=mp).name)
                record(key, *fut.result())
    else:
        for arch, shape, mp in todo:
            key = (arch, shape, make_production_mesh(multi_pod=mp).name)
            record(key, *_run_quiet(arch, shape, mp))
    print(f"\n{len(results)} results, {len(failures)} failures")
    for k in failures:
        print("  FAIL:", k)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
