"""Hillclimb harness of the port (the JAX package's ``launch/perf.py``):
trace one (arch × shape) on the meta device under a named variant, report
the roofline terms and the top traffic contributors, and append the
iteration to launch_results/torch_perf_iterations.json.

The variants are the sharding policy's options, as flags (``--moe-2d``,
``--fsdp``; the JAX harness set them through ``--env`` knobs). They move
``resident_gb``; the traced step is the whole step on one card either
way. ``--measure`` also runs the step on the card when it fits there
(``one_card_gb`` within the card's 80 GB): random params and inputs at the
combination's shapes, the median of CUDA-event timings beside the
roofline time.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-1.7b \\
      --shape long_500k --name baseline [--measure]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.kernels import cost
from repro_torch.launch.dryrun import memory_gb, trace
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_dryrun, sharded_resident_gb
from repro_torch.models import transformer as T
from repro_torch.training.tree import leaves, unflatten

OUT = (Path(__file__).resolve().parents[3] / "launch_results"
       / "torch_perf_iterations.json")


def top_traffic(counter, n: int = 12):
    """The ops that moved the most bytes: (bytes over all calls, op,
    input shapes, calls), largest first, from the counter's op log."""
    rows = [(nbytes * calls, op, shapes, calls)
            for (op, shapes), (nbytes, calls) in counter.ops.items()]
    rows.sort(key=lambda r: r[0], reverse=True)
    return rows[:n]


def step_ms(fn, reps: int = 5):
    """Card ms of each of ``reps`` calls of ``fn()`` (CUDA events, after
    one untimed call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times


def card_args(arch: str, shape_name: str, args, *, seed: int = 0,
              device="cuda"):
    """The dry-run's meta args on ``device``: seeded params from the port's
    init (the train state's moments zero), zero caches, tokens and labels
    drawn from the vocabulary, every prompt at its full length, every
    decode slot at its last position, frontend frames N(0, 1)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def inputs(ins: dict) -> dict:
        out = {}
        for k, t in ins.items():
            if k in ("tokens", "labels"):
                out[k] = torch.randint(0, cfg.vocab_size, t.shape,
                                       generator=gen, device=device,
                                       dtype=t.dtype)
            elif k == "lengths":
                out[k] = torch.full(t.shape, shape.seq_len, dtype=t.dtype,
                                    device=device)
            elif k == "pos":
                out[k] = torch.full(t.shape, shape.seq_len - 1,
                                    dtype=t.dtype, device=device)
            else:
                out[k] = torch.randn(t.shape, generator=gen, device=device,
                                     dtype=t.dtype)
        return out

    def zeros(tree):
        return unflatten(tree, [torch.zeros(t.shape, dtype=t.dtype,
                                            device=device)
                                for t in leaves(tree)])

    if shape.kind == "train":
        state, batch = args
        params = T.init_params(cfg, seed=seed, dtype=leaves(state.params)[0]
                               .dtype, device=device)
        return type(state)(params, zeros(state.opt_state)), inputs(batch)
    params = T.init_params(cfg, seed=seed, dtype=leaves(args[0])[0].dtype,
                           device=device)
    names = ["tokens", "lengths", "frontend"] if shape.kind == "prefill" \
        else ["tokens", "pos"]
    rest = inputs(dict(zip(names, args[2:])))
    return (params, zeros(args[1]), *rest.values())


def run(arch: str, shape: str, name: str, notes: str = "",
        show_ops: bool = True, *, moe_2d=None, fsdp=None,
        measure: bool = False, reps: int = 5) -> dict:
    mesh = make_production_mesh()
    t0 = time.time()
    fn, args, in_specs, _, policy = build_dryrun(arch, shape, mesh,
                                                 moe_2d=moe_2d, fsdp=fsdp)
    counter, out = trace(fn, args)
    rep = counter.report
    t = rep.terms()
    mem = memory_gb(args, out, counter)
    result = {
        "arch": arch, "shape": shape, "variant": name, "notes": notes,
        "policy": {"moe_2d_weights": policy.moe_2d_weights,
                   "fsdp": policy.fsdp},
        "terms_ms": {k: v * 1e3 for k, v in t.items()},
        "dominant": rep.dominant(),
        "collective_bytes": rep.collective_bytes,
        "hbm_gb": rep.hbm_bytes / 2**30,
        "one_card_gb": mem["one_card_gb"],
        "resident_gb": sharded_resident_gb(args, in_specs, mesh),
        "kernels": rep.kernels,
        "trace_s": round(time.time() - t0, 1),
    }
    print(f"[{name}] {arch} {shape}: compute={t['compute_s']*1e3:.1f}ms "
          f"memory={t['memory_s']*1e3:.1f}ms "
          f"collective={t['collective_s']*1e3:.1f}ms "
          f"(hbm {result['hbm_gb']:.1f}GB, one card "
          f"{mem['one_card_gb']:.2f}GB, resident "
          f"{result['resident_gb']:.2f}GB a device)")
    if show_ops:
        for nbytes, op, shapes, calls in top_traffic(counter):
            print(f"   {nbytes/2**30:8.2f}GB {op:24s} x{calls:<6d} {shapes}")
    if measure:
        result["measured_ms"] = _measure(arch, shape, fn, args, mem,
                                         rep.roofline_s() * 1e3, reps)
    hist = json.loads(OUT.read_text()) if OUT.exists() else []
    hist.append(result)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(hist, indent=1))
    return result


def _measure(arch, shape, fn, meta_args, mem, roof_ms, reps):
    """The step's median card ms, or None when it does not fit one card."""
    need = mem["one_card_gb"] * 2**30
    if need > cost.HBM_BYTES:
        print(f"   measure: the step needs {need / 1e9:.1f} GB, more than "
              f"one card's {cost.HBM_BYTES / 1e9:.0f} GB: not run")
        return None
    args = card_args(arch, shape, meta_args)
    with torch.no_grad():
        ms = statistics.median(step_ms(lambda: fn(*args), reps))
    print(f"   measured {ms:.3f} ms (median of {reps}) against the roofline's "
          f"{roof_ms:.3f} ms: share {roof_ms / ms:.3f}, on "
          f"{torch.cuda.get_device_name(0)}")
    return ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--notes", default="")
    ap.add_argument("--moe-2d", choices=("on", "off"), default=None,
                    help="2D expert weights (default: on for a MoE decode)")
    ap.add_argument("--fsdp", choices=("on", "off"), default=None,
                    help="FSDP weights (default: training, or weights over "
                         "8 GB a device)")
    ap.add_argument("--measure", action="store_true",
                    help="also time the step on the card, if it fits")
    ap.add_argument("--no-ops", action="store_true")
    args = ap.parse_args(argv)
    flag = {None: None, "on": True, "off": False}
    run(args.arch, args.shape, args.name, args.notes,
        show_ops=not args.no_ops, moe_2d=flag[args.moe_2d],
        fsdp=flag[args.fsdp], measure=args.measure)


if __name__ == "__main__":
    main()
