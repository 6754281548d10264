"""Tensor parallelism across cards over NCCL: Qwen3-1.7B at full width and
depth, one rank per card (``launch/mesh.run_on_mesh``'s default devices).

    python3 scripts/tp_scaling.py            # every mesh the cards allow
    python3 scripts/tp_scaling.py --meshes 1x1,1x2 --profile-host

For each mesh (``1x1``: one card, unsharded; ``1xN``: the model axis over
N cards; ``2x2``: data 2 x model 2), in bf16: a prefill of PREFILL_B
prompts of PREFILL_S tokens and a decode step over DECODE_B slots at
context DECODE_CTX, each timed REPS times after a warm-up: the wall ms of
the step ended by a synchronize, the host ms until the call returns (the
host enqueues every op from one Python thread a rank), the device ms of
the step's kernels and their busy share (torch.profiler over one step),
and the step's collective bytes by type beside the least time they take
at the NVLink rate (``launch/roofline.ICI_BW``); with ``--profile-host``
also the host functions that take most of a decode step (cProfile over
HOST_STEPS steps, by own time). Every mesh runs in spawned ranks, the
one-card mesh too, so each number comes from a process of the same
kind. Every rank runs the same step; rank 0's numbers are printed, with
the card's name and power limit, as one JSON line a mesh, the last line
all of them.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

PREFILL_B, PREFILL_S = 1, 1024
DECODE_B, DECODE_CTX = 8, 1024
REPS = 10
HOST_STEPS, HOST_ROWS = 5, 15


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power."
                          "limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return res.stdout.strip()


def _time(fn, dev) -> dict:
    """Wall ms (synchronized), host ms (until the call returns) and, from
    torch.profiler over one more call, the kernels' device ms and busy
    share."""
    fn()
    torch.cuda.synchronize(dev)
    walls, hosts = [], []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in prof.key_averages())
    return {"wall_ms": statistics.median(walls),
            "host_ms": statistics.median(hosts),
            "device_ms": device_us / 1e3 if device_us else None,
            "busy": device_us / 1e3 / wall if device_us else None}


def _host_profile(fn) -> list:
    """The HOST_ROWS functions of most own time over HOST_STEPS calls:
    (function, calls, own ms a step, cumulative ms a step)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(HOST_STEPS):
        fn()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:HOST_ROWS]
    return [(f"{os.path.basename(k[0])}:{k[1]}({k[2]})", v[1] // HOST_STEPS,
             v[2] / HOST_STEPS * 1e3, v[3] / HOST_STEPS * 1e3)
            for k, v in rows]


def _rank(mesh, sizes, profile_host=False):
    """One mesh's steps on this rank (unsharded for a mesh of one)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import ICI_BW
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    cfg = get_config("qwen3-1.7b")
    dev = mesh.device
    dt = torch.bfloat16
    policy = SH.make_policy(cfg, mesh, global_batch=DECODE_B)
    run = policy if mesh.size > 1 else None
    params = T.init_params(cfg, seed=0, dtype=dt, device=dev, policy=run)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = DECODE_B // (policy.data_size if run and policy.shard_batch
                        else 1)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                         generator=gen, device=dev, dtype=torch.int32)
    lens = torch.full((PREFILL_B,), PREFILL_S, dtype=torch.int32,
                      device=dev)
    ppolicy = SH.make_policy(cfg, mesh, global_batch=PREFILL_B) if run \
        else None
    pcache = T.init_cache(cfg, PREFILL_B, PREFILL_S, dt, dev, policy=ppolicy)
    dcache = T.init_cache(cfg, DECODE_B, DECODE_CTX + 8, dt, dev,
                          policy=run)
    tok = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    pos = torch.full((rows,), DECODE_CTX, dtype=torch.int32, device=dev)
    out = {"mesh": "x".join(map(str, sizes)), "ranks": mesh.size,
           "backend": getattr(mesh, "backend", "none")}
    with torch.no_grad():
        for name, fn in (
                ("prefill", lambda: T.prefill(params, toks, lens, pcache,
                                              None, cfg, policy=ppolicy)),
                ("decode", lambda: T.decode_step(params, dcache, tok, pos,
                                                 cfg, policy=run))):
            SH.COLLECTIVES.reset()
            fn()
            torch.cuda.synchronize(dev)
            coll = SH.COLLECTIVES.read()["bytes"]
            out[name] = dict(_time(fn, dev), collective_bytes=coll,
                             collective_ms_at_nvlink=sum(coll.values())
                             / ICI_BW * 1e3)
            if profile_host and name == "decode":
                out["decode_host_profile"] = _host_profile(fn)
                torch.cuda.synchronize(dev)
    return out


def main(argv=None) -> int:
    from repro_torch.launch.mesh import mesh_shape, run_on_mesh
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--meshes", default=None,
                    help="comma list of meshes (1x1, 1x2, 1x4, 2x2)")
    ap.add_argument("--profile-host", action="store_true",
                    help="cProfile rank 0's decode steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    build.library()                 # before the ranks, which load it
    n = torch.cuda.device_count()
    want = (args.meshes.split(",") if args.meshes else
            [m for m in ("1x1", "1x2", "1x4", "2x2")
             if math.prod(map(int, m.split("x"))) <= n])
    card = _card()
    print(f"card: {card}; {n} visible", flush=True)
    rows = []
    for m in want:
        sizes = tuple(int(x) for x in m.split("x"))
        row = run_on_mesh(_rank, mesh_shape(sizes), sizes,
                          args.profile_host, timeout=900)[0]
        row["card"] = card
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"tp_scaling": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
