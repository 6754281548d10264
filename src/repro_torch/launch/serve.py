"""Serving launcher of the PyTorch port.

Modes (on one CUDA card by default, on the CPU with ``--device cpu``):

- host (default): run the Bullet runtime (paged KV pool, fused
  prefill+decode cycles, SLO scheduler; the dense slot cache, serial, for
  ``--arch mamba2-2.7b`` and for ``--arch mixtral-8x22b``, whose sliding
  window the page pool does not hold) over a reduced model variant with
  seeded random weights on a batch of requests. ``--arch`` takes every
  registered config but ``recurrentgemma-2b`` (whose ``pattern_tail`` the
  engine refuses): ``qwen3-1.7b``, ``llama3.1-8b``, ``qwen1.5-4b``,
  ``codeqwen1.5-7b``, ``granite-3-2b`` (at its head dim 64), the
  mixture-of-experts ``llama4-maverick-400b-a17b`` and ``mixtral-8x22b``
  (the reduced variants keep 4 experts), and ``mamba2-2.7b``;
  ``seamless-m4t-large-v2`` is refused too (cross-attention), and
  ``internvl2-76b`` serves its text prompts without the frontend, which
  only the models-level ``prefill`` / ``forward`` take.
- replay: online trace replay through the ``OnlineFrontend``: a
  ``generate_trace`` workload (capped at ``--requests``, lengths fitted to
  ``--max-len``) is released into the engine by arrival time on a
  deterministic virtual clock or the (scaled) wall clock, scored against
  the dataset's Table-2 SLO; ``--fault-plan`` and the deadline/queue flags
  attach seeded fault injection and the SLO guard. ``--tenants N``
  replays a Zipf-skewed closed-loop multi-turn session trace of N apps
  instead (``--requests`` sessions), gated by the tenant admission layer
  (``--credit``, ``--rate-limit``; docs/MULTITENANCY.md), and prints each
  tenant's credit and outcomes. ``--share-prefix`` maps the resident
  pages of a prompt's indexed prefix instead of prefilling it again
  (docs/KV_SHARING.md).

Both engine modes take ``--partition tile|chip|auto`` (docs/PARTITIONS.md)
and ``--devices``, the device group chip granularity carves into a
prefill side and a decode side (default: every visible card; a card may
be listed twice, ``--devices cuda:0,cuda:0``, and then each side has its
own stream and page pool on it). ``--partition chip`` on fewer than two
entries exits with the engine's ``ValueError``.

- sim: the estimator-driven discrete-event comparison of Bullet against
  the paper's baselines (``--systems``: chunked-N, nanoflow-N, naive,
  bullet-fixN, bullet-nosched, bullet-nopart) on one ``generate_trace``
  workload, priced on ``--chips`` H100s (``core/simulate.py``).
- simulate-fleet: ``--replicas`` simulated Bullet instances behind a
  ``--router`` replay a multi-tenant closed-loop session trace
  (``--sessions`` turns; docs/SIMULATOR.md); ``--fault-plan`` dispatch
  specs become replica outage windows.

- dryrun: trace ``prefill_32k`` and ``decode_32k`` of ``--arch`` at full
  width on the meta device on the 16×16 production mesh
  (``launch/dryrun.py``, in-process, where the JAX launcher starts
  subprocesses): each shape's ``[OK]`` line and row; no device is used.

Both simulator modes run no model and use no device (``--device`` is
ignored); they map ``qwen3-1.7b`` to the paper's ``llama3.1-8b`` and print
the ``HardwareSpec`` they priced with before their rows: its SM count is
the card's where one is present, else the H100's 132.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode host
  PYTHONPATH=src python -m repro_torch.launch.serve --mode replay \\
      --device cpu --dataset sharegpt --rate 8 --duration 5 --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode replay \\
      --device cpu --share-prefix --tenants 4 --credit
  PYTHONPATH=src python -m repro_torch.launch.serve --mode replay \\
      --device cpu --devices cpu,cpu --partition chip --rate 4000 \\
      --duration 0.02 --requests 10
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --mode replay --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama4-maverick-400b-a17b --mode replay --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sim \\
      --arch mixtral-8x22b --dataset sharegpt --rate 20
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sim \\
      --dataset sharegpt --rate 40
  PYTHONPATH=src python -m repro_torch.launch.serve --mode simulate-fleet \\
      --replicas 4 --router prefix-affinity --sessions 2000 --rate 120
  PYTHONPATH=src python -m repro_torch.launch.serve --mode dryrun
"""

from __future__ import annotations

import argparse
import sys


def _resilience(args):
    """The faults= / guard= seams from the CLI flags (None when no flag
    asks for them, so the engine keeps NULL_FAULTS and runs unguarded)."""
    faults = guard = None
    if args.fault_plan:
        from repro_torch.resilience import FaultInjector, FaultPlan
        faults = FaultInjector(FaultPlan.from_json(args.fault_plan))
    if (args.fault_plan or args.deadline_ttft is not None
            or args.deadline_total is not None or args.max_queue is not None):
        from repro_torch.resilience import GuardConfig, SLOGuard
        gkw = {}
        if args.deadline_ttft is not None:
            gkw["deadline_ttft_s"] = args.deadline_ttft
        if args.deadline_total is not None:
            gkw["deadline_total_s"] = args.deadline_total
        if args.max_queue is not None:
            gkw["max_queue"] = args.max_queue
        guard = SLOGuard(GuardConfig(**gkw))
    return faults, guard


def _write_obs_outputs(args, server) -> None:
    """Shared --trace-out / --metrics-out export for host and replay."""
    if args.trace_out:
        server.obs.write_trace(args.trace_out)
        print(f"wrote Chrome trace ({len(server.obs.trace)} cycles) to "
              f"{args.trace_out}")
    if args.metrics_out:
        server.obs.write_metrics(args.metrics_out, server=server)
        print(f"wrote metrics snapshot to {args.metrics_out}")


def _device_list(text: str):
    return tuple(d.strip() for d in text.split(",") if d.strip())


def model_config(arch: str):
    """The reduced variant both modes serve, at a head dim the CUDA
    attention kernels of the paged path are built for (``kernels/build.py``
    ``PAGED_HEAD_DIMS``), so the default ``cuda`` device runs the kernels:
    the config's own (Granite's 64) where they are, else 128. For an
    attention-free model (``mamba2-2.7b``) the head-dim override is moot:
    its SSD kernel takes any head dim, and the reduced config's SSD sizes
    stand."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import PAGED_HEAD_DIMS
    full = get_config(arch)
    return full.reduced(head_dim=full.head_dim
                        if full.head_dim in PAGED_HEAD_DIMS else 128)


def _model(args):
    import torch

    from repro_torch.models.transformer import init_params

    cfg = model_config(args.arch)
    return cfg, init_params(cfg, seed=0, dtype=torch.float32,
                            device=args.device)


def _host(args) -> None:
    import numpy as np

    from repro_torch.core.config import build_server_config
    from repro_torch.core.engine import BulletServer
    from repro_torch.obs import Observability
    from repro_torch.obs.report import run_report
    from repro_torch.serving.request import SLO, Request

    cfg, params = _model(args)
    faults, guard = _resilience(args)
    server = BulletServer(cfg, params, config=build_server_config(
        args, slo=SLO(args.slo_ttft, args.slo_tpot), obs=Observability(),
        faults=faults, guard=guard), device=args.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.max_len // 3))
        out = int(rng.integers(2, args.max_len // 4))
        r = Request(rid=rid, arrival=0.0, prompt_len=plen, output_len=out)
        server.submit(r, rng.integers(0, cfg.vocab_size, plen))
    outputs = server.run()
    done = sum(len(v) for v in outputs.values())
    print(run_report(server, header=(
        f"served {len(outputs)} requests, {done} tokens total")))
    _write_obs_outputs(args, server)


def _replay(args) -> None:
    from repro_torch.core.config import build_server_config
    from repro_torch.core.engine import BulletServer
    from repro_torch.core.profiler import SurrogateMachine
    from repro_torch.obs import Observability
    from repro_torch.obs.report import run_report
    from repro_torch.serving.frontend import (OnlineFrontend, VirtualClock,
                                              WallClock, estimator_cycle_cost,
                                              oracle_cycle_cost)
    from repro_torch.serving.request import WORKLOAD_SLOS
    from repro_torch.serving.workload import (fit_trace_to_context,
                                              generate_trace)

    cfg, params = _model(args)
    # replay scores against the dataset's Table-2 SLO (--slo-* applies to
    # host mode); the estimator prices cycles on the H100 spec
    slo = WORKLOAD_SLOS[args.dataset]
    faults, guard = _resilience(args)
    tenancy = None
    if args.tenants > 0:
        from repro_torch.serving.tenancy import (TenancyConfig,
                                                 TenancyController, make_apps)
        tenancy = TenancyController(
            make_apps(args.tenants, rate_limit=args.rate_limit),
            TenancyConfig(credit=args.credit))
    server = BulletServer(cfg, params, config=build_server_config(
        args, slo=slo, refit=not args.no_refit,
        obs=Observability(), faults=faults, guard=guard, tenancy=tenancy),
        device=args.device)
    trace = fit_trace_to_context(
        generate_trace(args.dataset, args.rate, args.duration,
                       seed=args.seed, max_requests=args.requests),
        args.max_len)
    if args.clock == "virtual":
        # --oracle charges the surrogate machine's hidden-truth timings
        # instead of the engine's own estimate, so the refit loop has
        # something to close
        cost = (oracle_cycle_cost(SurrogateMachine(server.est.hw,
                                                   seed=args.seed))
                if args.oracle else estimator_cycle_cost)
        fe = OnlineFrontend(server, VirtualClock(), cycle_cost=cost)
    else:
        fe = OnlineFrontend(server, WallClock(speed=args.time_scale))
    if args.stream:
        fe.on_token = lambda r, tok, t: print(
            f"  [{t:8.3f}s] rid={r.rid} tok#{r.generated}={tok}")
    if tenancy is not None:
        # multi-tenant replay: a Zipf-skewed closed-loop interaction
        # trace instead of the flat open-loop one (docs/MULTITENANCY.md)
        from repro_torch.serving.tenancy import generate_tenant_interactions
        sessions = generate_tenant_interactions(
            list(tenancy.apps.values()),
            n_sessions=max(args.requests, 1), rate_s=args.rate,
            seed=args.seed)
        fe.submit_interactions(sessions, cfg.vocab_size, seed=args.seed)
        n_submitted, kind = len(sessions), "sessions"
    else:
        fe.submit_trace(trace, cfg.vocab_size, seed=args.seed)
        n_submitted, kind = len(trace), "requests"
    m = fe.run()
    if fe.truncated:
        print("WARNING: replay hit max_cycles with unfinished requests; "
              "metrics cover the completed subset only")
    print(run_report(server, metrics=m, header=(
        f"replay({args.clock}) {args.dataset} rate={args.rate}/s "
        f"dur={args.duration}s -> {n_submitted} {kind}")))
    if guard is not None and guard.transitions:
        print("guard transitions: " + " ".join(
            t["transition"] for t in guard.transitions))
    if tenancy is not None:
        tenancy.check_oit()
        for app_id, st in sorted(tenancy.stats.items()):
            print(f"  tenant {tenancy._label(app_id):8s} "
                  f"credit={tenancy.credit(app_id):.2f} "
                  f"admitted={st.admitted} throttled={st.throttled} "
                  f"finished={st.finished} goodput={st.goodput}")
    _write_obs_outputs(args, server)


def spec_line(hw) -> str:
    """The HardwareSpec a simulator mode priced with, on one line."""
    return (f"spec: {hw.name} x{hw.n_chips}, {hw.units_per_chip} SMs a card "
            f"({hw.total_units} units, grid_slots {hw.grid_slots}), peak "
            f"{hw.peak_flops / 1e12:g} TFLOP/s bf16, HBM "
            f"{hw.hbm_bw / 1e12:g} TB/s, link {hw.ici_bw / 1e9:g} GB/s")


def fitted_estimator(cfg, chips: int):
    """The H100 spec on ``chips`` cards and an estimator fitted to its
    surrogate profile, as the simulator modes price with."""
    from repro_torch.core.estimator import (HardwareSpec, PerfEstimator,
                                            fit_params)
    from repro_torch.core.profiler import run_profiling

    hw = HardwareSpec(n_chips=chips)
    samples = run_profiling(cfg, hw, max_sl=4096, max_bs=32, max_cl=4096)
    return hw, PerfEstimator(hw, fit_params(samples, cfg, hw, iters=30))


def _sim(args) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.profiler import SurrogateMachine
    from repro_torch.core.simulate import ServingSimulator, SimConfig
    from repro_torch.serving.request import WORKLOAD_SLOS
    from repro_torch.serving.workload import generate_trace

    cfg = get_config(args.arch)
    hw, est = fitted_estimator(cfg, args.chips)
    print(spec_line(hw))
    slo = WORKLOAD_SLOS[args.dataset]
    for system in args.systems.split(","):
        trace = generate_trace(args.dataset, args.rate, args.duration,
                               seed=args.seed)
        s = ServingSimulator(SimConfig(model=cfg, hw=hw, slo=slo), est,
                             SurrogateMachine(hw, seed=7), system)
        m = s.run(trace)
        print(f"{system:16s} {m.row()}")


def _fleet(args) -> None:
    from repro_torch.configs import get_config
    from repro_torch.resilience import FaultPlan
    from repro_torch.serving.request import WORKLOAD_SLOS
    from repro_torch.serving.tenancy import generate_fleet_interactions
    from repro_torch.sim import ClusterConfig, ClusterSimulator, tail_point

    cfg = get_config(args.arch)
    hw, est = fitted_estimator(cfg, args.chips)
    print(spec_line(hw))
    slo = WORKLOAD_SLOS[args.dataset]
    work = generate_fleet_interactions(args.sessions, args.rate,
                                       seed=args.seed)
    faults = (FaultPlan.from_json(args.fault_plan)
              if args.fault_plan else None)
    cc = ClusterConfig(sim=fleet_sim_config(cfg, hw, slo),
                       n_replicas=args.replicas, router=args.router,
                       faults=faults, seed=args.seed)
    res = ClusterSimulator(cc, est).run(work)
    print(f"fleet {args.replicas}x{args.arch} router={args.router} "
          f"{len(res.requests)} requests ({len(work)} sessions) "
          f"@ {args.rate:.0f} req/s")
    print(f"  {res.metrics.row()}")
    print("  " + tail_line(tail_point(res.requests, slo), res))
    for i, (cycles, refits, reused) in enumerate(res.replica_stats):
        print(f"  replica {i}: cycles={cycles} refits={refits} "
              f"reused_prefill_tokens={reused}")


def fleet_sim_config(cfg, hw, slo):
    """The fleet level's fidelity/speed knobs: the scheduler over layer
    groups of 8, run every 4th cycle on the first 64 pending requests, the
    estimator refit every 512 cycles."""
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.core.simulate import SimConfig
    return SimConfig(model=cfg, hw=hw, slo=slo,
                     scheduler=SchedulerConfig(layer_group=8),
                     sched_every=4, refit_interval=512, sched_pending_cap=64)


def tail_line(pt, res) -> str:
    """One ``tail_point`` of a fleet run, as ``--mode simulate-fleet``
    prints it."""
    return (f"attainment={pt['attainment']:.3f} "
            f"p99_norm_ttft={pt['p99_norm_ttft_ms']:.1f}ms "
            f"p99_tpot={pt['p99_tpot_ms']:.2f}ms "
            f"slo_holds={pt['holds']} rerouted={res.rerouted} "
            f"cancelled_no_replica={res.cancelled_no_replica}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("host", "replay", "sim",
                                       "simulate-fleet", "dryrun"),
                    default="host")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--share-prefix", action="store_true",
                    help="ref-counted shared-prefix KV page reuse: "
                         "requests whose prompt matches resident pages "
                         "map them read-only instead of re-prefilling "
                         "(paged pool only; docs/KV_SHARING.md)")
    ap.add_argument("--partition", choices=("tile", "chip", "auto"),
                    default="tile",
                    help="partition granularity (docs/PARTITIONS.md): tile "
                         "= fused spatial sharing on every chip; chip = "
                         "disjoint prefill/decode sub-meshes with KV "
                         "handoff (needs >= 2 devices); auto = per-task "
                         "combined-table argmin")
    ap.add_argument("--devices", type=_device_list, default=None,
                    metavar="DEV,DEV,...",
                    help="the device group --partition chip|auto carves, "
                         "e.g. cuda:0,cuda:1 (default: every visible "
                         "card); a card may be listed twice")
    ap.add_argument("--slo-ttft", type=float, default=3.0)
    ap.add_argument("--slo-tpot", type=float, default=150.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="sharegpt",
                    choices=("sharegpt", "azure-code", "arxiv-summary"))
    ap.add_argument("--rate", type=float, default=40.0,
                    help="replay arrival rate (requests per trace second)")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="replay trace length in trace seconds")
    ap.add_argument("--chips", type=int, default=1,
                    help="H100s per instance the simulator modes price "
                         "(the engine itself runs on one card)")
    ap.add_argument("--systems",
                    default="bullet,chunked-1024,chunked-2048,naive",
                    help="comma-separated systems of --mode sim")
    ap.add_argument("--replicas", type=int, default=4,
                    help="fleet size for --mode simulate-fleet: number of "
                         "simulated Bullet replicas behind the router")
    ap.add_argument("--router", default="prefix-affinity",
                    help="cluster routing policy (simulate-fleet mode): "
                         "round-robin, least-kv, prefix-affinity, or "
                         "tenant-aware (docs/SIMULATOR.md)")
    ap.add_argument("--sessions", type=int, default=2000, metavar="N",
                    help="closed-loop turn budget for the simulate-fleet "
                         "multi-tenant trace (sessions are drawn until "
                         "their turns total at least N)")
    ap.add_argument("--clock", choices=("virtual", "wall"), default="virtual",
                    help="replay clock: deterministic virtual time or "
                         "(scaled) wall time")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="wall-clock replay speedup (trace seconds per "
                         "wall second)")
    ap.add_argument("--oracle", action="store_true",
                    help="virtual replay advances on the surrogate "
                         "machine's timings instead of the engine's own "
                         "estimate")
    ap.add_argument("--no-refit", action="store_true",
                    help="pin the estimator's offline params")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they stream back (replay mode)")
    ap.add_argument("--fault-plan", default=None, metavar="JSON",
                    help="inject a seeded fault plan (a JSON file path or "
                         "inline JSON object, docs/RESILIENCE.md) under the "
                         "SLO guard")
    ap.add_argument("--deadline-ttft", type=float, default=None,
                    metavar="SECONDS",
                    help="cancel a request whose first token has not "
                         "streamed by this trace-time age (SLO guard)")
    ap.add_argument("--deadline-total", type=float, default=None,
                    metavar="SECONDS",
                    help="cancel a request still unfinished at this "
                         "trace-time age")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the pending queue; the frontend retries "
                         "rejected submissions, then sheds")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="multi-tenant replay: N apps with Zipf-skewed "
                         "closed-loop sessions over a 50k-user id space, "
                         "gated by the tenant admission layer "
                         "(docs/MULTITENANCY.md; replay mode)")
    ap.add_argument("--credit", action="store_true",
                    help="credit-biased admission order and preemption-"
                         "victim choice (per-tenant SLO-violation / "
                         "tail-latency history; needs --tenants)")
    ap.add_argument("--rate-limit", type=int, default=0, metavar="N",
                    help="per-tenant sliding-window budget of new "
                         "interactions per second (0 = unlimited); "
                         "mid-conversation turns are never throttled")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the per-cycle Chrome trace-event JSON here")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus-style metrics snapshot here")
    args = ap.parse_args(argv)
    if args.oracle and args.clock != "virtual":
        ap.error("--oracle needs --clock virtual")
    if args.credit and args.tenants <= 0:
        ap.error("--credit biases the tenant admission layer; "
                 "needs --tenants N")
    if args.tenants > 0 and args.mode != "replay":
        ap.error("--tenants drives the multi-tenant interaction replay; "
                 "use --mode replay")
    if args.mode == "dryrun":
        from repro_torch.launch import dryrun
        code = 0
        for shape in ("prefill_32k", "decode_32k"):
            try:
                dryrun.main(["--arch", args.arch, "--shape", shape])
            except SystemExit as e:     # a failed shape: run the other too
                code |= int(e.code or 0)
        return code
    if args.mode in ("sim", "simulate-fleet"):
        # the simulator modes price the paper's own model
        args.arch = "llama3.1-8b" if args.arch == "qwen3-1.7b" else args.arch
        (_sim if args.mode == "sim" else _fleet)(args)
    elif args.mode == "replay":
        _replay(args)
    else:
        _host(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
