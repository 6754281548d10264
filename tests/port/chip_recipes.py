"""The chip-granular engine recipes of tests/test_submesh.py,
tests/test_resilience.py and tests/test_system.py, stated once for both
engines: the request batches and traces (numpy, seeded), the server
settings and the estimator regimes, and the JAX chip engine's runs.

The JAX chip engine needs several JAX devices, so it runs in processes of
its own with 8 virtual CPU devices, one per group of recipes (``engine``:
tests/test_submesh.py's; ``replays``: the resilience and differential
ones), so that the two can run at once:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/port/chip_recipes.py engine

Each prints one line, ``CHIP_RECIPES_JSON`` and a JSON object: per recipe
the token streams by request id and the engine counters
(``test_torch_submesh.py`` holds the port's against them).
"""

from __future__ import annotations

import json
import sys

import numpy as np

#: the estimator's hardware fields, given to both engines (``n_chips`` is
#: the device group's length)
HW = dict(name="h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
          ici_bw=450e9, units_per_chip=8, grid_slots=8)

#: tests/test_submesh.py's estimator regimes (hardware, params): co-location
#: contention priced punitively and a near-free interconnect (chip must
#: win), and contention priced away with a starved interconnect (tile must)
REGIMES = {"cheap": (dict(ici_bw=1e13), dict(p_c=0.5, p_b=0.5)),
           "dear": (dict(ici_bw=1e6), dict(p_c=1.0, p_b=1.0))}

#: the server settings of the recipes (tests/test_submesh.py mk_server)
SERVER = dict(max_slots=4, max_len=48, max_prefill_batch=1)

#: the engine recipes: name -> (group length, partition, requests, seed,
#: regime or None)
ENGINE = {"seed0": (2, "chip", 6, 0, None),
          "seed5": (2, "chip", 6, 5, None),
          "wide": (8, "chip", 4, 3, None),
          "auto_cheap": (2, "auto", 6, 0, "cheap"),
          "auto_dear": (2, "auto", 6, 0, "dear")}

#: the chip replays' fault plans (tests/test_resilience.py): name ->
#: (fault specs as dicts, guard cooldown cycles) or None (clean)
REPLAY = {"replay_clean": None,
          "replay_transient": ([dict(kind="handoff", count=2)], 8),
          "replay_exhausted": ([dict(kind="handoff", start=0, end=4)], 6)}

#: the recipe groups, each one process
GROUPS = {"engine": tuple(ENGINE),
          "replays": tuple(REPLAY) + ("cancel", "diff")}

COUNTERS = ("chip_cycles", "handoffs", "fused_cycles", "handoff_retries",
            "prefill_aborts")


def hw_fields(n_chips: int, regime=None) -> dict:
    return dict(HW, n_chips=n_chips, **(REGIMES[regime][0] if regime
                                        else {}))


def param_fields(regime=None) -> dict:
    return dict(REGIMES[regime][1]) if regime else {}


def batch(vocab: int, n: int, seed: int, out_len: int = 8):
    """tests/test_submesh.py submit_batch: (rid, prompt, output length)."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        plen = int(rng.integers(4, 16))
        out.append((rid, rng.integers(0, vocab, plen), out_len))
    return out


def replay_trace(vocab: int, n: int = 4):
    """tests/test_resilience.py chip_replay: (rid, arrival, prompt,
    output length), all arriving at 0."""
    rng = np.random.default_rng(3)
    reqs = [(rid, 0.0, int(rng.integers(4, 14)), 6) for rid in range(n)]
    return [(rid, arr, rng.integers(0, vocab, plen, dtype=np.int32), olen)
            for rid, arr, plen, olen in reqs]


def cancel_requests(vocab: int):
    """tests/test_resilience.py's mid-prefill cancel: (rid, prompt,
    output length) of its two requests."""
    rng = np.random.default_rng(2)
    return [(0, rng.integers(0, vocab, 12), 6),
            (1, rng.integers(0, vocab, 8), 4)]


def interactions(generate, make_apps):
    """tests/test_system.py's differential trace (either package's
    ``generate_tenant_interactions`` and ``make_apps``)."""
    return generate(make_apps(2), 5, rate_s=200.0, turns=2, new_tokens=8,
                    output_tokens=5, seed=11)


def streams(outputs) -> dict:
    """Token streams keyed by the request id as a string (JSON's keys)."""
    return {str(rid): [int(t) for t in toks]
            for rid, toks in outputs.items()}


def summary(server, outputs=None) -> dict:
    out = {"outputs": streams(server.outputs if outputs is None
                              else outputs)}
    out.update({k: getattr(server.stats, k) for k in COUNTERS})
    return out


# ---------------------------------------------------------------------------
# the JAX chip engine (run in its own process, 8 virtual devices)
# ---------------------------------------------------------------------------

def _jax_main(group: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core.config import ControlConfig, ExecConfig, ServerConfig
    from repro.core.engine import BulletServer
    from repro.core.estimator import (EstimatorParams, HardwareSpec,
                                      PerfEstimator)
    from repro.core.scheduler import SchedulerConfig
    from repro.models import init_params
    from repro.serving.request import SLO

    devs = jax.devices()
    assert len(devs) == 8, devs
    cfg = get_config("qwen3-1.7b").reduced(n_layers=2)
    params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)

    def est(n, regime=None):
        return PerfEstimator(HardwareSpec(**hw_fields(n, regime)),
                             EstimatorParams(**param_fields(regime)))

    def server(n, partition="chip", regime=None, faults=None, guard=None,
               **kw):
        return BulletServer(cfg, params, config=ServerConfig(
            slo=SLO(3.0, 150.0), est=est(n, regime), faults=faults,
            guard=guard,
            execution=ExecConfig(partition=partition,
                                 devices=tuple(devs[:n])),
            control=ControlConfig(
                sched=SchedulerConfig(max_decode_pause_cycles=0)),
            **dict(SERVER, **kw)))

    res = {}
    if group == "engine":
        _jax_engine(res, server)
    else:
        _jax_replays(res, cfg, params, est, server, devs)
    print("CHIP_RECIPES_JSON " + json.dumps(res))


def _jax_engine(res, server) -> None:
    from repro.serving.request import Request

    for name, (n, partition, n_req, seed, regime) in ENGINE.items():
        s = server(n, partition, regime)
        for rid, prompt, olen in batch(s.cfg.vocab_size, n_req, seed):
            s.submit(Request(rid=rid, arrival=0.0, prompt_len=len(prompt),
                             output_len=olen), prompt)
        s.run()
        res[name] = summary(s)


def _jax_replays(res, cfg, params, est, server, devs) -> None:
    from repro.core.config import CacheConfig, ExecConfig, ServerConfig
    from repro.core.engine import BulletServer
    from repro.resilience import (FaultInjector, FaultPlan, FaultSpec,
                                  GuardConfig, SLOGuard)
    from repro.serving.frontend import (OnlineFrontend, VirtualClock,
                                        estimator_cycle_cost)
    from repro.serving.request import Phase, Request, SLO
    from repro.serving.tenancy import generate_tenant_interactions, make_apps

    for name, plan in REPLAY.items():
        faults = guard = None
        if plan is not None:
            specs, cooldown = plan
            faults = FaultInjector(FaultPlan(
                specs=[FaultSpec(**sp) for sp in specs], seed=1))
            guard = SLOGuard(GuardConfig(cooldown_cycles=cooldown))
        s = server(2, faults=faults, guard=guard)
        fe = OnlineFrontend(s, VirtualClock(), cycle_cost=estimator_cycle_cost,
                            on_cycle=lambda srv, t: srv.check_invariants())
        for rid, arr, prompt, olen in replay_trace(cfg.vocab_size):
            fe.submit(Request(rid=rid, arrival=arr, prompt_len=len(prompt),
                              output_len=olen), prompt)
        m = fe.run()
        res[name] = summary(s)
        res[name].update(
            n_requests=m.n_requests,
            transitions=[t["transition"] for t in guard.transitions]
            if guard is not None else [],
            free=s.pool.free_blocks == s.pool.n_blocks)

    s = server(2, max_prefill_batch=2)
    reqs = [Request(rid=rid, arrival=0.0, prompt_len=len(p), output_len=o)
            for rid, p, o in cancel_requests(cfg.vocab_size)]
    for r, (_, p, _) in zip(reqs, cancel_requests(cfg.vocab_size)):
        s.submit(r, p)
    now = 0.0
    while reqs[0].phase != Phase.PREFILL:
        s.step(now)
        now += 1e-3
    s.cancel_request(reqs[0], now, why="operator")
    s.run()
    res["cancel"] = summary(s)
    res["cancel"]["phases"] = [r.phase.name for r in reqs]

    srv = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=est(2), max_slots=4, max_len=64,
        cache=CacheConfig(paged=True, page_size=4),
        execution=ExecConfig(partition="chip", devices=tuple(devs[:2]))))
    fe = OnlineFrontend(srv, VirtualClock(),
                        on_cycle=lambda s, now: s.pool.check_invariants())
    fe.submit_interactions(interactions(generate_tenant_interactions,
                                        make_apps), cfg.vocab_size, seed=11)
    fe.run()
    done = {r.rid: srv.outputs[r.rid] for r in fe.requests
            if r.phase == Phase.FINISHED}
    res["diff"] = summary(srv, done)
    res["diff"]["n_requests"] = len(fe.requests)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
    sys.exit(0)
