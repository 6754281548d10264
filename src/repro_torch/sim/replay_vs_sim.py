"""Replay-vs-sim cross-validation: the port's copy of the JAX package's
``cross_validate`` (docs/SIMULATOR.md). The same trace runs (a) through
the fused/refit-aware discrete-event simulator
(:class:`repro_torch.core.simulate.ServingSimulator`) and (b) through the
port's own ``BulletServer`` behind the online frontend on an
estimator-clocked virtual replay, its kernels launched on the card when
``device="cuda"``; the cycle economics land side by side.

It gates on two invariants rather than eyeballing rows:

- **Partition-table honesty** — the simulator must schedule over exactly
  the partition table the engine pre-built (same SM quantization, same
  chip splits). A private re-quantization in the sim silently changes
  every downstream capacity answer, so a mismatch raises RuntimeError
  instead of producing numbers.
- **Mean-cycle agreement** — both sides price cycles through the one
  :func:`repro_torch.core.estimator.predict_cycle` charging rule, so the
  mean predicted cycle time of the sim's schedule should agree with the
  mean of the engine's fused replay within ``CYCLE_TOL`` (15%); the
  caller holds ``cycle_gap`` to it. Residual gap is genuine composition
  divergence (admission order, pause decisions), not pricing drift.

The virtual clock prices what each cycle composed, not how long the card
took, so the cycle counts and the gap are the same on the card and on the
CPU for the same engine decisions.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.estimator import PerfEstimator
from repro_torch.core.profiler import SurrogateMachine
from repro_torch.core.simulate import ServingSimulator, SimConfig
from repro_torch.serving.request import WORKLOAD_SLOS, Request

DATASET = "sharegpt"
#: sim-vs-engine mean predicted cycle time must agree within this
CYCLE_TOL = 0.15


def _clone(trace):
    return [Request(rid=r.rid, arrival=r.arrival, prompt_len=r.prompt_len,
                    output_len=r.output_len) for r in trace]


def cross_validate(cfg, est: PerfEstimator, trace: List[Request], *,
                   params, device, max_len: int, max_slots: int = 4,
                   truth_seed: int = 7) -> Dict:
    """Run ``trace`` through the simulator and the port's engine on a
    virtual replay; return both metrics, both partition tables, and the
    mean predicted cycle time on each side.

    ``params`` live on ``device`` (the card's seeded ``init_params``, or
    the JAX ones bridged onto the CPU) and set the engine's dtype.
    Raises RuntimeError when the simulator's partition table or split
    candidates are not the engine's — the drift this gate exists to catch.
    """
    from repro_torch.core.config import ServerConfig
    from repro_torch.core.engine import BulletServer
    from repro_torch.serving.frontend import (OnlineFrontend, VirtualClock,
                                              estimator_cycle_cost)

    hw = est.hw
    slo = WORKLOAD_SLOS[DATASET]

    # simulator side: cap the decode batch at the engine's slot count so
    # both sides chop the same work into comparably sized cycles
    sim_s = ServingSimulator(
        SimConfig(model=cfg, hw=hw, slo=slo, max_decode_batch=max_slots),
        est, SurrogateMachine(hw, seed=truth_seed), "bullet")
    m_sim = sim_s.run(_clone(trace))

    # engine side: the port's model, virtual clock advanced by the shared
    # predict_cycle charging rule
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=slo, est=est, max_slots=max_slots, max_len=max_len,
        dtype=params["embed"].dtype), device=device)
    eng_cycles: List[float] = []

    def _charge(s) -> float:
        dt = estimator_cycle_cost(s)
        if s.last_cycle_observation() is not None:
            eng_cycles.append(dt)
        return dt

    fe = OnlineFrontend(server, VirtualClock(), cycle_cost=_charge)
    for r in _clone(trace):
        fe.submit(r, np.random.default_rng(r.rid).integers(
            0, cfg.vocab_size, r.prompt_len, dtype=np.int32))
    m_replay = fe.run()

    sim_table = [p.key for p in sim_s.replica.rm.partitions]
    eng_table = [p.key for p in server.rm.partitions]
    if sim_table != eng_table:
        raise RuntimeError(
            "partition-table drift: the simulator scheduled over\n"
            f"  {sim_table}\nbut the engine pre-built\n  {eng_table}\n"
            "repro_torch.core.simulate must mirror the engine's "
            "ResourceManager table exactly (see docs/SIMULATOR.md)")
    if sim_s.replica.scheduler.split_candidates != \
            server.scheduler.split_candidates:
        raise RuntimeError(
            "split-candidate drift between sim scheduler and engine "
            "scheduler — both must search the pre-built tile table")

    sim_preds = [p for _, p, _ in sim_s.pred_actual]
    mean_sim = sum(sim_preds) / max(len(sim_preds), 1)
    mean_eng = sum(eng_cycles) / max(len(eng_cycles), 1)
    return {
        "m_sim": m_sim, "m_replay": m_replay,
        "mean_cycle_sim_s": mean_sim, "mean_cycle_eng_s": mean_eng,
        "cycle_gap": abs(mean_sim - mean_eng) / max(mean_eng, 1e-12),
        "n_cycles_sim": len(sim_preds), "n_cycles_eng": len(eng_cycles),
        "table": sim_table, "server": server,
    }
