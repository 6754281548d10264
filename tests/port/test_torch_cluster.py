"""The port's fleet and capacity levels (``sim/cluster.py``,
``sim/capacity.py``) against the JAX package's on the CPU: for every
router, with and without a replica outage, the same per-request
timestamps, cycles, per-replica stats and failure counts, bit for bit, on
the same spec fields and seeds; the capacity helpers' answers equal; the
port's own replay determinism; and the launcher's ``--mode
simulate-fleet``."""

import dataclasses

import pytest

from repro.configs import get_config as jax_config
from repro.core import estimator as JE
from repro.core.profiler import run_profiling as jax_run_profiling
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.core.simulate import SimConfig as JSimConfig
from repro.resilience.faults import FaultPlan as JFaultPlan
from repro.resilience.faults import FaultSpec as JFaultSpec
from repro.serving.request import WORKLOAD_SLOS as JSLOS
from repro.serving.tenancy import generate_fleet_interactions as jax_fleet
from repro.sim import ClusterConfig as JClusterConfig
from repro.sim import ClusterSimulator as JClusterSimulator
from repro.sim import attainment_curve as jax_attainment_curve
from repro.sim import capacity_search as jax_capacity_search
from repro.sim import tail_point as jax_tail_point
from repro_torch.configs import get_config
from repro_torch.core import estimator as TE
from repro_torch.core.profiler import run_profiling
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.simulate import SimConfig
from repro_torch.launch import serve
from repro_torch.resilience.faults import FaultPlan, FaultSpec
from repro_torch.serving.request import WORKLOAD_SLOS, Phase
from repro_torch.serving.tenancy import generate_fleet_interactions
from repro_torch.sim import (ROUTERS, ClusterConfig, ClusterSimulator,
                             attainment_curve, capacity_search, tail_point)

ARCH = "llama3.1-8b"
#: tests/test_cluster.py's outage: replica 1 down for [1, 4) trace seconds
OUTAGE = dict(kind="dispatch", target="any", blocks=1, start=1, end=4)


class Side:
    """One package's fleet stack, fitted as tests/test_cluster.py fits it,
    on the spec fields of the JAX HardwareSpec(n_chips=2)."""

    def __init__(self, port: bool):
        fields = dataclasses.asdict(JE.HardwareSpec(n_chips=2))
        if port:
            E, prof, self.cfg = TE, run_profiling, get_config(ARCH)
            (self.Sched, self.Sim, self.CC, self.CS, self.Plan, self.Spec,
             self.fleet, self.slo) = (
                SchedulerConfig, SimConfig, ClusterConfig, ClusterSimulator,
                FaultPlan, FaultSpec, generate_fleet_interactions,
                WORKLOAD_SLOS["sharegpt"])
        else:
            E, prof, self.cfg = JE, jax_run_profiling, jax_config(ARCH)
            (self.Sched, self.Sim, self.CC, self.CS, self.Plan, self.Spec,
             self.fleet, self.slo) = (
                JSchedulerConfig, JSimConfig, JClusterConfig,
                JClusterSimulator, JFaultPlan, JFaultSpec, jax_fleet,
                JSLOS["sharegpt"])
        self.hw = E.HardwareSpec(**fields)
        self.est = E.PerfEstimator(self.hw, E.fit_params(
            prof(self.cfg, self.hw, max_sl=4096, max_bs=32, max_cl=4096),
            self.cfg, self.hw, iters=25))

    def work(self, n, rate, seed):
        return self.fleet(n, rate, seed=seed)

    def run(self, work, *, n=2, router="round-robin", outage=False, seed=0):
        """tests/test_cluster.py's run_fleet: the fleet knobs of
        ``--mode simulate-fleet``."""
        sim = self.Sim(model=self.cfg, hw=self.hw, slo=self.slo,
                       scheduler=self.Sched(layer_group=8), sched_every=4,
                       refit_interval=512, sched_pending_cap=64)
        faults = self.Plan(specs=[self.Spec(**OUTAGE)]) if outage else None
        return self.CS(self.CC(sim=sim, n_replicas=n, router=router,
                               faults=faults, seed=seed),
                       self.est).run(work)


@pytest.fixture(scope="module")
def sides():
    return Side(True), Side(False)


def _signature(res):
    """tests/test_cluster.py's signature, with prefill start and phase."""
    return sorted((r.rid, r.arrival, r.prefill_start, r.first_token_time,
                   r.finish_time, r.generated, r.phase.name)
                  for r in res.requests)


def _outcome(res):
    return dict(signature=_signature(res), cycles=res.total_cycles,
                replicas=res.replica_stats, rerouted=res.rerouted,
                cancelled=res.cancelled_no_replica, row=res.metrics.row())


@pytest.mark.parametrize("outage", (False, True), ids=("clean", "outage"))
@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_cluster_equals_the_original(sides, router, outage):
    port, jax_side = sides
    got = _outcome(port.run(port.work(200, 60.0, 4), router=router,
                            outage=outage))
    want = _outcome(jax_side.run(jax_side.work(200, 60.0, 4), router=router,
                                 outage=outage))
    assert got == want
    assert len(got["signature"]) >= 200
    assert {sig[-1] for sig in got["signature"]} <= {"FINISHED",
                                                      "CANCELLED"}


def test_capacity_helpers_equal_the_originals(sides):
    """tail_point, attainment_curve and capacity_search over the same
    fleet runs: every point and the provisioning answer equal."""
    port, jax_side = sides
    out = []
    for side, tail, curve, search in (
            (port, tail_point, attainment_curve, capacity_search),
            (jax_side, jax_tail_point, jax_attainment_curve,
             jax_capacity_search)):
        work = side.work(300, 1500.0, 9)

        def run_at(n, side=side, work=work):
            return side.run(work, n=n, router="prefix-affinity",
                            seed=9).requests

        out.append((tail(run_at(2), side.slo),
                    curve(run_at, [1, 2, 3], side.slo),
                    search(run_at, side.slo, n_lo=1, n_hi=3)))
    assert out[0] == out[1]
    curve_pts = out[0][1]
    assert curve_pts[0]["attainment"] < 1.0    # one replica is overloaded
    assert out[0][2]["points"]


def test_same_seed_replays_identically(sides):
    """The port's event heap is deterministic: the same trace and seed
    give every per-request timestamp again; another seed does not."""
    port, _ = sides
    work = port.work(400, 60.0, 4)
    a = port.run(work, n=3, router="least-kv", seed=2)
    b = port.run(work, n=3, router="least-kv", seed=2)
    assert _signature(a) == _signature(b)
    assert a.total_cycles == b.total_cycles
    c = port.run(work, n=3, router="least-kv", seed=3)
    assert _signature(a) != _signature(c)


def test_replica_failure_reroutes_and_recovers(sides):
    """tests/test_cluster.py's outage recipe on the port: drained work is
    re-homed, nothing is lost, the survivor works more."""
    port, _ = sides
    res = port.run(port.work(400, 80.0, 11), outage=True)
    assert all(r.phase == Phase.FINISHED for r in res.requests)
    assert res.rerouted > 0 and res.cancelled_no_replica == 0
    assert res.replica_stats[0][0] > res.replica_stats[1][0]


def test_serve_fleet_mode_prints_the_tail_point(capsys):
    assert serve.main(["--mode", "simulate-fleet", "--sessions", "100",
                       "--replicas", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("spec: h100-sxm x1, 132 SMs a card")
    assert lines[1].startswith("fleet 2xllama3.1-8b router=prefix-affinity")
    tail = [ln for ln in lines if "attainment=" in ln]
    assert len(tail) == 1 and "slo_holds=" in tail[0]
    assert sum(ln.lstrip().startswith("replica ") for ln in lines) == 2
