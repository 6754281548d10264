"""Virtual-clock ``OnlineFrontend`` replay on the JAX engine and the port's,
on the CPU in fp32 with the JAX params bridged and the same HardwareSpec
fields in both estimators: identical ``ServingMetrics``, token streams,
cycle traces and request spans, fault-free and under a chaos plan that
walks the SLO guard's lattice fused→serial→dense and back, with
``check_invariants()`` after every cycle; and the port's serve launcher in
replay mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core.config import ControlConfig as JControlConfig
from repro.core.config import ServerConfig as JServerConfig
from repro.core.engine import BulletServer as JServer
from repro.core.estimator import HardwareSpec as JHardwareSpec
from repro.core.estimator import PerfEstimator as JPerfEstimator
from repro.core.profiler import SurrogateMachine as JSurrogate
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.models import init_params as jax_init_params
from repro.obs import Observability as JObservability
from repro.resilience import FaultInjector as JFaultInjector
from repro.resilience import FaultPlan as JFaultPlan
from repro.resilience import FaultSpec as JFaultSpec
from repro.resilience import GuardConfig as JGuardConfig
from repro.resilience import SLOGuard as JSLOGuard
from repro.serving import frontend as JF
from repro.serving.request import WORKLOAD_SLOS as JSLOS
from repro.serving.workload import generate_trace as jax_generate_trace
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.config import ControlConfig, ServerConfig
from repro_torch.core.engine import BulletServer
from repro_torch.core.estimator import HardwareSpec, PerfEstimator
from repro_torch.core.profiler import SurrogateMachine
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.launch import serve
from repro_torch.obs import Observability
from repro_torch.resilience import (FaultInjector, FaultPlan, FaultSpec,
                                    GuardConfig, SLOGuard)
from repro_torch.serving import frontend as TF
from repro_torch.serving.request import WORKLOAD_SLOS
from repro_torch.serving.workload import generate_trace

HW = dict(name="h100-sxm", n_chips=1, peak_flops=989e12, hbm_bw=3.35e12,
          ici_bw=450e9, units_per_chip=8, grid_slots=8)
#: two failed fused dispatches (fused→serial), then two failed serial
#: decode dispatches (paged→dense); a short cooldown probes back to the
#: paged pool and the fused path while requests are still in flight
CHAOS = [dict(kind="dispatch", start=2, end=40, target="fused", count=2),
         dict(kind="dispatch", start=8, end=60, target="decode", count=2)]
COOLDOWN = 10


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("qwen3-1.7b").reduced(n_layers=2)
    cfg = get_config("qwen3-1.7b").reduced(n_layers=2)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _trace(gen, vocab, n=8, seed=3):
    """tests/test_resilience.py's small trace: compressed arrivals so
    prefills overlap decodes, lengths cut to the reduced context."""
    trace = gen("sharegpt", rate_req_s=200.0, duration_s=10.0, seed=seed,
                max_requests=n)
    rng = np.random.default_rng(seed)
    prompts = {}
    for r in trace:
        r.arrival *= 0.01
        r.prompt_len = max(4, min(r.prompt_len, 16))
        r.output_len = max(2, min(r.output_len, 8))
        prompts[r.rid] = rng.integers(0, vocab, r.prompt_len, dtype=np.int32)
    return trace, prompts


def _replay(port: bool, model, chaos: bool, oracle: bool = False):
    """One replay on either engine, with tests/test_fused.py's scheduler
    settings (one prompt per prefill batch, no §3.3.3 decode pause) so
    later admissions' layer groups fuse with earlier requests' decode."""
    jcfg, cfg, jparams, params = model
    if port:
        mods = (BulletServer, ServerConfig, ControlConfig, SchedulerConfig,
                PerfEstimator, HardwareSpec, Observability, FaultInjector,
                FaultPlan, FaultSpec, GuardConfig, SLOGuard, TF,
                WORKLOAD_SLOS, generate_trace, SurrogateMachine)
    else:
        mods = (JServer, JServerConfig, JControlConfig, JSchedulerConfig,
                JPerfEstimator, JHardwareSpec, JObservability,
                JFaultInjector, JFaultPlan, JFaultSpec, JGuardConfig,
                JSLOGuard, JF, JSLOS, jax_generate_trace, JSurrogate)
    (Server, Config, Control, Sched, Est, HWSpec, Obs, Inj, Plan, Spec,
     GCfg, Guard, F, slos, gen, Surrogate) = mods
    faults = guard = None
    if chaos:
        faults = Inj(Plan(specs=[Spec(**s) for s in CHAOS], seed=5))
        guard = Guard(GCfg(cooldown_cycles=COOLDOWN))
    est = Est(HWSpec(**HW))
    kw = dict(device="cpu") if port else {}
    server = Server(jcfg if not port else cfg, params if port else jparams,
                    config=Config(slo=slos["sharegpt"], est=est, max_slots=4,
                                  max_len=48, max_prefill_batch=1,
                                  control=Control(sched=Sched(
                                      max_decode_pause_cycles=0)),
                                  obs=Obs(), faults=faults, guard=guard),
                    **kw)
    cost = (F.oracle_cycle_cost(Surrogate(est.hw, seed=0)) if oracle
            else F.estimator_cycle_cost)
    fe = F.OnlineFrontend(server, F.VirtualClock(cycle_dt=1e-3),
                          cycle_cost=cost,
                          on_cycle=lambda s, t: s.check_invariants())
    trace, prompts = _trace(gen, cfg.vocab_size)
    for r in trace:
        fe.submit(r, prompts[r.rid])
    m = fe.run()
    return server, fe, m


def _summary(server, fe, m):
    obs = server.obs
    return dict(
        metrics=dataclasses.astuple(m),
        outputs=dict(server.outputs),
        stats={k: v for k, v in vars(server.stats).items()
               if k in {f.name for f in dataclasses.fields(server.stats)}},
        cycles=[(e.t, e.kind, e.predicted_s, e.actual_s, e.prefill_tokens,
                 e.decode_batch, e.config_id, e.kv_used_blocks, e.reason)
                for e in obs.trace],
        spans=[(s.rid, [(ev.name, ev.t, ev.attrs) for ev in s.events])
               for s in obs.spans.all()],
        transitions=([(t["cycle"], t["transition"], t["t"])
                      for t in server.guard.transitions]
                     if server.guard is not None else []),
        pred_actual=list(server.pred_actual),
        truncated=fe.truncated)


def _compare(jax_run, port_run):
    j, t = _summary(*jax_run), _summary(*port_run)
    shared = set(t["stats"]) & set(j["stats"])
    assert set(t["stats"]) <= set(j["stats"])
    assert {k: t["stats"][k] for k in shared} == \
        {k: j["stats"][k] for k in shared}
    for key in ("metrics", "outputs", "transitions", "cycles", "spans",
                "pred_actual", "truncated"):
        assert t[key] == j[key], key
    return t


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "chaos"])
def test_replay_matches_jax(model, chaos):
    port = _replay(True, model, chaos)
    t = _compare(_replay(False, model, chaos), port)
    server = port[0]
    assert t["metrics"][0] == 8 and not t["truncated"]
    assert server.pool.available_blocks == server.pool.n_blocks
    if chaos:
        kinds = [k for _, k, _ in t["transitions"]]
        assert kinds[:2] == ["degrade:fused", "degrade:paged"], kinds
        assert "restore:paged" in kinds and "restore:fused" in kinds
        assert server.guard.recovered and server.paged and server.fused
        assert server.stats.dispatch_failures == 4
        assert server.stats.fused_cycles > 0
        # the chaos run's streams are the fault-free run's
        clean = _replay(True, model, False)[0]
        assert server.outputs == clean.outputs


def test_oracle_replay_refits_like_jax(model):
    """The surrogate machine's timings (oracle_cycle_cost, core/profiler.py)
    drive the refit loop identically on both engines."""
    t = _compare(_replay(False, model, False, oracle=True),
                 _replay(True, model, False, oracle=True))
    assert any(abs(p - a) > 1e-12 for _, p, a in t["pred_actual"])


def test_submit_interactions_waits_for_tenancy(model):
    """Multi-turn sessions, which waited for the tenancy slice, replay:
    each follow-up turn's prompt is its session's previous prompt, the
    answer the engine gave, and fresh tokens."""
    from repro_torch.serving.workload import generate_interactions
    _, cfg, _, params = model
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=WORKLOAD_SLOS["sharegpt"]), device="cpu")
    fe = TF.OnlineFrontend(server, TF.VirtualClock())
    fe.submit_interactions(generate_interactions(
        2, rate_s=100.0, turns=2, new_tokens=6, output_tokens=3, seed=1),
        cfg.vocab_size, seed=1)
    m = fe.run()
    assert m.n_requests == 4 and not fe.truncated
    for r in fe.requests:
        if r.turn_index:
            prev = next(p for p in fe.requests if p.session_id ==
                        r.session_id and p.turn_index == r.turn_index - 1)
            hist = np.concatenate([prev._prompt, server.outputs[prev.rid]])
            assert len(r._prompt) > len(hist)
            np.testing.assert_array_equal(r._prompt[:len(hist)], hist)


def test_serve_replay_on_cpu(capsys, tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text(FaultPlan(specs=[FaultSpec(**s) for s in CHAOS],
                              seed=5).to_json())
    assert serve.main(["--mode", "replay", "--device", "cpu",
                       "--requests", "4", "--rate", "8", "--duration", "5",
                       "--fault-plan", str(plan),
                       "--metrics-out", str(tmp_path / "m.prom"),
                       "--trace-out", str(tmp_path / "t.json")]) == 0
    out = capsys.readouterr().out
    assert "replay(virtual) sharegpt" in out
    assert "n=4 ttft=" in out and "goodput=" in out
    assert "KV pool clean: True" in out
    assert "bullet_engine_decode_iterations_total" in \
        (tmp_path / "m.prom").read_text()


def test_serve_model_runs_the_built_kernels():
    """The launcher's model on the default ``cuda`` device reaches the CUDA
    kernels, which are built for one head dim: its reduced variant must
    keep that head dim (the plain ``reduced()`` one, D=32, is refused by
    every kernel wrapper)."""
    from repro_torch.kernels import build
    for arch in ("qwen3-1.7b", "llama3.1-8b"):
        cfg = serve.model_config(arch)
        assert cfg.head_dim in build.HEAD_DIMS
        assert cfg.n_layers < 28 and cfg.d_model <= 256
