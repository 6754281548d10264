"""The port's serving simulator (``core/simulate.py``) against the JAX
package's on the CPU: for every system, the same per-request timestamps,
predicted/actual cycle pairs, timeline and metrics row, bit for bit, when
both are priced with the same ``HardwareSpec`` fields and fitted alike,
on the JAX test's spec and on the H100's (132 SMs, a 67-entry table);
``tests/test_simulator.py``'s structural recipes on the port's side on
the H100 spec; the port's ``cross_validate`` against its own engine, and
equal to the JAX one; and the launcher's ``--mode sim``, also for
``mixtral-8x22b``, whose rows equal the JAX launcher's."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.replay_vs_sim import cross_validate as jax_cross_validate
from repro.configs import get_config as jax_config
from repro.core import estimator as JE
from repro.core.profiler import SurrogateMachine as JSurrogate
from repro.core.profiler import run_profiling as jax_run_profiling
from repro.core.simulate import ServingSimulator as JSimulator
from repro.core.simulate import SimConfig as JSimConfig
from repro.launch import serve as jax_serve
from repro.models import init_params as jax_init_params
from repro.serving.request import WORKLOAD_SLOS as JSLOS
from repro.serving.workload import fit_trace_to_context as jax_fit_trace
from repro.serving.workload import generate_trace as jax_generate_trace
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import estimator as TE
from repro_torch.core.profiler import SurrogateMachine, run_profiling
from repro_torch.core.simulate import ServingSimulator, SimConfig
from repro_torch.launch import serve
from repro_torch.serving.request import WORKLOAD_SLOS, Phase
from repro_torch.serving.workload import fit_trace_to_context, generate_trace
from repro_torch.sim.replay_vs_sim import CYCLE_TOL, cross_validate

ARCH = "llama3.1-8b"
#: the H100's field values (the port's HardwareSpec() without a card)
H100 = dict(name="h100-sxm", n_chips=1, peak_flops=989e12, hbm_bw=3.35e12,
            ici_bw=450e9, units_per_chip=132, grid_slots=132)
#: the paper's comparison as chip_smoke.py's sim phase runs it, with
#: bullet-fix8 beside bullet-fix66 (a static split on either table)
SYSTEMS = ("bullet", "chunked-1024", "chunked-2048", "nanoflow-1024",
           "naive", "bullet-fix66", "bullet-nosched", "bullet-nopart",
           "bullet-fix8")


def _fit(side, cfg, hw, *, iters, **sweep):
    """An estimator fitted as tests/test_simulator.py fits it."""
    E, prof = (TE, run_profiling) if side == "port" else (JE,
                                                         jax_run_profiling)
    return E.PerfEstimator(hw, E.fit_params(prof(cfg, hw, **sweep), cfg, hw,
                                            iters=iters))


def _pair(hw_fields):
    """(JAX spec, port spec, JAX estimator, port estimator) for
    llama3.1-8b on the same spec fields."""
    jhw = JE.HardwareSpec(**hw_fields)
    hw = TE.HardwareSpec(**hw_fields)
    sweep = dict(max_sl=4096, max_bs=32, max_cl=4096)
    jest = _fit("jax", jax_config(ARCH), jhw, iters=25, **sweep)
    est = _fit("port", get_config(ARCH), hw, iters=25, **sweep)
    return jhw, hw, jest, est


@pytest.fixture(scope="module")
def v5e():
    """tests/test_simulator.py's spec, HardwareSpec(n_chips=2)."""
    return _pair(dataclasses.asdict(JE.HardwareSpec(n_chips=2)))


@pytest.fixture(scope="module")
def h100():
    return _pair(H100)


def _run(port: bool, pair, system, trace_args, **run_kw):
    jhw, hw, jest, est = pair
    if port:
        cfg, spec, e, gen = get_config(ARCH), hw, est, generate_trace
        sim = ServingSimulator(SimConfig(model=cfg, hw=spec,
                                         slo=WORKLOAD_SLOS["sharegpt"]),
                               e, SurrogateMachine(spec, seed=7), system)
    else:
        cfg, spec, e, gen = jax_config(ARCH), jhw, jest, jax_generate_trace
        sim = JSimulator(JSimConfig(model=cfg, hw=spec,
                                    slo=JSLOS["sharegpt"]),
                         e, JSurrogate(spec, seed=7), system)
    trace = gen("sharegpt", *trace_args, seed=3)
    m = sim.run(trace, **run_kw)
    return m, trace, sim


def _outcome(m, trace, sim):
    rep = sim.replica
    return dict(
        requests=[(r.rid, r.arrival, r.prefill_start, r.first_token_time,
                   r.finish_time, r.generated) for r in trace],
        pred_actual=list(sim.pred_actual),
        log=[dataclasses.astuple(e) for e in sim.log],
        refits=None if rep is None else (rep.refits_applied, rep.refit_log),
        table=None if rep is None else [p.key for p in rep.rm.partitions],
        row=m.row())


def test_fitted_params_equal_the_originals(v5e, h100):
    for _, _, jest, est in (v5e, h100):
        assert dataclasses.asdict(est.params) == \
            dataclasses.asdict(jest.params)


@pytest.mark.parametrize("system", SYSTEMS)
def test_simulator_equals_the_original(v5e, system):
    """Every system on tests/test_simulator.py's spec and trace shape:
    per-request timestamps, (kind, predicted, actual) cycles, timeline,
    refits and metrics identical."""
    got = _outcome(*_run(True, v5e, system, (30.0, 6.0), log_timeline=True))
    want = _outcome(*_run(False, v5e, system, (30.0, 6.0),
                          log_timeline=True))
    assert got == want
    assert len(got["requests"]) > 100


@pytest.mark.parametrize("system", ("bullet", "bullet-fix66",
                                    "bullet-nopart", "chunked-1024"))
def test_simulator_equals_the_original_on_h100_fields(h100, system):
    """The H100's 132 SMs: the 67-entry table the port's engine builds,
    and the same outcome as the JAX simulator on those fields."""
    got = _outcome(*_run(True, h100, system, (30.0, 1.5),
                         log_timeline=True))
    want = _outcome(*_run(False, h100, system, (30.0, 1.5),
                          log_timeline=True))
    assert got == want
    if system.startswith("bullet-fix") or system == "bullet":
        assert len(got["table"]) == 67


# --- tests/test_simulator.py's structural recipes, port side, H100 -------

#: (req/s, seconds) of the structural recipes' trace. One H100 prices a
#: cycle 2.5-4x cheaper than the JAX test's two v5e chips, so its rates
#: (30-50 req/s) leave Bullet on the prefill-exclusive / decode-only
#: extremes with no fused cycle; intermediate splits and fused cycles
#: appear from about 200 req/s (180 requests in 0.5 s here, 83% goodput)
H100_LOAD = (400.0, 0.5)


@pytest.fixture(scope="module")
def bullet_h100(h100):
    """One Bullet run on the H100 spec, timeline logged, that the
    structural recipes read."""
    return _run(True, h100, "bullet", H100_LOAD, log_timeline=True)


@pytest.mark.parametrize("system", ("chunked-1024", "bullet-fix66", "naive",
                                    "bullet"))
def test_all_requests_complete(h100, bullet_h100, system):
    m, trace, _ = (bullet_h100 if system == "bullet"
                   else _run(True, h100, system, H100_LOAD))
    assert all(r.phase == Phase.FINISHED for r in trace), system
    assert m.n_requests == len(trace)
    assert m.throughput_tok_s > 0


def test_request_timestamps_consistent(bullet_h100):
    _, trace, _ = bullet_h100
    for r in trace:
        assert r.prefill_start >= r.arrival - 1e-9
        assert r.first_token_time >= r.prefill_start
        assert r.finish_time >= r.first_token_time
        assert r.generated == r.output_len


def test_timeline_log_records_dynamic_partitions(bullet_h100):
    """Fig. 12 on the H100 table: intermediate SM splits, not only the
    prefill-exclusive / decode-only extremes, and fused cycles."""
    _, _, s = bullet_h100
    assert len({e.prefill_units for e in s.log}) > 2
    assert "fused" in {k for k, _, _ in s.pred_actual}


def test_estimator_slo_classification_accuracy(bullet_h100):
    """Fig. 15: predicted against surrogate-truth cycle durations."""
    _, _, s = bullet_h100
    pairs = s.pred_actual
    assert len(pairs) > 100
    rel = [abs(p / a - 1.0) for _, p, a in pairs if a > 0]
    assert sum(rel) / len(rel) < 0.35
    for thresh in (0.005, 0.02):
        agree = sum((p <= thresh) == (a <= thresh) for _, p, a in pairs)
        assert agree / len(pairs) > 0.8


# --- replay against sim -----------------------------------------------

@pytest.mark.parametrize("head_dim,n_requests,duration", (
    (32, 10, 4.0), (128, 16, 5.0)), ids=("jax-recipe", "smoke-recipe"))
def test_cross_validate_against_the_port_engine(head_dim, n_requests,
                                                duration):
    """tests/test_simulator.py's cross-validation recipe on the H100 spec:
    the port's simulator and the port's engine (plain versions on the
    CPU, the JAX params bridged) schedule from one table and both meet
    every SLO; cycle counts, mean cycles and gap equal the JAX
    cross_validate's on the same spec values. At the JAX recipe's head dim
    the two agree within CYCLE_TOL. chip_smoke.py runs the recipe at the
    head dim its kernels are built for (128) and 16 requests, where the
    JAX package's own gap is 23.7%: the engine prices each decode on the
    page-bucketed contexts it streamed, the simulator on the mean context
    (ROADMAP §3)."""
    jcfg = jax_config("qwen3-1.7b").reduced(head_dim=head_dim)
    cfg = get_config("qwen3-1.7b").reduced(head_dim=head_dim)
    jhw, hw = JE.HardwareSpec(**H100), TE.HardwareSpec()
    assert dataclasses.asdict(hw) == H100
    sweep = dict(max_sl=2048, max_bs=16, max_cl=2048)
    jest = _fit("jax", jcfg, jhw, iters=20, **sweep)
    est = _fit("port", cfg, hw, iters=20, **sweep)
    trace_args = ("sharegpt", 8.0, duration)
    jtrace = jax_fit_trace(jax_generate_trace(
        *trace_args, seed=1, max_requests=n_requests), 64)
    trace = fit_trace_to_context(generate_trace(
        *trace_args, seed=1, max_requests=n_requests), 64)
    assert len(trace) == n_requests
    params = params_from_jax(jax.tree.map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0),
                                    jnp.float32)), device="cpu")
    r = cross_validate(cfg, est, trace, params=params, device="cpu",
                       max_len=64)
    if head_dim == 32:
        assert r["cycle_gap"] <= CYCLE_TOL, r["cycle_gap"]
    assert r["m_sim"].goodput == r["m_replay"].goodput == 1.0
    assert len(r["table"]) == 67
    assert r["server"].scheduler.split_candidates == [
        (p.prefill_units, p.decode_units) for p in r["server"].rm.tile_entries]
    j = jax_cross_validate(jcfg, jest, jtrace, max_len=64)
    for key in ("mean_cycle_sim_s", "mean_cycle_eng_s", "n_cycles_sim",
                "n_cycles_eng", "cycle_gap", "table"):
        assert r[key] == j[key], key
    assert r["m_replay"].row() == j["m_replay"].row()


def test_cross_validate_raises_on_table_drift(monkeypatch):
    """A simulator that re-quantizes its own table is refused."""
    from repro_torch.core import simulate
    cfg = get_config("qwen3-1.7b").reduced(n_layers=2)
    hw = TE.HardwareSpec()
    real = simulate.ResourceManager

    def coarse(spec, quantum, **kw):
        return real(spec, quantum * 2, **kw)

    monkeypatch.setattr(simulate, "ResourceManager", coarse)
    jcfg = jax_config("qwen3-1.7b").reduced(n_layers=2)
    params = params_from_jax(jax.tree.map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0),
                                    jnp.float32)), device="cpu")
    trace = fit_trace_to_context(generate_trace("sharegpt", 8.0, 1.0, seed=1,
                                                max_requests=2), 32)
    with pytest.raises(RuntimeError, match="partition-table drift"):
        cross_validate(cfg, TE.PerfEstimator(hw), trace, params=params,
                       device="cpu", max_len=32)


# --- the launcher -------------------------------------------------------

def test_serve_sim_mode_prints_the_spec_and_a_row_per_system(capsys):
    assert serve.main(["--mode", "sim", "--systems", "bullet,chunked-1024",
                       "--rate", "20", "--duration", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("spec: h100-sxm x1, 132 SMs a card")
    rows = [ln for ln in lines if "goodput=" in ln]
    assert [ln.split()[0] for ln in rows] == ["bullet", "chunked-1024"]


def test_serve_sim_mixtral_equals_the_jax_rows(capsys, monkeypatch):
    """``--mode sim --arch mixtral-8x22b``: the port's rows are the JAX
    simulator's, bit for bit, when the JAX launcher prices with the same
    H100 fields the port's does without a card (on one card: the JAX
    launcher defaults to two)."""
    argv = ["--mode", "sim", "--arch", "mixtral-8x22b", "--systems",
            "bullet,chunked-1024", "--rate", "20", "--duration", "2",
            "--chips", "1"]
    assert serve.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("spec: h100-sxm x1, 132 SMs a card")
    ours = [ln for ln in lines if "goodput=" in ln]
    h100 = dataclasses.asdict(TE.HardwareSpec())
    spec = JE.HardwareSpec
    monkeypatch.setattr(JE, "HardwareSpec",
                        lambda n_chips: spec(**{**h100, "n_chips": n_chips}))
    monkeypatch.setattr(sys, "argv", ["serve.py"] + argv)
    jax_serve.main()
    theirs = [ln for ln in capsys.readouterr().out.splitlines()
              if "goodput=" in ln]
    assert [ln.split()[0] for ln in ours] == ["bullet", "chunked-1024"]
    assert ours == theirs
