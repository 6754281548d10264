"""Chip granularity of the port (§3.4 second granularity) against the JAX
package, on the CPU.

The control plane: tests/test_submesh.py's single-device recipes on the
port's copies (table keying, ``nearest`` within a granularity, the handoff
charge, the chip cycle time, ``predict_cycle``'s chip kind, the combined
argmin both ways), each number also held equal to the JAX package's. The
carving over groups of 2, 4 and 8 entries; ``transfer_pages`` against a
plain gather and scatter and against the JAX one. The engine: the port's
chip engine over ``("cpu",) * n`` on tests/test_submesh.py's,
tests/test_resilience.py's and tests/test_system.py's chip recipes, its
token streams held equal to the JAX fused (or serial) engine's in this
process and, with its chip cycles, handoffs, fused cycles, retries and
aborts, to the JAX chip engine's, which needs several devices and runs in
a process of its own over 8 virtual CPU devices (``chip_recipes.py``,
started when the module's first test starts, about 60 s).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_recipes as R
from repro.configs import get_config as jax_config
from repro.core import metadata as JM
from repro.core.config import CacheConfig as JCacheConfig
from repro.core.config import ExecConfig as JExecConfig
from repro.core.config import ServerConfig as JServerConfig
from repro.core.config import ControlConfig as JControlConfig
from repro.core.engine import BulletServer as JServer
from repro.core.estimator import EstimatorParams as JEstimatorParams
from repro.core.estimator import HardwareSpec as JHardwareSpec
from repro.core.estimator import PerfEstimator as JPerfEstimator
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.core.scheduler import SLOScheduler as JScheduler
from repro.core.resource import ResourceManager as JResourceManager
from repro.kvcache.paged import transfer_pages as jax_transfer_pages
from repro.models import init_params as jax_init_params
from repro.serving.frontend import OnlineFrontend as JFrontend
from repro.serving.frontend import VirtualClock as JClock
from repro.serving.request import Phase as JPhase
from repro.serving.request import Request as JRequest
from repro.serving.request import SLO as JSLO
from repro.serving.tenancy import generate_tenant_interactions as j_gen
from repro.serving.tenancy import make_apps as j_apps
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import analytics as A
from repro_torch.core.config import (CacheConfig, ControlConfig, ExecConfig,
                                    ServerConfig)
from repro_torch.core.engine import BulletServer, ChipExecutable
from repro_torch.core.estimator import (CycleObservation, EstimatorParams,
                                        HardwareSpec, PerfEstimator,
                                        predict_cycle)
from repro_torch.core import metadata as M
from repro_torch.core.metadata import ResourceStatus
from repro_torch.core.resource import ResourceManager
from repro_torch.core.scheduler import SchedulerConfig, SLOScheduler
from repro_torch.kvcache.paged import transfer_pages
from repro_torch.launch import serve
from repro_torch.launch.submesh import carve_submeshes, find_split
from repro_torch.models.sharding import (submesh_cache_sharding,
                                         submesh_param_sharding)
from repro_torch.resilience import (FaultInjector, FaultPlan, FaultSpec,
                                    GuardConfig, HandoffError, SLOGuard)
from repro_torch.serving.frontend import (OnlineFrontend, VirtualClock,
                                          estimator_cycle_cost)
from repro_torch.serving.request import SLO, Phase, Request
from repro_torch.serving.tenancy import generate_tenant_interactions, make_apps

#: the JAX package's default spec (4 chips x 8 units), on which
#: tests/test_submesh.py's control-plane recipes are stated
HW4 = dict(R.HW, n_chips=4)


def _est(regime=None, n_chips=4):
    return PerfEstimator(HardwareSpec(**R.hw_fields(n_chips, regime)),
                         EstimatorParams(**R.param_fields(regime)))


def _jest(regime=None, n_chips=4):
    return JPerfEstimator(JHardwareSpec(**R.hw_fields(n_chips, regime)),
                          JEstimatorParams(**R.param_fields(regime)))


# ---------------------------------------------------------------------------
# the JAX chip engine, in a process of its own over 8 virtual CPU devices
# ---------------------------------------------------------------------------

_RECIPES = {}


@pytest.fixture(scope="module", autouse=True)
def _jax_chip_processes():
    """Start the JAX chip engine's recipe groups as the module starts, one
    process each, so they run while the tests before the comparisons do."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    script = os.path.join(os.path.dirname(__file__), "chip_recipes.py")
    procs = {group: subprocess.Popen(
        [sys.executable, script, group], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for group in R.GROUPS}
    _RECIPES.update(procs=procs, res={})
    yield
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def jax_chip(name: str) -> dict:
    """The JAX chip engine's result of recipe ``name``."""
    group = next(g for g, names in R.GROUPS.items() if name in names)
    res = _RECIPES["res"]
    if group not in res:
        out, err = _RECIPES["procs"][group].communicate(timeout=900)
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("CHIP_RECIPES_JSON ")]
        assert lines, (out[-2000:], err[-3000:])
        res[group] = json.loads(lines[-1].split(" ", 1)[1])
    return res[group][name]


# ---------------------------------------------------------------------------
# the control plane (tests/test_submesh.py's single-device half)
# ---------------------------------------------------------------------------

def mixed_state(n_tokens=2048, n_d=8, ctx=512, mod=M):
    """A system state with a prefill and ``n_d`` decodes resident, in the
    metadata types of ``mod`` (the port's, or the JAX package's)."""
    s = mod.SystemState()
    s.prefill = mod.PrefillStatus(active_rid=0, layers_done=0,
                                  total_layers=28, n_tokens=n_tokens)
    s.decode = mod.DecodeStatus(batch=list(range(n_d)), mean_context=ctx,
                                ctx_tokens=ctx * n_d)
    return s


def mk_scheduler(est, chip_splits=((1, 3), (2, 2), (3, 1)), jax_side=False):
    if jax_side:
        cfg = jax_config("qwen3-1.7b")
        rm = JResourceManager(est.hw, 2, chip_splits=list(chip_splits))
        sched = JScheduler(cfg, est, JSLO(3.0, 150.0), JSchedulerConfig())
    else:
        cfg = get_config("qwen3-1.7b")
        rm = ResourceManager(est.hw, 2, chip_splits=list(chip_splits))
        sched = SLOScheduler(cfg, est, SLO(3.0, 150.0), SchedulerConfig())
    sched.split_candidates = [(p.prefill_units, p.decode_units)
                              for p in rm.tile_entries]
    sched.partition_table = rm.partitions
    return sched, rm


def test_chip_and_tile_entries_with_same_units_stay_distinct():
    """A 2+2-chip split of a 4-chip group projects to (16, 16) units, the
    same unit split as a tile entry: the descriptor key keeps both."""
    rm = ResourceManager(HardwareSpec(**HW4), 2,
                         chip_splits=[(1, 3), (2, 2), (3, 1)])
    tile_status = ResourceStatus(16, 16)
    chip_status = ResourceStatus(16, 16, granularity="chip",
                                 prefill_chips=2, decode_chips=2)
    assert rm.on_table(tile_status) and rm.on_table(chip_status)
    tile_part = rm.nearest(tile_status)
    chip_part = rm.nearest(chip_status)
    assert tile_part.config_id != chip_part.config_id
    assert tile_part.granularity == "tile" and tile_part.prefill_chips == 0
    assert chip_part.granularity == "chip" and chip_part.prefill_chips == 2
    assert (tile_part.prefill_units, tile_part.decode_units) == \
        (chip_part.prefill_units, chip_part.decode_units) == (16, 16)


def test_chip_nearest_snaps_within_granularity():
    rm = ResourceManager(HardwareSpec(**HW4), 2,
                         chip_splits=[(1, 3), (2, 2), (3, 1)])
    got = rm.nearest(ResourceStatus(30, 2, granularity="chip",
                                    prefill_chips=4, decode_chips=0))
    assert got.granularity == "chip" and got.prefill_chips == 3
    assert rm.nearest(ResourceStatus(17, 15)).granularity == "tile"
    part = rm.switch(ResourceStatus(8, 24, granularity="chip",
                                    prefill_chips=1, decode_chips=3))
    assert rm.current is part and part.granularity == "chip"


def test_descriptor_keys_unique_and_equal_to_jax():
    splits = [(1, 3), (2, 2), (3, 1)]
    rm = ResourceManager(HardwareSpec(**HW4), 2, chip_splits=splits)
    keys = [p.key for p in rm.partitions]
    assert len(keys) == len(set(keys))
    assert len(rm.chip_entries) == 3
    assert rm.partitions == rm.tile_entries + rm.chip_entries
    jrm = JResourceManager(JHardwareSpec(**HW4), 2, chip_splits=splits)
    assert keys == [p.key for p in jrm.partitions]


def test_kv_handoff_time_is_bytes_over_ici_bw():
    cfg = get_config("qwen3-1.7b")
    est = PerfEstimator(HardwareSpec(**dict(HW4, ici_bw=50e9)))
    jest = JPerfEstimator(JHardwareSpec(**dict(HW4, ici_bw=50e9)))
    n = 4096
    want = A.kv_transfer_bytes(cfg, n) / 50e9
    assert est.kv_handoff_time(cfg, n) == pytest.approx(want)
    assert est.kv_handoff_time(cfg, 0) == 0.0
    assert est.kv_handoff_time(cfg, 2 * n) == pytest.approx(2 * want)
    assert est.kv_handoff_time(cfg, n) == pytest.approx(
        jest.kv_handoff_time(jax_config("qwen3-1.7b"), n), rel=1e-12)


def test_chip_cycle_time_is_uncontended_max_plus_handoff():
    cfg = get_config("qwen3-1.7b")
    est = _est()
    U = est.hw.total_units
    n_tok, batch, ctx = 4096, 16, 1024
    lg = len(cfg.pattern)
    t_p = est.prefill_layer_time(cfg, n_tok, 0, U // 2, colocated=False) * lg
    t_d = est.decode_iter_time(cfg, batch, ctx, U // 2, colocated=False)
    base = est.chip_cycle_time(cfg, n_tok, U // 2, U // 2, batch, ctx)
    assert base == pytest.approx(max(t_p, t_d))
    with_handoff = est.chip_cycle_time(cfg, n_tok, U // 2, U // 2, batch,
                                       ctx, handoff_tokens=n_tok)
    assert with_handoff == pytest.approx(
        max(t_p, t_d) + est.kv_handoff_time(cfg, n_tok))
    assert est.chip_cycle_time(cfg, n_tok, U // 2, U // 2, 0, 1) == \
        pytest.approx(t_p)
    assert with_handoff == pytest.approx(_jest().chip_cycle_time(
        jax_config("qwen3-1.7b"), n_tok, U // 2, U // 2, batch, ctx,
        handoff_tokens=n_tok), rel=1e-12)


def test_predict_cycle_routes_chip_kind():
    cfg = get_config("qwen3-1.7b")
    est = _est()
    obs = CycleObservation("chip", 1024, 16, 16, 4, 256,
                           handoff_tokens=1024)
    assert predict_cycle(est, cfg, obs) == pytest.approx(
        est.chip_cycle_time(cfg, 1024, 16, 16, 4, 256,
                            handoff_tokens=1024))
    free = CycleObservation("chip", 1024, 16, 16, 4, 256)
    assert predict_cycle(est, cfg, obs) > predict_cycle(est, cfg, free)


@pytest.mark.parametrize("regime,want", [("cheap", "chip"),
                                         ("dear", "tile")])
def test_argmin_selects_chip_iff_handoff_beats_contention(regime, want):
    """Chip wins exactly when the modeled handoff undercuts the modeled
    co-location contention, as the JAX scheduler decides."""
    state = mixed_state()
    sched, _ = mk_scheduler(_est(regime))
    gran, ms = sched.combined_argmin(state)
    assert gran == want
    assert sched.preferred_granularity(state) == want
    total = sched.est.hw.total_units
    _, chip_ms = sched._chip_split_search(state, float("inf"))
    tile_ms = min(sched._fused_cycle_ms(state, u, v)
                  for u, v in sched._fused_candidates(total))
    assert (chip_ms < tile_ms) == (want == "chip")
    jsched, _ = mk_scheduler(_jest(regime), jax_side=True)
    jgran, jms = jsched.combined_argmin(mixed_state(mod=JM))
    assert (gran, ms) == (jgran, pytest.approx(jms, rel=1e-12))


def test_argmin_needs_both_phases_resident():
    sched, _ = mk_scheduler(_est("cheap"))
    assert sched.combined_argmin(mixed_state(n_d=0)) is None
    assert sched.combined_argmin(mixed_state(n_tokens=0)) is None
    assert sched.preferred_granularity(mixed_state(n_d=0)) == "tile"


@pytest.mark.parametrize("regime", ["cheap", "dear"])
def test_chip_schedule_decision_is_on_table_and_never_pauses(regime):
    sched, rm = mk_scheduler(_est(regime))
    d = sched.schedule(mixed_state(), 0.0, [], granularity="chip")
    assert d.resources.granularity == "chip"
    assert rm.on_table(d.resources)
    assert not d.pause_decode
    d = sched.schedule(mixed_state(n_d=0), 0.0, [], granularity="chip")
    assert d.resources.granularity == "chip"
    assert rm.on_table(d.resources)


def test_tile_schedule_unaffected_by_chip_table():
    sched, rm = mk_scheduler(_est("cheap"))
    d = sched.schedule(mixed_state(), 0.0, [])
    assert d.resources.granularity == "tile"
    assert rm.on_table(d.resources)


# ---------------------------------------------------------------------------
# carving and placements
# ---------------------------------------------------------------------------

def test_carve_single_device_yields_no_chip_table():
    assert carve_submeshes(["cpu"]) == []
    assert carve_submeshes(["cuda:0"]) == []


@pytest.mark.parametrize("n", [2, 4, 8])
def test_carve_submeshes_disjoint_and_covering(n):
    """Split k gives devices[:k] and devices[k:]: disjoint by position,
    covering the group, one split per interior point, also on a group
    that names one card more than once."""
    for group in (["cpu"] * n, [f"cuda:{i % 2}" for i in range(n)]):
        splits = carve_submeshes(group)
        assert len(splits) == n - 1
        for k, sp in enumerate(splits, start=1):
            assert sp.key == (k, n - k)
            assert len(sp.prefill_mesh) == k
            assert len(sp.decode_mesh) == n - k
            assert list(sp.prefill_mesh) + list(sp.decode_mesh) == \
                [torch.device(d) for d in group]
            assert repr(sp) == (f"SubMeshSplit(prefill_chips={k}, "
                                f"decode_chips={n - k})")
            assert submesh_param_sharding(sp.prefill_mesh) == \
                torch.device(group[0])
            assert submesh_cache_sharding(sp.decode_mesh) == \
                torch.device(group[k])
        assert find_split(splits, 1, n - 1) is splits[0]
        assert find_split(splits, n, 0) is None
    assert len(carve_submeshes(["cpu"] * n, min_chips=n // 2)) == 1
    assert [s.key for s in carve_submeshes(["cpu"] * n, quantum=2)] == \
        [(k, n - k) for k in range(1, n, 2)]


# ---------------------------------------------------------------------------
# transfer_pages
# ---------------------------------------------------------------------------

def _pools(seed, r=2, pages=9, ps=4, k=2, d=8, layers=2):
    rng = np.random.default_rng(seed)
    shape = (r, pages + 1, ps, k, d)
    src = [{n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")} for _ in range(layers)]
    dst = [{n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")} for _ in range(layers)]
    return src, dst


def _torch_pool(pool):
    return {"blocks": tuple({n: torch.from_numpy(a.copy())
                             for n, a in e.items()} for e in pool)}


@pytest.mark.parametrize("blocks", [[3], [0, 5, 2], list(range(9))])
def test_transfer_pages_matches_plain_gather_scatter_and_jax(blocks):
    src, dst = _pools(len(blocks))
    want = [{n: a.copy() for n, a in e.items()} for e in dst]
    for s_e, w_e in zip(src, want):
        for n in w_e:
            w_e[n][:, blocks] = s_e[n][:, blocks]
    s_t, d_t = _torch_pool(src), _torch_pool(dst)
    leaves = [t for e in d_t["blocks"] for t in e.values()]
    out = transfer_pages(s_t, d_t, blocks)
    assert out is d_t
    # written in place: the destination's tensors are the same objects
    assert [t for e in out["blocks"] for t in e.values()] == leaves
    got = jax_transfer_pages(
        {"blocks": tuple({n: jnp.asarray(a) for n, a in e.items()}
                         for e in src)},
        {"blocks": tuple({n: jnp.asarray(a) for n, a in e.items()}
                         for e in dst)}, blocks)
    for t_e, w_e, j_e in zip(out["blocks"], want, got["blocks"]):
        for n in w_e:
            np.testing.assert_array_equal(t_e[n].numpy(), w_e[n])
            np.testing.assert_array_equal(t_e[n].numpy(),
                                          np.asarray(j_e[n]))


def test_transfer_pages_fault_raises_before_any_write():
    src, dst = _pools(7)
    s_t, d_t = _torch_pool(src), _torch_pool(dst)
    calls = []

    def fault(n_blocks):
        calls.append(n_blocks)
        raise HandoffError("injected")
    with pytest.raises(HandoffError):
        transfer_pages(s_t, d_t, [1, 4], fault=fault)
    assert calls == [2]
    for t_e, d_e in zip(d_t["blocks"], dst):
        for n in d_e:
            np.testing.assert_array_equal(t_e[n].numpy(), d_e[n])
    # empty blocks: no-op, and the fault hook is not consulted
    assert transfer_pages(s_t, d_t, [], fault=fault) is d_t
    assert calls == [2]


# ---------------------------------------------------------------------------
# the engine over ("cpu",) * n against the JAX engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("qwen3-1.7b").reduced(n_layers=2)
    cfg = get_config("qwen3-1.7b").reduced(n_layers=2)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def chip_server(model, n=2, partition="chip", regime=None, **kw):
    """The port's server of the recipes over ``("cpu",) * n``."""
    _, cfg, _, params = model
    base = dict(R.SERVER, **kw)
    return BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=_est(regime, n),
        execution=ExecConfig(partition=partition, devices=("cpu",) * n),
        control=ControlConfig(sched=SchedulerConfig(
            max_decode_pause_cycles=0)), **base), device="cpu")


def jax_fused(model, n_req, seed):
    """The JAX single-mesh fused engine on a recipe batch, in this
    process."""
    jcfg, _, jparams, _ = model
    js = JServer(jcfg, jparams, config=JServerConfig(
        slo=JSLO(3.0, 150.0), est=_jest(n_chips=1),
        control=JControlConfig(
            sched=JSchedulerConfig(max_decode_pause_cycles=0)), **R.SERVER))
    for rid, prompt, olen in R.batch(jcfg.vocab_size, n_req, seed):
        js.submit(JRequest(rid=rid, arrival=0.0, prompt_len=len(prompt),
                           output_len=olen), prompt)
    js.run()
    return R.streams(js.outputs)


def run_batch(server, n_req, seed):
    for rid, prompt, olen in R.batch(server.cfg.vocab_size, n_req, seed):
        server.submit(Request(rid=rid, arrival=0.0, prompt_len=len(prompt),
                              output_len=olen), prompt)
    server.run()
    server.check_invariants()
    return R.summary(server)


@pytest.fixture(scope="module")
def fused_ref(model):
    return {seed: jax_fused(model, n, seed) for n, seed in ((6, 0), (6, 5),
                                                            (4, 3))}


@pytest.mark.parametrize("name", ["seed0", "seed5", "wide"])
def test_chip_engine_matches_single_mesh_fused_engine(model, fused_ref,
                                                      name):
    """Prefill on one side, the page handoff, decode on the other: token
    streams equal to the JAX single-mesh fused engine's, and streams and
    counters equal to the JAX chip engine's (8 virtual devices); the
    ``wide`` recipe walks the 7 splits of an 8-entry group."""
    n, partition, n_req, seed, regime = R.ENGINE[name]
    server = chip_server(model, n, partition, regime)
    assert server._chip_enabled
    assert len(server.rm.chip_entries) == n - 1
    got = run_batch(server, n_req, seed)
    assert got["outputs"] == fused_ref[seed]
    assert server.stats.chip_cycles > 0 and server.stats.handoffs == n_req
    assert server.stats.fused_cycles == 0                   # pinned chip
    assert server.pool.free_blocks == server.pool.n_blocks
    assert got == jax_chip(name)


@pytest.mark.parametrize("regime", ["cheap", "dear"])
def test_auto_partition_argmin_drives_execution(model, fused_ref, regime):
    """partition="auto": under punitive contention and a free
    interconnect co-resident tasks run chip-granular, in the opposite
    regime none does; both reproduce the single-mesh streams and the JAX
    chip engine's counters."""
    server = chip_server(model, 2, "auto", regime)
    got = run_batch(server, 6, 0)
    assert got["outputs"] == fused_ref[0]
    if regime == "cheap":
        assert server.stats.chip_cycles > 0
    else:
        assert server.stats.chip_cycles == 0
        assert server.stats.fused_cycles > 0
    assert got == jax_chip(f"auto_{regime}")


def test_chip_executables_prebuilt_and_reused(model):
    """Chip entries hold their execution states from construction;
    switching is a table lookup that never rebuilds them."""
    server = chip_server(model, 4)
    chip_execs = {cid: e for cid, e in server.rm._exec.items()
                  if isinstance(e, ChipExecutable)}
    assert len(chip_execs) == 3
    for part in server.rm.chip_entries:
        ex = server.rm.executable(part)
        assert isinstance(ex, ChipExecutable)
        assert ex.split.prefill_chips == part.prefill_chips
        assert ex.p_placement == ex.d_placement == torch.device("cpu")
        assert ex.p_stream is None and ex.d_stream is None
    tile = chip_server(model, 4, "tile")
    assert run_batch(server, 4, 1)["outputs"] == \
        run_batch(tile, 4, 1)["outputs"]
    assert all(server.rm._exec[cid] is e for cid, e in chip_execs.items())
    assert server.stats.chip_cycles > 0


def test_chip_cycles_observed_and_traced(model):
    """A chip cycle is a ``"chip"`` observation; the cycle that hands
    pages off carries the handoff tokens, and the cycle trace their
    bytes."""
    from repro_torch.obs import Observability
    _, cfg, _, params = model
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=_est(n_chips=2), obs=Observability(),
        execution=ExecConfig(partition="chip", devices=("cpu", "cpu")),
        **R.SERVER), device="cpu")
    for rid, prompt, olen in R.batch(cfg.vocab_size, 3, 2):
        server.submit(Request(rid=rid, arrival=0.0, prompt_len=len(prompt),
                              output_len=olen), prompt)
    kinds, handed = [], 0
    now = 0.0
    while not server.idle:
        server.step(now)
        obs = server.last_cycle_observation()
        kinds.append(obs.kind)
        if obs.kind == "chip" and obs.handoff_tokens:
            handed += obs.handoff_tokens
        now += 1e-3
    assert "chip" in kinds
    assert handed == sum(len(p) for _, p, _ in R.batch(cfg.vocab_size, 3, 2))
    traced = [e for e in server.obs.trace if e.handoff_tokens]
    assert traced and all(e.handoff_bytes == int(A.kv_transfer_bytes(
        cfg, e.handoff_tokens)) for e in traced)
    assert all(e.kind == "chip" for e in traced)


# ---------------------------------------------------------------------------
# the chip resilience recipes (tests/test_resilience.py) and the
# differential replay (tests/test_system.py)
# ---------------------------------------------------------------------------

def chip_replay(model, name):
    _, cfg, _, params = model
    plan = R.REPLAY[name]
    faults = guard = None
    if plan is not None:
        specs, cooldown = plan
        faults = FaultInjector(FaultPlan(
            specs=[FaultSpec(**sp) for sp in specs], seed=1))
        guard = SLOGuard(GuardConfig(cooldown_cycles=cooldown))
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=_est(n_chips=2), faults=faults, guard=guard,
        execution=ExecConfig(partition="chip", devices=("cpu", "cpu")),
        control=ControlConfig(sched=SchedulerConfig(
            max_decode_pause_cycles=0)), **R.SERVER), device="cpu")
    fe = OnlineFrontend(server, VirtualClock(),
                        cycle_cost=estimator_cycle_cost,
                        on_cycle=lambda s, t: s.check_invariants())
    for rid, arr, prompt, olen in R.replay_trace(cfg.vocab_size):
        fe.submit(Request(rid=rid, arrival=arr, prompt_len=len(prompt),
                          output_len=olen), prompt)
    m = fe.run()
    got = R.summary(server)
    got.update(n_requests=m.n_requests,
               transitions=[t["transition"] for t in guard.transitions]
               if guard is not None else [],
               free=server.pool.free_blocks == server.pool.n_blocks)
    return server, guard, got


def test_transient_handoff_failure_retries_through(model):
    """A handoff failing under the retry budget is retried with backoff
    and goes through: no abort, no guard transition, streams identical to
    the clean chip replay, and the JAX chip engine's."""
    s0, _, clean = chip_replay(model, "replay_clean")
    assert clean["n_requests"] == 4 and clean["handoffs"] > 0
    s1, guard, got = chip_replay(model, "replay_transient")
    assert got["handoff_retries"] == 2
    assert got["prefill_aborts"] == 0
    assert not guard.transitions
    assert got["n_requests"] == 4
    assert got["outputs"] == clean["outputs"]
    assert clean == jax_chip("replay_clean")
    assert got == jax_chip("replay_transient")


def test_exhausted_handoff_degrades_chip_to_tile(model):
    """A handoff failing past the retry budget aborts the chip task and
    degrades chip -> tile; the aborted requests prefill again and the run
    completes with identical streams and a clean pool."""
    _, _, clean = chip_replay(model, "replay_clean")
    s1, guard, got = chip_replay(model, "replay_exhausted")
    assert "degrade:chip" in got["transitions"]
    assert got["prefill_aborts"] >= 1
    assert got["handoff_retries"] >= guard.cfg.handoff.max_retries
    assert guard.recovered and s1.partition == "chip"
    assert got["n_requests"] == 4
    assert got["outputs"] == clean["outputs"]
    assert got["free"]
    assert got == jax_chip("replay_exhausted")


def test_chip_mid_prefill_cancel_frees_staged_pages(model):
    """Cancelling mid-prefill on the chip path: the staged pages never
    cross to the decode side, only the survivor's are handed off."""
    server = chip_server(model, max_prefill_batch=2)
    reqs = [Request(rid=rid, arrival=0.0, prompt_len=len(p), output_len=o)
            for rid, p, o in R.cancel_requests(server.cfg.vocab_size)]
    for r, (_, p, _) in zip(reqs, R.cancel_requests(server.cfg.vocab_size)):
        server.submit(r, p)
    now = 0.0
    while reqs[0].phase != Phase.PREFILL:
        server.step(now)
        now += 1e-3
    assert server.ptask is not None and server.ptask.granularity == "chip"
    server.cancel_request(reqs[0], now, why="operator")
    server.run()
    assert reqs[0].phase == Phase.CANCELLED
    assert reqs[1].phase == Phase.FINISHED
    assert not server.outputs.get(0)
    assert server.stats.handoffs == 1
    assert server.pool.free_blocks == server.pool.n_blocks
    server.check_invariants()
    got = R.summary(server)
    got["phases"] = [r.phase.name for r in reqs]
    assert got == jax_chip("cancel")


def test_differential_chip_matches_serial(model):
    """Chip-granular execution replays tests/test_system.py's multi-tenant
    trace byte for byte against the JAX serial engine's golden streams and
    the JAX chip engine's."""
    jcfg, cfg, jparams, params = model
    js = JServer(jcfg, jparams, config=JServerConfig(
        slo=JSLO(3.0, 150.0), max_slots=4, max_len=64,
        cache=JCacheConfig(paged=True, page_size=4),
        execution=JExecConfig(fused=False)))
    jfe = JFrontend(js, JClock())
    jfe.submit_interactions(R.interactions(j_gen, j_apps), jcfg.vocab_size,
                            seed=11)
    jfe.run()
    golden = R.streams({r.rid: js.outputs[r.rid] for r in jfe.requests
                        if r.phase == JPhase.FINISHED})
    assert golden and len(golden) == len(jfe.requests)

    server = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=_est(n_chips=2), max_slots=4, max_len=64,
        cache=CacheConfig(paged=True, page_size=4),
        execution=ExecConfig(partition="chip", devices=("cpu", "cpu"))),
        device="cpu")
    fe = OnlineFrontend(server, VirtualClock(),
                        on_cycle=lambda s, now: s.pool.check_invariants())
    fe.submit_interactions(R.interactions(generate_tenant_interactions,
                                          make_apps), cfg.vocab_size, seed=11)
    fe.run()
    assert not fe.truncated
    done = {r.rid: server.outputs[r.rid] for r in fe.requests
            if r.phase == Phase.FINISHED}
    got = R.summary(server, done)
    got["n_requests"] = len(fe.requests)
    assert got["outputs"] == golden
    assert server.stats.chip_cycles > 0
    assert got == jax_chip("diff")


# ---------------------------------------------------------------------------
# refusals: no fallback
# ---------------------------------------------------------------------------

def test_chip_refusals_match_jax_words(model):
    _, cfg, _, params = model

    def build(**ex):
        est = ex.pop("est", None)
        paged = ex.pop("paged", None)
        return BulletServer(cfg, params, config=ServerConfig(
            slo=SLO(3.0, 150.0), est=est, cache=CacheConfig(paged=paged),
            execution=ExecConfig(**ex)), device="cpu")
    with pytest.raises(ValueError, match=r"partition='mesh': want "
                                         r"tile\|chip\|auto"):
        build(partition="mesh")
    with pytest.raises(ValueError, match="needs paged=True"):
        build(partition="chip", paged=False, devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match=r"partition='chip' needs >= 2 "
                                         r"devices .* \(have 1\); pass "
                                         r"devices="):
        build(partition="chip")
    with pytest.raises(ValueError, match="n_chips=4"):
        build(partition="chip", devices=("cpu", "cpu"), est=_est())
    with pytest.raises(ValueError, match="starts at cuda:0"):
        build(partition="chip", devices=("cuda:0", "cpu"))
    # the default spec prices the group; auto on one entry stays tile
    s = build(partition="chip", devices=("cpu",) * 3)
    assert s._chip_enabled and s.est.hw.n_chips == 3
    assert not build(partition="auto")._chip_enabled


def test_serve_partition_flags(capsys):
    """``--partition chip`` on one device without ``--devices`` exits with
    the engine's ValueError; over ``--devices cpu,cpu`` it serves through
    chip cycles."""
    with pytest.raises(ValueError, match="needs >= 2 devices"):
        serve.main(["--device", "cpu", "--partition", "chip",
                    "--requests", "2"])
    assert serve.main(["--device", "cpu", "--partition", "chip",
                       "--devices", "cpu,cpu", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert "KV pool clean: True" in out
    assert "handoffs=3" in out and "chip_cycles=0" not in out
