"""The port as a package: it imports neither JAX nor the JAX package, its
serve launcher drains on the CPU, and its copies of the control plane
(``PagedKVPool``, ``SLOScheduler``) behave exactly like the JAX package's
on the same seeded operation sequences."""

import ast
import pathlib

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core import metadata as JM
from repro.core.estimator import HardwareSpec as JHardwareSpec
from repro.core.estimator import PerfEstimator as JPerfEstimator
from repro.core.resource import ResourceManager as JResourceManager
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.core.scheduler import SLOScheduler as JScheduler
from repro.kvcache.paged import OutOfBlocks as JOutOfBlocks
from repro.kvcache.paged import PagedKVPool as JPool
from repro.serving.request import SLO as JSLO
from repro_torch.configs import get_config
from repro_torch.core import metadata as TM
from repro_torch.core.estimator import HardwareSpec, PerfEstimator
from repro_torch.core.resource import ResourceManager
from repro_torch.core.scheduler import SchedulerConfig, SLOScheduler
from repro_torch.kvcache.paged import OutOfBlocks, PagedKVPool
from repro_torch.launch import serve
from repro_torch.serving.request import SLO

ROOT = pathlib.Path(__file__).resolve().parents[2]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serve_host_on_cpu_drains(capsys):
    assert serve.main(["--mode", "host", "--device", "cpu",
                       "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    assert "stats: " in out
    assert "KV pool clean: True" in out


def test_registry_holds_the_paged_models():
    for name in ("qwen3-1.7b", "llama3.1-8b"):
        assert get_config(name) == _as_port(jax_config(name))


def _as_port(jcfg):
    """The JAX config rebuilt, field for field, as a port ModelConfig."""
    from dataclasses import asdict
    from repro_torch.configs.base import BlockSpec, ModelConfig
    d = asdict(jcfg)
    d["pattern"] = tuple(BlockSpec(**b) for b in d["pattern"])
    d["pattern_tail"] = tuple(BlockSpec(**b) for b in d["pattern_tail"])
    return ModelConfig(**d)


def _pool_state(pool, rids, n_slots=6, max_blocks=8):
    tables = {rid: (list(t.blocks), t.n_tokens) if (t := pool.table(rid))
              else None for rid in rids}
    return (pool.free_blocks, pool.available_blocks, pool.allocated_blocks,
            sorted(pool.owners()), tables,
            pool.device_block_table(
                [r if r in pool.owners() else None
                 for r in range(n_slots)], max_blocks).tolist())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_pool_copy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jp, tp = JPool(640, block_size=16), PagedKVPool(640, block_size=16)
    rids = list(range(6))
    for _ in range(200):
        op = rng.choice(["allocate", "migrate", "preempt", "free", "extend"])
        rid = int(rng.choice(rids))
        n = int(rng.integers(1, 200))
        results = []
        for pool, oob in ((jp, JOutOfBlocks), (tp, OutOfBlocks)):
            try:
                if op == "allocate":
                    out = (pool.can_admit(n), pool.allocate(rid, n).blocks
                           if pool.table(rid) is None and pool.can_admit(n)
                           else None)
                elif pool.table(rid) is None:
                    out = None
                elif op == "extend":
                    out = list(pool.extend(rid, 1).blocks)
                else:
                    out = getattr(pool, op)(rid)
                    out = getattr(out, "blocks", out)
            except oob:
                out = "out-of-blocks"
            results.append(out)
            pool.check_invariants()
        assert results[0] == results[1], op
        assert _pool_state(jp, rids) == _pool_state(tp, rids)


def _state(mod, rng, total_units):
    s = mod.SystemState()
    if rng.random() < 0.7:
        s.prefill.active_rid = 100
        s.prefill.total_layers = 28
        s.prefill.layers_done = int(rng.integers(0, 28))
        s.prefill.n_tokens = int(rng.integers(16, 2048))
        s.prefill.started_at = float(rng.random() * 0.05)
        s.prefill.queue_wait[100] = float(rng.random() * 0.02)
    n_d = int(rng.integers(0, 8))
    s.decode.batch = list(range(n_d))
    for rid in range(n_d):
        s.decode.out_tokens[rid] = int(rng.integers(1, 64))
        s.decode.decode_time[rid] = float(rng.random() * 2.0)
    s.decode.ctx_tokens = int(rng.integers(1, 4096)) * max(n_d, 1)
    s.decode.mean_context = s.decode.ctx_tokens // max(n_d, 1)
    u = int(rng.integers(0, total_units // 2 + 1)) * 2
    s.resources.prefill_units = u
    s.resources.decode_units = total_units - u
    return s


@pytest.mark.parametrize("fused", [True, False])
def test_scheduler_copy_matches_jax(fused):
    """Same hardware fields, config, SLO and a seeded sequence of system
    states and pending queues: identical decisions."""
    hw = dict(name="h100-sxm", n_chips=1, peak_flops=989e12,
              hbm_bw=3.35e12, ici_bw=450e9, units_per_chip=132,
              grid_slots=132)
    cfg, jcfg = get_config("qwen3-1.7b"), jax_config("qwen3-1.7b")
    js = JScheduler(jcfg, JPerfEstimator(JHardwareSpec(**hw)),
                    JSLO(3.0, 150.0), JSchedulerConfig(fused=fused))
    ts = SLOScheduler(cfg, PerfEstimator(HardwareSpec(**hw)),
                      SLO(3.0, 150.0), SchedulerConfig(fused=fused))
    if fused:
        jrm = JResourceManager(JHardwareSpec(**hw), 2)
        trm = ResourceManager(HardwareSpec(**hw), 2)
        js.split_candidates = [(p.prefill_units, p.decode_units)
                               for p in jrm.tile_entries]
        ts.split_candidates = [(p.prefill_units, p.decode_units)
                               for p in trm.tile_entries]
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for step in range(60):
        jstate, tstate = _state(JM, jrng, 132), _state(TM, trng, 132)
        now = 0.01 * step
        pending = [(200 + i, now - 0.001 * i, 64 * (i + 1))
                   for i in range(step % 5)]
        jd = js.schedule(jstate, now, pending)
        td = ts.schedule(tstate, now, pending)
        assert (td.resources.prefill_units, td.resources.decode_units,
                td.pause_decode, td.reorder, td.reason) == (
            jd.resources.prefill_units, jd.resources.decode_units,
            jd.pause_decode, jd.reorder, jd.reason), step
        assert ts.reorder_pending(tstate, now, pending) == \
            js.reorder_pending(jstate, now, pending)
