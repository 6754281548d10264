"""The port as a package: it imports neither JAX nor the JAX package, its
serve launcher drains on the CPU, and its copies of the control plane
(``PagedKVPool``, ``SLOScheduler``, the profiler's surrogate machine and
the workload generators) behave exactly like the JAX package's on the
same seeded operation sequences."""

import ast
import pathlib

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core import metadata as JM
from repro.core import profiler as JP
from repro.core.estimator import HardwareSpec as JHardwareSpec
from repro.core.estimator import PerfEstimator as JPerfEstimator
from repro.core.resource import ResourceManager as JResourceManager
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.core.scheduler import SLOScheduler as JScheduler
from repro.kvcache.paged import OutOfBlocks as JOutOfBlocks
from repro.kvcache.paged import PagedKVPool as JPool
from repro.serving import workload as JW
from repro.serving.request import SLO as JSLO
from repro_torch.configs import get_config, list_configs
from repro_torch.core import metadata as TM
from repro_torch.core import profiler as TP
from repro_torch.core.estimator import HardwareSpec, PerfEstimator
from repro_torch.core.resource import ResourceManager
from repro_torch.core.scheduler import SchedulerConfig, SLOScheduler
from repro_torch.kvcache.paged import OutOfBlocks, PagedKVPool
from repro_torch.launch import serve
from repro_torch.serving import workload as TW
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
                         + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "scripts").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_scan_covers_the_training_path():
    scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"training/trainer.py", "training/optimizer.py",
            "training/checkpoint.py", "training/tree.py",
            "data/pipeline.py", "launch/train.py"} <= scanned


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


def test_registry_holds_mamba2():
    assert get_config("mamba2-2.7b") == _as_port(jax_config("mamba2-2.7b"))
    assert sorted(list_configs()) == [
        "codeqwen1.5-7b", "granite-3-2b", "internvl2-76b", "llama3.1-8b",
        "llama4-maverick-400b-a17b", "mamba2-2.7b", "mixtral-8x22b",
        "qwen1.5-4b", "qwen3-1.7b", "recurrentgemma-2b",
        "seamless-m4t-large-v2"]


def test_registry_holds_recurrentgemma():
    cfg = get_config("recurrentgemma-2b")
    assert cfg == _as_port(jax_config("recurrentgemma-2b"))
    assert cfg.n_layers == 26 and cfg.head_dim == 256 and cfg.pattern_tail


def test_kernel_library_builds_every_source_under_a_neutral_name():
    """One library holds every kernel of csrc/: its name names no kernel
    family, every source and header is part of its digest, and every C
    entry point the loader declares is defined in one of the sources."""
    from repro_torch.kernels import build
    assert build.library_path().name.startswith("librepro_kernels_")
    assert set(build.SOURCES) == {p.name for p in build.CSRC.glob("*.cu")}
    assert set(build.HEADERS) == {p.name for p in build.CSRC.glob("*.cuh")}
    text = "".join((build.CSRC / n).read_text() for n in build.SOURCES)
    for name in build.SIGNATURES:
        assert f"int {name}(" in text, name
    assert "ssd_scan_fwd" in build.SIGNATURES
    assert "rglru_scan_fwd" in build.SIGNATURES
    assert build.HEAD_DIMS == (64, 128, 256)
    assert build.PAGED_HEAD_DIMS == (64, 128)


def _as_port(jcfg):
    """The JAX config rebuilt, field for field, as a port ModelConfig."""
    from dataclasses import asdict
    from repro_torch.configs.base import BlockSpec, ModelConfig
    d = asdict(jcfg)
    d["pattern"] = tuple(BlockSpec(**b) for b in d["pattern"])
    d["pattern_tail"] = tuple(BlockSpec(**b) for b in d["pattern_tail"])
    return ModelConfig(**d)


def _pool_state(pool, rids, n_slots=6, max_blocks=8):
    tables = {rid: (list(t.blocks), t.n_tokens, t.shared_tokens,
                    t.shared_blocks, list(t.cow_pairs))
              if (t := pool.table(rid)) else None for rid in rids}
    return (pool.free_blocks, pool.available_blocks, pool.allocated_blocks,
            pool.cached_blocks, sorted(pool.owners()), tables,
            sorted(vars(pool.ops).items()),
            pool.device_block_table(
                [r if r in pool.owners() else None
                 for r in range(n_slots)], max_blocks).tolist())


def _prompt(rng, docs, n):
    """``n`` tokens of one of ``docs``, half the time with one token
    changed (a divergence mid-page: a copy-on-write tail on a hit)."""
    toks = docs[int(rng.integers(0, len(docs)))][:n].copy()
    if rng.random() < 0.5:
        toks[int(rng.integers(0, n))] = int(rng.integers(50, 60))
    return toks


@pytest.mark.parametrize("seed,share", [(0, False), (1, False), (2, False),
                                        (0, True), (1, True), (2, True)],
                         ids=["0", "1", "2", "share-0", "share-1",
                              "share-2"])
def test_paged_pool_copy_matches_jax(seed, share):
    """The same seeded operation storm on both pools: allocate, migrate,
    preempt, free, extend and, sharing, allocate with prompt tokens
    (prefix hits, copy-on-write tails), register_prefix, match_prefix,
    flush_shared (refused under live readers) and reclaimable_blocks."""
    rng = np.random.default_rng(seed)
    jp = JPool(640, block_size=16, share_prefix=share)
    tp = PagedKVPool(640, block_size=16, share_prefix=share)
    rids = list(range(6))
    docs = [rng.integers(0, 50, 400).astype(np.int32) for _ in range(2)]
    prompts = {}
    ops = ["allocate", "migrate", "preempt", "free", "extend"]
    if share:
        ops += ["allocate", "register", "register", "match", "flush",
                "reclaimable"]
    for _ in range(200 if not share else 300):
        op = rng.choice(ops)
        rid = int(rng.choice(rids))
        n = int(rng.integers(1, 200))
        toks = _prompt(rng, docs, n) if share else None
        if op == "allocate" and tp.table(rid) is None:
            prompts[rid] = toks
        elif op == "register" and rid in prompts:
            written = prompts[rid][:int(rng.integers(0, len(prompts[rid])
                                                     + 1))]
        results = []
        for pool, oob in ((jp, JOutOfBlocks), (tp, OutOfBlocks)):
            try:
                if op == "allocate":
                    out = (pool.can_admit(n),
                           pool.allocate(rid, n, prompt_tokens=toks).blocks
                           if pool.table(rid) is None and pool.can_admit(n)
                           else None)
                elif op == "match":
                    out = pool.match_prefix(toks)
                elif op == "flush":
                    out = pool.flush_shared()
                elif pool.table(rid) is None:
                    out = None
                elif op == "extend":
                    out = list(pool.extend(rid, 1).blocks)
                elif op == "register":
                    out = pool.register_prefix(rid, written)
                elif op == "reclaimable":
                    out = pool.reclaimable_blocks(rid)
                else:
                    out = getattr(pool, op)(rid)
                    out = getattr(out, "blocks", out)
            except oob:
                out = "out-of-blocks"
            except RuntimeError as e:           # flush under live readers
                out = ("refused", str(e))
            results.append(out)
            pool.check_invariants()
        assert results[0] == results[1], op
        assert _pool_state(jp, rids) == _pool_state(tp, rids)
    if share:
        assert tp.ops.shared_hits and tp.ops.cow_copies and tp.ops.registers


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


def test_profiler_copy_matches_jax():
    """The surrogate machine the virtual replay's oracle charges, and the
    profiling sweep over it: same samples, same noise, same HardwareSpec
    fields."""
    hw = dict(name="h100-sxm", n_chips=1, peak_flops=989e12,
              hbm_bw=3.35e12, ici_bw=450e9, units_per_chip=132,
              grid_slots=132)
    cfg, jcfg = get_config("qwen3-1.7b"), jax_config("qwen3-1.7b")
    kw = dict(max_sl=2048, max_bs=16, max_cl=2048, unit_step=12, seed=4)
    js = JP.run_profiling(jcfg, JHardwareSpec(**hw), **kw)
    ts = TP.run_profiling(cfg, HardwareSpec(**hw), **kw)
    assert [tuple(vars(x).values()) for x in ts] == \
        [tuple(vars(x).values()) for x in js]
    jm = JP.SurrogateMachine(JHardwareSpec(**hw), seed=2)
    tm = TP.SurrogateMachine(HardwareSpec(**hw), seed=2)
    for sl, bs, cl, u in ((512, 4, 900, 60), (37, 1, 17, 2)):
        assert tm.measure_prefill(cfg, sl, u, colocated=True) == \
            jm.measure_prefill(jcfg, sl, u, colocated=True)
        assert tm.measure_decode(cfg, bs, cl, u, colocated=False) == \
            jm.measure_decode(jcfg, bs, cl, u, colocated=False)


@pytest.mark.parametrize("dataset", ["sharegpt", "azure-code",
                                     "arxiv-summary"])
def test_workload_copy_matches_jax(dataset):
    def rows(trace):
        return [(r.rid, r.arrival, r.prompt_len, r.output_len)
                for r in trace]
    for seed in (0, 5):
        jt = JW.generate_trace(dataset, 40.0, 3.0, seed=seed,
                               max_requests=50)
        tt = TW.generate_trace(dataset, 40.0, 3.0, seed=seed,
                               max_requests=50)
        assert rows(tt) == rows(jt)
        assert rows(TW.fit_trace_to_context(tt, 1000)) == \
            rows(JW.fit_trace_to_context(jt, 1000))
    assert [(s.session_id, s.arrival, [tuple(vars(t).values())
                                       for t in s.turns])
            for s in TW.generate_interactions(6, 3.0, seed=1)] == \
        [(s.session_id, s.arrival, [tuple(vars(t).values())
                                    for t in s.turns])
         for s in JW.generate_interactions(6, 3.0, seed=1)]
