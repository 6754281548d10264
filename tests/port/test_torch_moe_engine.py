"""The port's ``BulletServer`` against the JAX package's on the MoE models
(reduced ``llama4-maverick-400b-a17b`` on the paged pool, serial and fused;
reduced ``mixtral-8x22b`` on the dense slot cache, its 64-token window
passed) at the configs' own capacity factor 1.25, and on the two
multi-head Qwen1.5 configs, fp32 on the CPU with the JAX params bridged:
``test_torch_engine.py``'s harness, one prompt per prefill batch (so the
JAX engine pads nothing, while the port still pads each prompt to its
length bucket: the padding contract of ``models/moe.py`` is what keeps the
two equal). Greedy streams and the per-cycle CycleObservation traces
identical, and the port's prefill MoE calls dropped tokens, so that the
capacity path ran. Also the launcher's ``--arch`` for the MoE configs in
host and replay mode (sim mode: ``test_torch_simulate.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core import estimator as JE
from repro.core.config import CacheConfig as JCacheConfig
from repro.core.config import ControlConfig as JControlConfig
from repro.core.config import ExecConfig as JExecConfig
from repro.core.config import ServerConfig as JServerConfig
from repro.core.engine import BulletServer as JServer
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.models import init_params as jax_init_params
from repro.serving.request import Request as JRequest
from repro.serving.request import SLO as JSLO
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.config import (CacheConfig, ControlConfig, ExecConfig,
                                    ServerConfig)
from repro_torch.core.engine import BulletServer
from repro_torch.core.estimator import HardwareSpec, PerfEstimator
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.launch import serve
from repro_torch.serving.request import SLO, Request

#: test_torch_engine.py's spec fields: a small partition table
HW = dict(name="h100-sxm", n_chips=1, peak_flops=989e12, hbm_bw=3.35e12,
          ici_bw=450e9, units_per_chip=8, grid_slots=8)
#: (arch, prompt lengths drawn in [lo, hi), max_len): Mixtral's prompts
#: pass its reduced 64-token window, so its rings wrap
SETUPS = {"llama4-maverick-400b-a17b": (20, 60, 80),
          "mixtral-8x22b": (66, 90, 112),
          "qwen1.5-4b": (4, 16, 48),
          "codeqwen1.5-7b": (4, 16, 48)}


def _model(arch):
    jcfg = jax_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _servers(arch, fused):
    jcfg, cfg, jparams, params = _model(arch)
    max_len = SETUPS[arch][2]
    paged = jcfg.pattern[0].mixer == "attn"
    base = dict(max_slots=4, max_len=max_len, max_prefill_batch=1)
    js = JServer(jcfg, jparams, config=JServerConfig(
        slo=JSLO(3.0, 150.0), est=JE.PerfEstimator(JE.HardwareSpec(**HW)),
        cache=JCacheConfig(paged=paged), execution=JExecConfig(fused=fused),
        control=JControlConfig(
            sched=JSchedulerConfig(max_decode_pause_cycles=0)), **base))
    ts = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), est=PerfEstimator(HardwareSpec(**HW)),
        cache=CacheConfig(paged=paged), execution=ExecConfig(fused=fused),
        control=ControlConfig(sched=SchedulerConfig(max_decode_pause_cycles=0)),
        **base), device="cpu")
    return js, ts, cfg


def _submit(js, ts, cfg, arch, n=6, out_len=8):
    lo, hi, _ = SETUPS[arch]
    rng = np.random.default_rng(0)
    for rid in range(n):
        plen = int(rng.integers(lo, hi))
        prompt = rng.integers(0, cfg.vocab_size, plen)
        js.submit(JRequest(rid=rid, arrival=0.0, prompt_len=plen,
                           output_len=out_len), prompt)
        ts.submit(Request(rid=rid, arrival=0.0, prompt_len=plen,
                          output_len=out_len), prompt)


def _drive(server, max_cycles=600):
    """Step until idle on the virtual clock (cycle i at i ms), auditing
    every cycle; returns the per-cycle (CycleObservation, fused?) trace."""
    trace, now = [], 0.0
    for _ in range(max_cycles):
        if server.idle:
            break
        server.step(now)
        server.check_invariants()
        trace.append((server.last_cycle_observation(), server.last_fused))
        now += 1e-3
    assert server.idle
    return trace


@pytest.mark.parametrize("arch,fused", [
    ("llama4-maverick-400b-a17b", False),
    ("llama4-maverick-400b-a17b", True),
    ("mixtral-8x22b", False),
    ("qwen1.5-4b", False),
    ("codeqwen1.5-7b", True),
])
def test_streams_and_observations_match_jax(arch, fused):
    js, ts, cfg = _servers(arch, fused)
    assert ts.paged == js.paged
    _submit(js, ts, cfg, arch)
    jtrace = _drive(js)
    ttrace = _drive(ts)
    assert ts.outputs == js.outputs
    assert all(len(v) == 8 for v in ts.outputs.values())
    assert ttrace == jtrace
    assert ts.stats.fused_cycles == js.stats.fused_cycles
    if fused:
        assert ts.stats.fused_cycles > 0
    if cfg.n_experts:
        moe = ts.moe_stats.read()
        # one call per MoE layer of every prefill group
        n_moe = sum(b.ff == "moe" for b in cfg.pattern)
        assert moe["calls"] == ts.stats.prefill_cycles * n_moe
        assert moe["dropping_calls"] >= 1
        assert moe["mean_dropped_fraction"] > 0.0
    else:
        assert ts.moe_stats is None


# --- the launcher --------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "mixtral-8x22b"])
def test_serve_host_and_replay_on_cpu_drain(capsys, arch):
    assert serve.main(["--mode", "host", "--device", "cpu", "--arch", arch,
                       "--requests", "3"]) == 0
    assert serve.main(["--mode", "replay", "--device", "cpu", "--arch",
                       arch, "--requests", "3", "--duration", "2"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert out.count("KV pool clean: True") == 2
