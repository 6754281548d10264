"""Offline profiling (paper §3.2.2): the port's copy of the JAX package's
``core/profiler.py``, pure numpy.

On real hardware this sweeps (sl, bs, cl, pm, dm) with wall-clock timing
(~12k trials / ~2h on the paper's A100). Here measurements come from a
*hardware surrogate*: a roofline machine with hidden ground-truth
decay/contention parameters plus multiplicative noise (the virtual-clock
replay's ``oracle_cycle_cost`` charges it). Running the sweep on the card
is a later item of the port (ROADMAP).
The fitting pipeline (estimator.fit_params) is identical either way — the
surrogate only replaces the stopwatch. Estimator-accuracy results (paper
Fig. 15) are therefore "recovery" results: can the fitted model predict the
surrogate's timings on unseen workload points?
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.estimator import (EstimatorParams, HardwareSpec,
                                        PerfEstimator, ProfileSample,
                                        predict_cycle)

#: Hidden ground truth the surrogate machine uses (deliberately different
#: from EstimatorParams defaults so the fit has something to recover).
#: The values are the JAX package's (its rationale is in that module); they
#: are a surrogate, not a measurement of any device.
TRUE_PARAMS = EstimatorParams(
    alpha_c=1.12, alpha_b=0.80, p_c=0.94, p_b=0.88,
    sustained_compute=0.74, sustained_bw=0.78)


@dataclass
class SurrogateMachine:
    """Ground-truth timing oracle with measurement noise."""
    hw: HardwareSpec
    params: EstimatorParams = field(default_factory=lambda: TRUE_PARAMS)
    noise_std: float = 0.06
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._est = PerfEstimator(self.hw, self.params)

    def _noisy(self, t: float) -> float:
        return t * float(np.exp(self._rng.normal(0.0, self.noise_std)))

    def measure_prefill(self, cfg: ModelConfig, sl: int, units: int, *,
                        colocated: bool, ctx_start: int = 0,
                        oversub: float = 1.0) -> float:
        return self._noisy(self._est.prefill_time(
            cfg, sl, units, ctx_start=ctx_start, colocated=colocated,
            oversub=oversub))

    def measure_decode(self, cfg: ModelConfig, bs: int, cl: int, units: int,
                       *, colocated: bool, oversub: float = 1.0) -> float:
        return self._noisy(self._est.decode_iter_time(
            cfg, bs, cl, units, colocated=colocated, oversub=oversub))

    def measure_cycle(self, cfg: ModelConfig, obs) -> float:
        """Ground-truth duration of one engine cycle (a
        ``CycleObservation``): the shared predict_cycle charging rule
        evaluated under the surrogate's hidden parameters, plus
        measurement noise. This is the oracle behind refit benchmarks —
        the engine predicts with its fitted params, "reality" runs on
        these."""
        return self._noisy(predict_cycle(self._est, cfg, obs))


def run_profiling(cfg: ModelConfig, hw: HardwareSpec, *,
                  sl_step: int = 1024, bs_step: int = 8, cl_step: int = 1024,
                  unit_step: int = 6, max_sl: int = 8192, max_bs: int = 64,
                  max_cl: int = 8192, kv_budget_tokens: int = 300_000,
                  seed: int = 0) -> List[ProfileSample]:
    """Sweep per §3.2.2: sl, bs, cl, and unit splits at fixed steps while
    keeping bs·cl within KV-cache capacity."""
    machine = SurrogateMachine(hw, seed=seed)
    samples: List[ProfileSample] = []
    U = hw.total_units

    # 1) isolated prefill (fits d_c / sustained_compute)
    for sl in range(sl_step, max_sl + 1, sl_step):
        for pm in range(unit_step, U + 1, unit_step):
            t = machine.measure_prefill(cfg, sl, pm, colocated=False)
            samples.append(ProfileSample(sl, 0, 0, pm, 0, t, 0.0))

    # 2) isolated decode (fits d_b / sustained_bw)
    for bs in range(bs_step, max_bs + 1, bs_step):
        for cl in range(cl_step, max_cl + 1, cl_step):
            if bs * cl > kv_budget_tokens:
                continue
            for dm in range(unit_step, U + 1, unit_step):
                t = machine.measure_decode(cfg, bs, cl, dm, colocated=False)
                samples.append(ProfileSample(0, bs, cl, 0, dm, 0.0, t))

    # 3) co-located (fits p_c / p_b)
    for sl in range(sl_step, max_sl + 1, sl_step * 2):
        for bs in range(bs_step, max_bs + 1, bs_step * 2):
            cl = cl_step
            for pm in range(unit_step, U, unit_step * 2):
                dm = U - pm
                tp = machine.measure_prefill(cfg, sl, pm, colocated=True)
                td = machine.measure_decode(cfg, bs, cl, dm, colocated=True)
                samples.append(ProfileSample(sl, bs, cl, pm, dm, tp, td))
    return samples
