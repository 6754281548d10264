"""Resilience layer: deterministic fault injection + SLO watchdog (the
port's copy of the JAX package's ``src/repro/resilience``, pure Python).

Two halves (docs/RESILIENCE.md):

- :mod:`repro_torch.resilience.faults` — a seeded, virtual-clock-driven
  :class:`FaultInjector` that perturbs the engine through narrow seams
  (straggler cycles, dispatch failures, cross-mesh handoff faults, page
  pool squeezes, estimator drift). :data:`NULL_FAULTS` is the disabled
  default, mirroring ``obs.NULL_OBS``: production pays one attribute
  check per seam.
- :mod:`repro_torch.resilience.guard` — an :class:`SLOGuard` consulted in
  ``BulletServer.step``: per-request deadline enforcement, bounded-queue
  admission backpressure, and a degradation state machine over the
  lattice fused→serial, chip→tile, paged→dense with cooldown probe-back.
"""

from repro_torch.resilience.faults import (NULL_FAULTS, DispatchError,
                                           FaultInjector, FaultPlan, FaultSpec,
                                           HandoffError)
from repro_torch.resilience.guard import AdmissionRejected, GuardConfig, SLOGuard

__all__ = [
    "AdmissionRejected", "DispatchError", "FaultInjector", "FaultPlan",
    "FaultSpec", "GuardConfig", "HandoffError", "NULL_FAULTS", "SLOGuard",
]
