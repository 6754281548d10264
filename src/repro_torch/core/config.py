"""Grouped server configuration (the BulletServer construction surface).

A copy of the JAX package's ``ServerConfig``:

    from repro_torch.core.config import ServerConfig
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), max_slots=8), device="cuda")

The port serves the tile-granular path over the block-paged pool or the
dense slot cache and the chip-granular path over a device group
(``ExecConfig(partition="chip"|"auto", devices=...)``), with shared-prefix
reuse and the observability, fault-injection, SLO-guard and tenancy seams.
``launch/serve.py`` builds the config from CLI flags in one place
(``build_server_config``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.serving.request import SLO


@dataclass(frozen=True)
class CacheConfig:
    """KV cache layout and reuse knobs (docs/KV_SHARING.md)."""
    #: paged pool (None = engine default: paged; False = the dense
    #: fixed-slot cache)
    paged: Optional[bool] = None
    #: tokens per KV page
    page_size: int = 16
    #: ref-counted shared-prefix page reuse (paged pool, tile partition)
    share_prefix: bool = False


@dataclass(frozen=True)
class ExecConfig:
    """Where and how cycles execute (docs/PARTITIONS.md)."""
    #: fused spatial-sharing cycles (None = engine default: fused)
    fused: Optional[bool] = None
    #: partition granularity: "tile" | "chip" | "auto"
    partition: str = "tile"
    #: explicit device group for chip-granular splits (None = every
    #: visible card; a card may be named more than once only here)
    devices: Optional[Tuple[Any, ...]] = None


@dataclass(frozen=True)
class ControlConfig:
    """The control loops around the scheduler (docs/TUNING.md)."""
    #: online estimator refit: None = engine default (on), False = pinned,
    #: or a pre-built OnlineRefitter
    refit: Any = None
    #: cycles between refit solves
    refit_interval: int = 32
    #: Algorithm 1/2 search knobs; None = a fresh per-server
    #: SchedulerConfig() (never a shared module-level instance)
    sched: Optional[SchedulerConfig] = None


@dataclass(frozen=True)
class ServerConfig:
    """Everything BulletServer needs beyond (model cfg, params)."""
    slo: Optional[SLO] = None
    est: Any = None                      # PerfEstimator; None = default
    max_slots: int = 8
    max_len: int = 128
    max_prefill_batch: int = 4
    dtype: Any = None                    # None = engine default (float32)
    cache: CacheConfig = field(default_factory=CacheConfig)
    execution: ExecConfig = field(default_factory=ExecConfig)
    control: ControlConfig = field(default_factory=ControlConfig)
    obs: Any = None                      # Observability seam
    faults: Any = None                   # FaultInjector seam
    guard: Any = None                    # SLOGuard seam
    #: TenancyController seam (docs/MULTITENANCY.md); None runs
    #: single-tenant, byte-identical to the engine without the seam
    tenancy: Any = None


def build_server_config(args, *, slo=None, est=None, obs=None,
                        faults=None, guard=None, tenancy=None,
                        refit: Any = None) -> ServerConfig:
    """The one place launch/serve.py turns CLI flags into a ServerConfig.

    ``args`` is the serve argparse namespace; objects the launcher
    constructs itself (SLO choice differs per mode, estimator, obs,
    resilience seams, tenancy controller) are passed explicitly."""
    return ServerConfig(
        slo=slo, est=est,
        max_slots=args.slots, max_len=args.max_len,
        cache=CacheConfig(page_size=args.page_size,
                          share_prefix=args.share_prefix),
        execution=ExecConfig(partition=args.partition, devices=args.devices),
        control=ControlConfig(refit=refit),
        obs=obs, faults=faults, guard=guard, tenancy=tenancy)
