"""Grouped server configuration (the BulletServer construction surface).

A copy of the JAX package's ``ServerConfig``:

    from repro_torch.core.config import ServerConfig
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), max_slots=8), device="cuda")

The port serves the tile-granular path over the block-paged pool or the
dense slot cache, with the observability, fault-injection and SLO-guard
seams. Fields that select a path of a later slice of the port raise
``NotImplementedError`` at construction, naming the ROADMAP item that
brings them. ``launch/serve.py`` builds the config from CLI flags in one
place (``build_server_config``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.serving.request import SLO

_LATER = {
    "tenancy": "ROADMAP port item 'tenancy'",
    "share_prefix": "ROADMAP port item 'shared-prefix reuse'",
    "chip": "ROADMAP port item 'chip granularity'",
}


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; it comes with {_LATER[item]}")


@dataclass(frozen=True)
class CacheConfig:
    """KV cache layout and reuse knobs (docs/KV_SHARING.md)."""
    #: paged pool (None = engine default: paged; False = the dense
    #: fixed-slot cache)
    paged: Optional[bool] = None
    #: tokens per KV page
    page_size: int = 16
    #: ref-counted shared-prefix page reuse (a later slice)
    share_prefix: bool = False

    def __post_init__(self):
        if self.share_prefix:
            raise _later("share_prefix", "share_prefix")


@dataclass(frozen=True)
class ExecConfig:
    """Where and how cycles execute (docs/PARTITIONS.md)."""
    #: fused spatial-sharing cycles (None = engine default: fused)
    fused: Optional[bool] = None
    #: partition granularity: "tile" (the chip/auto granularities are a
    #: later slice)
    partition: str = "tile"
    #: explicit device list for chip-granular sub-meshes (a later slice)
    devices: Optional[Tuple[Any, ...]] = None

    def __post_init__(self):
        if self.partition != "tile":
            raise _later(f"partition={self.partition!r}", "chip")
        if self.devices is not None:
            raise _later("an explicit device list", "chip")


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
    tenancy: Any = None                  # TenancyController (later slice)

    def __post_init__(self):
        if self.tenancy is not None:
            raise _later("ServerConfig.tenancy", "tenancy")


def build_server_config(args, *, slo=None, est=None, obs=None,
                        faults=None, guard=None,
                        refit: Any = None) -> ServerConfig:
    """The one place launch/serve.py turns CLI flags into a ServerConfig.

    ``args`` is the serve argparse namespace; objects the launcher
    constructs itself (SLO choice differs per mode, estimator, obs,
    resilience seams) are passed explicitly."""
    return ServerConfig(
        slo=slo, est=est,
        max_slots=args.slots, max_len=args.max_len,
        cache=CacheConfig(page_size=args.page_size),
        control=ControlConfig(refit=refit),
        obs=obs, faults=faults, guard=guard)
