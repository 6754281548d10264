"""Production mesh shapes, the port of the JAX package's ``launch/mesh.py``.

A mesh here is its shape alone: axis names and sizes, the layouts the JAX
package lowers its dry-run on. Building one touches no device state (the
JAX docstring's rule): the dry-run traces on the meta device and reads the
mesh only to place each leaf's bytes by its partition spec
(``launch/specs.sharded_resident_gb``). A runtime over real devices comes
with ROADMAP §1 item 8d.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class MeshShape:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        """``16x16`` or ``2x16x16``, the JAX dry-run row's ``mesh``."""
        return "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single-pod 16×16 (256 chips) or 2-pod 2×16×16 (512 chips), the JAX
    package's v5e layouts."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1) -> MeshShape:
    """A small mesh over the local CUDA cards (tests / examples); a host
    without one counts as one device."""
    n = torch.cuda.device_count() or 1
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return MeshShape(("data", "model"), (data, model))
