"""Meshes: the production mesh shapes (the port of the JAX package's
``launch/mesh.py``) and the runtime that runs one program per rank over a
mesh of ``torch.distributed`` processes.

A :class:`MeshShape` is a mesh's shape alone: axis names and sizes, the
layouts the JAX package lowers its dry-run on. Building one touches no
device state (the JAX docstring's rule).

A :class:`RankMesh` is the same shape seen from one rank of a running
process group: its ``torch.distributed.device_mesh.DeviceMesh`` (one group
per axis), a group per tuple of axes a partition spec may name together
(the data axes, and the model axis with them), the rank's coordinates and
its device. ``models/sharding.py`` places each leaf and runs every
collective through it; a sharded model call on it is the ``shard_map``
model: each rank computes on its local tensors, and the collectives are
explicit (ROADMAP §1 item 8d).

:func:`run_on_mesh` spawns one process per rank (``torch.multiprocessing``,
start method ``spawn``), joins them in one process group over a
``FileStore`` in a temporary directory (no fixed port: several runs may
share a host), builds each rank's :class:`RankMesh` and calls ``fn(mesh,
*args)`` there. ``devices`` names each rank's device, the rule of the
launcher's ``--devices``: one rank per visible card by default; a run that
wants more ranks than cards names them, and a card may repeat; ``"cpu"``
ranks run on the host. The backend is decided once, from that list:
``nccl`` when every rank has a card of its own, ``gloo`` when ranks share
a card or run on the CPU. A gloo group carries host tensors, so a rank on
a card stages each collective's tensor through the host
(``models/sharding.py`` counts every staged copy). A rank's exception
ends the run: the other ranks are terminated and the caller gets a
``RuntimeError`` with the rank's traceback.

:func:`fake_mesh` builds the rank-0 view of a mesh of any size in this
process over the ``fake`` backend (``torch.testing._internal``), whose
collectives accept meta tensors and move nothing: the dry-run traces one
rank's local step on it (``launch/dryrun.py``).
"""

from __future__ import annotations

import contextlib
import math
import multiprocessing
import os
import queue
import shutil
import tempfile
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: seconds a rank may take before :func:`run_on_mesh` gives up on the run
RANK_TIMEOUT = 900.0


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


def mesh_shape(sizes: Sequence[int],
               names: Optional[Sequence[str]] = None) -> MeshShape:
    """The shape of sizes ``(data, model)`` or ``(pod, data, model)`` (the
    policy's axis names), or of the given ``names``."""
    if names is None:
        names = ("data", "model") if len(sizes) == 2 else \
            ("pod", "data", "model")
    return MeshShape(tuple(names), tuple(int(s) for s in sizes))


# ---------------------------------------------------------------------------
# A rank's view of a running mesh
# ---------------------------------------------------------------------------

def axis_tuple(axes) -> Tuple[str, ...]:
    """A spec entry or an axis argument (None, a name, a tuple of names) as
    a tuple of axis names."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(a for a in axes if a)


def group_tuples(names: Sequence[str]) -> List[Tuple[str, ...]]:
    """The tuples of two or more axes a partition spec may name together:
    the data axes ("pod", "data"), and the model axis before them (the
    2D expert weights' d_ff when the experts cannot span "model")."""
    data = tuple(a for a in ("pod", "data") if a in names)
    out = []
    if len(data) > 1:
        out.append(data)
    if "model" in names and data:
        out.append(("model",) + data)
    return out


class RankMesh:
    """One rank's view of a mesh of ``torch.distributed`` ranks: the shape's
    fields (``axis_names``, ``shape``, ``size``, ``name``, so a
    ``ShardingPolicy`` is made on it as on a :class:`MeshShape`), the
    ``DeviceMesh``, the group of each axis and each tuple of
    :func:`group_tuples`, the rank's coordinate on each, its ``device``
    and ``backend``. ``staged``: a gloo group on a card, whose collectives
    go through host copies."""

    def __init__(self, shape: MeshShape, device, backend: str):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        self.axis_names = shape.axis_names
        self.axis_sizes = shape.axis_sizes
        self.device = torch.device(device)
        self.backend = backend
        self.rank = dist.get_rank()
        self.staged = backend == "gloo" and self.device.type == "cuda"
        mesh_type = "cuda" if backend == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(mesh_type, shape.axis_sizes,
                                            mesh_dim_names=shape.axis_names)
        layout = torch.arange(shape.size).reshape(shape.axis_sizes)
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self._coords: Dict[Tuple[str, ...], int] = {}
        for i, name in enumerate(shape.axis_names):
            self._groups[(name,)] = self.device_mesh.get_group(name)
            self._coords[(name,)] = int(
                (layout == self.rank).nonzero()[0, i])
        for tup in group_tuples(shape.axis_names):
            # every rank creates every subgroup, in the same order
            dims = [shape.axis_names.index(a) for a in tup]
            rest = [i for i in range(len(shape.axis_names)) if i not in dims]
            moved = layout.permute(rest + dims).reshape(-1, math.prod(
                shape.axis_sizes[d] for d in dims))
            for ranks in moved.tolist():
                group = dist.new_group(sorted(ranks))
                if self.rank in ranks:
                    # the group orders its ranks by global rank
                    self._groups[tup] = group
                    self._coords[tup] = sorted(ranks).index(self.rank)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.axis_sizes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axis_tuple(axes))

    def coord(self, axes) -> int:
        """This rank's index along ``axes`` (a name or a tuple of names),
        the shard it holds of a dim split over them."""
        axes = axis_tuple(axes)
        return self._coords[axes] if axes else 0

    def group(self, axes):
        return self._groups[axis_tuple(axes)]

    def has_group(self, axes) -> bool:
        return axis_tuple(axes) in self._groups


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------

def rank_devices(size: int, devices=None, device=None) -> List[str]:
    """Each rank's device: ``devices`` as given (a card may repeat), every
    rank on the CPU for ``device="cpu"``, else one rank per visible card
    (fewer cards than ranks: name the devices)."""
    if devices is not None:
        devices = [str(d) for d in devices]
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        return devices
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * size
    n = torch.cuda.device_count()
    if n < size:
        raise ValueError(f"{size} ranks, {n} visible cards: name the "
                         "devices (a card may repeat)")
    return [f"cuda:{i}" for i in range(size)]


def backend_for(devices: Sequence[str]) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    cards = [d for d in devs if d.type == "cuda"]
    if len(cards) == len(devs) and len({d.index for d in cards}) == len(devs):
        return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, store_path: str, shape: MeshShape,
               device: str, backend: str, fn, args, results) -> None:
    import torch.distributed as dist
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            out = fn(RankMesh(shape, dev, backend), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:                         # noqa: BLE001 - reported
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)


def _failures(results, shape, devs, backend, first) -> str:
    """The first failing rank's traceback and those of the ranks that
    fail within a few seconds after it (a rank's error often ends its
    peers' collectives too: the first to report is not always the
    cause)."""
    errors = [first]
    try:
        while True:
            rank, status, value = results.get(timeout=5.0)
            if status != "ok":
                errors.append((rank, value))
    except queue.Empty:
        pass
    return "\n".join(f"rank {r} of {shape.name} ({devs[r]}, {backend}) "
                     f"failed:\n{tb}" for r, tb in errors)


def run_on_mesh(fn: Callable, shape: MeshShape, *args, devices=None,
                device=None, timeout: float = RANK_TIMEOUT) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of ``shape``, one spawned
    process each (``fn`` and ``args`` must pickle: ``fn`` a module-level
    function). Returns each rank's return value, in rank order (values
    cross a process boundary: numpy arrays and Python values). Raises
    ``RuntimeError`` when a rank fails, dies or passes ``timeout``; every
    process is ended before this returns."""
    devs = rank_devices(shape.size, devices, device)
    backend = backend_for(devs)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    procs = [ctx.Process(target=_rank_main, args=(
        r, shape.size, os.path.join(tmp, "store"), shape, devs[r], backend,
        fn, args, results), daemon=True) for r in range(shape.size)]
    try:
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        while len(got) < len(procs):
            try:
                rank, status, value = results.get(timeout=timeout)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                raise RuntimeError(f"run_on_mesh: no result in {timeout} s "
                                   f"(ranks without one that ended: {dead})")
            if status != "ok":
                raise RuntimeError(_failures(results, shape, devs, backend,
                                             (rank, value)))
            got[rank] = value
        for p in procs:
            p.join(timeout=60)
            if p.exitcode not in (0, None):
                raise RuntimeError(f"a rank exited with {p.exitcode}")
        return [got[r] for r in range(len(procs))]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def fake_mesh(shape: MeshShape):
    """Rank 0's :class:`RankMesh` of ``shape`` in this process, over the
    ``fake`` backend: its collectives accept meta tensors and move nothing
    (the dry-run's per-device trace). The process group is destroyed on
    exit."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already running")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=shape.size)
    try:
        yield RankMesh(shape, "meta", "fake")
    finally:
        dist.destroy_process_group()

