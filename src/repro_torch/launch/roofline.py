"""Roofline analysis of a step as PyTorch runs it, the port of the JAX
package's ``launch/roofline.py``.

PyTorch has no HLO to parse, so :class:`Counter` counts the eager op
stream under a ``TorchDispatchMode``: on the meta device for a dry-run
(shapes only, nothing allocated), or on real tensors on the card.

- Dot FLOPs (2·M·N·K) come from ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``mv``, ``dot``, ``linear`` and ``convolution``, by the product's dtype.
- HBM bytes: every materializing op moves its inputs once and writes its
  outputs once (each tensor as the view it is: a broadcast dim counts
  once). Views, factories and metadata ops are free, the counterpart of
  the JAX ``_FREE_OPS``. An in-place write into a slice of a larger buffer
  (``index_copy_``, ``index_put_``, ``scatter_``, ``copy_`` into a view)
  is charged by its update, as the JAX tool charges
  ``dynamic-update-slice``, and a gather (``index``, ``index_select``,
  ``gather``, ``embedding``) by the rows it reads, as ``dynamic-slice``.
- The hand-written kernels are ``ctypes`` calls no dispatch mode sees:
  while a counter runs, every kernel wrapper charges its launch by the
  formulas of ``kernels/cost.py`` and the counter skips the ops nested
  inside it (``Counter.kernel``). On real tensors a decode kernel charges
  the rows its slots attend; on the meta device every row of the cache.
- The temp peak: the peak of the bytes of the storages the step allocates
  and still holds (weak references to each new storage), beyond the
  arguments it was given.
- On the meta device many elementwise ops run Python reference kernels
  (100-600 µs each), so the counter memoizes a pure op's meta results (no
  argument written, no result aliased) by its inputs' shapes, strides and
  dtypes and its other arguments: the same op on the same metadata gets
  fresh empty results of the remembered shapes. Counts are unchanged.

- Collectives: a sharded step's collectives (``models/sharding.py``)
  charge their bytes by type while a counter runs (``collective_bytes``,
  ``collective_count``: an all-reduce twice its bytes, an all-gather its
  output, a reduce-scatter its input, the JAX tool's traffic), and their
  input and output once to the HBM bytes, as the JAX tool charges a
  collective outside a fusion; the ops inside one are not counted.

Terms are seconds at one H100 SXM's peaks (``kernels/cost.py``): compute
at the peak of each operation's type (989 TFLOP/s bf16, 67 TFLOP/s fp32),
memory at 3.35 TB/s, and collectives at the NVLink rate of the port's
``HardwareSpec`` (``core/estimator.py``: 450 GB/s each way). A step
counted on one card has no collectives, and its ``collective_s`` is 0; a
rank's local step of a sharded run (the dry-run's per-device trace,
ROADMAP §1 item 8d) charges its own. An H100 host joins 8 cards by
NVLink; a 16-wide model axis spans two hosts, whose link (InfiniBand, 50
GB/s a card each way on an HGX H100 host) is slower, so its
``collective_s`` is a lower bound.
"""

from __future__ import annotations

import contextlib
import functools
import math
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.estimator import HardwareSpec
from repro_torch.kernels import cost

#: NVLink bytes a second each way: the port's ``HardwareSpec.ici_bw``
ICI_BW = HardwareSpec.__dataclass_fields__["ici_bw"].default

#: the product ops and how each finds (M·N·K or its like) from its operands
_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot",
            "linear", "convolution")
#: ops that move no bytes: metadata, and views the schema does not mark
#: as aliases
_FREE_OPS = {"sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
             "is_same_size", "_local_scalar_dense", "_unsafe_view",
             "_reshape_alias", "lift_fresh", "lift_fresh_copy",
             "record_stream", "set_", "resize_",
             "_has_compatible_shallow_copy_type", "is_nonzero",
             "equal", "empty_like", "zeros_like", "ones_like", "full_like",
             "new_empty", "new_empty_strided", "new_zeros", "new_ones",
             "new_full", "empty_strided", "rand_like", "randn_like"}
#: in-place writes of an update into a slice of a larger buffer: op ->
#: index of the update among the positional arguments
_UPDATE_OPS = {"index_copy_": 3, "index_put_": 2, "_index_put_impl_": 2,
               "scatter_": 3, "scatter_add_": 3, "scatter_reduce_": 3,
               "index_add_": 3, "masked_scatter_": 2}
#: reads of a set of rows: charged by the rows read and written
_GATHER_OPS = {"index", "index_select", "gather", "embedding",
               "take_along_dim"}


def _tensors(items) -> List[torch.Tensor]:
    """The tensors among an op's arguments or results (a tensor, or a
    sequence of tensors, lists of tensors and other values)."""
    if isinstance(items, torch.Tensor):
        return [items]
    if not isinstance(items, (list, tuple, type({}.values()))):
        return []
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


@functools.lru_cache(maxsize=None)
def _counted_name(func):
    """The op's name, or None for an op that moves no bytes: a metadata
    op, or a view (its results alias an input and are not written)."""
    name = func.overloadpacket.__name__
    if name in _FREE_OPS:
        return None
    aliased = [r.alias_info for r in func._schema.returns
               if r.alias_info is not None]
    if aliased and not any(a.is_write for a in aliased):
        return None
    return name


@functools.lru_cache(maxsize=None)
def _pure(func) -> bool:
    """Whether an op's results are fresh tensors that depend on its inputs'
    metadata alone (on the meta device): no argument written, no result
    aliased."""
    schema = func._schema
    return (not any(a.alias_info is not None for a in schema.arguments)
            and not any(r.alias_info is not None for r in schema.returns))


def _meta_key(x):
    """The metadata of a meta op's argument that its meta results depend
    on: a tensor's shape, strides and dtype; other values as they are."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    return x


def _first(tensors):
    return tensors[0]


def view_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` as the view it is: a dim of stride 0 (a broadcast)
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _dot_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm", "mv", "dot"):
        a = args[0]
    elif name in ("addmm", "baddbmm", "addmv"):
        a = args[1]
    elif name == "linear":
        return 2.0 * out.numel() * args[1].shape[-1]
    else:                                            # convolution
        w, transposed = args[1], args[6]
        per = w.shape[1] * math.prod(w.shape[2:])
        return 2.0 * (args[0].numel() if transposed else out.numel()) * per
    if name == "dot":
        return 2.0 * a.numel()
    return 2.0 * out.numel() * a.shape[-1]


@dataclass
class RooflineReport:
    """The counted work of a step: dot FLOPs and HBM bytes outside the
    kernels plus every kernel launch's charge, the JAX report's fields
    (``collective_*``: a sharded step's collectives, ROADMAP §1 item 8d),
    and per kernel its launches, operations and bytes."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    dots: int = 0
    #: operations (dot FLOPs and kernel operations) by dtype name
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    #: kernel name -> {"launches", "operations", "bytes"}
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def kernel_flops(self) -> float:
        return sum(k["operations"] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> float:
        return sum(k["bytes"] for k in self.kernels.values())

    def add_flops(self, n: float, dtype) -> None:
        key = str(dtype).replace("torch.", "")
        self.flops += n
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + n

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def terms(self) -> Dict[str, float]:
        """Seconds at one H100's peaks; ``collective_s`` the collective
        bytes at :data:`ICI_BW` (0 for a step on one card)."""
        compute = sum(n / cost.peak_ops(getattr(torch, dt))
                      for dt, n in self.flops_by_dtype.items())
        return {"compute_s": compute,
                "memory_s": self.hbm_bytes / cost.HBM_BW,
                "collective_s": self.total_collective_bytes / ICI_BW}

    def dominant(self) -> str:
        t = self.terms()
        return max(t, key=t.get)

    def roofline_s(self) -> float:
        """The least time the counted work could take: its dominant
        term."""
        return max(self.terms().values())

    def to_json(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_count": dict(self.collective_count),
            "terms": self.terms(), "dominant": self.dominant(),
            "dots": self.dots, "flops_by_dtype": dict(self.flops_by_dtype),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


class Counter(TorchDispatchMode):
    """Counts the ops a step dispatches (see the module docstring) into
    :attr:`report`, logs each op's bytes by (op, input shapes) in
    :attr:`ops`, and tracks the peak of the bytes the step allocates
    (:attr:`peak_bytes`). Entered, it is also ``kernels/cost.COUNTER``, so
    every kernel wrapper charges its launches to it."""

    def __init__(self):
        super().__init__()
        self.report = RooflineReport()
        #: (op, input shapes) -> [bytes a call, calls]
        self.ops: Dict[Tuple, List[float]] = {}
        self.depth = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._memo: Dict[Tuple, Tuple] = {}
        self._outer = None

    def __enter__(self):
        self._outer, cost.COUNTER = cost.COUNTER, self
        return super().__enter__()

    def __exit__(self, *exc):
        cost.COUNTER = self._outer
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel(self, name: str, price):
        """A kernel launch: charged ``price()`` = (bytes, operations,
        dtype), with the ops inside not counted (a launch inside another
        is the outer one's)."""
        self.depth += 1
        try:
            if self.depth == 1:
                n_bytes, n_ops, dtype = price()
                k = self.report.kernels.setdefault(
                    name, {"launches": 0, "operations": 0.0, "bytes": 0.0})
                k["launches"] += 1
                k["operations"] += n_ops
                k["bytes"] += n_bytes
                self.report.add_flops(n_ops, dtype)
                self.report.hbm_bytes += n_bytes
            yield
        finally:
            self.depth -= 1

    @contextlib.contextmanager
    def collective(self, kind: str, traffic: float, io_bytes: float):
        """A collective of type ``kind`` (``all-reduce``, ``all-gather``,
        ``reduce-scatter``): ``traffic`` bytes charged to it and its input
        and output bytes to the HBM, the ops inside it not counted."""
        self.depth += 1
        try:
            if self.depth == 1:
                rep = self.report
                rep.collective_bytes[kind] = (
                    rep.collective_bytes.get(kind, 0.0) + traffic)
                rep.collective_count[kind] = (
                    rep.collective_count.get(kind, 0) + 1)
                rep.hbm_bytes += io_bytes
            yield
        finally:
            self.depth -= 1

    # -- memory ---------------------------------------------------------
    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def _track(self, ins, outs, fresh: bool) -> None:
        """Count the outputs' new storages until they die (``fresh``: no
        output can share an input's storage)."""
        seen = () if fresh else {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)

    # -- counting -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(kwargs.values())
        key = None
        if ins and _pure(func) and all(t.is_meta for t in ins):
            key = (func, _meta_key(args),
                   tuple((k, _meta_key(v)) for k, v in kwargs.items()))
            made = self._memo.get(key)
            if made is not None:
                pack, metas, counted = made
                outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                        for shape, stride, dtype in metas]
                self._track(ins, outs, True)
                if counted is not None and not self.depth:
                    self._add(*counted)
                return pack(outs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._track(ins, outs, key is not None)
        # no inputs: a factory, free
        name = _counted_name(func) if outs and ins else None
        counted = None if name is None else _measure(name, args, ins, outs)
        if counted is not None and not self.depth:
            self._add(*counted)
        if key is not None:
            self._remember(key, out, counted)
        return out

    def _remember(self, key, out, counted) -> None:
        """Keep a pure op's meta results and its count for the next call
        on the same metadata."""
        if isinstance(out, torch.Tensor):
            outs, pack = (out,), _first
        elif isinstance(out, tuple) and out and all(
                isinstance(t, torch.Tensor) for t in out):
            outs, pack = out, tuple
        else:
            return
        if all(t.is_meta for t in outs):
            self._memo[key] = (pack, tuple(
                (tuple(t.shape), t.stride(), t.dtype) for t in outs), counted)

    def _add(self, log_key, n_bytes, flops, dtype) -> None:
        if flops is not None:
            self.report.add_flops(flops, dtype)
            self.report.dots += 1
        self.report.hbm_bytes += n_bytes
        row = self.ops.setdefault(log_key, [n_bytes, 0])
        row[1] += 1


def _measure(name, args, ins, outs):
    """An op's count: (its log key (op, input shapes), bytes, dot FLOPs or
    None, their dtype)."""
    flops = dtype = None
    if name in _DOT_OPS:
        flops, dtype = _dot_flops(name, args, outs[0]), outs[0].dtype
    if name == "copy_":
        n = view_bytes(args[0]) + view_bytes(args[1])
    elif name in ("zero_", "fill_"):
        n = view_bytes(args[0])
    elif name in _UPDATE_OPS:
        at = _UPDATE_OPS[name]
        upd = args[at] if at < len(args) else None
        if isinstance(upd, torch.Tensor):
            idx = sum(view_bytes(t) for t in ins
                      if t is not args[0] and t is not upd)
            n = 2 * view_bytes(upd) + idx
        else:
            n = sum(view_bytes(t) for t in ins) + view_bytes(outs[0])
    elif name in _GATHER_OPS:
        idx = sum(view_bytes(t) for t in ins[1:]
                  if not t.is_floating_point())
        n = 2 * sum(view_bytes(t) for t in outs) + idx
    else:
        n = sum(view_bytes(t) for t in ins) + sum(view_bytes(t) for t in outs)
    return (name, tuple(tuple(t.shape) for t in ins)), n, flops, dtype


def analyze(fn, *args, **kwargs) -> RooflineReport:
    """Run ``fn(*args, **kwargs)`` under a :class:`Counter` and return its
    report (the counterpart of the JAX ``analyze_hlo``)."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.report
