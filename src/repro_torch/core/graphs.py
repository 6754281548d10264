"""CUDA graphs of the engine's steps: the port's counterpart of the JAX
package's jitted steps, "compiled once, reused — §3.4.2 pre-configured
states" (``src/repro/core/engine.py:80-100``, ``_decode_iteration``; the
fused step and the paged prefill group at ``:125-162``; the sub-mesh pairs
at ``:628-631``), where the port otherwise runs every op eagerly, one
Python launch each.

:class:`StepGraphs` keeps one ``torch.cuda.CUDAGraph`` per static shape key
of a step (the engine's serial decode ``("paged", n_b)`` per table bucket
and ``("dense",)``, the fused cycle's segments and the paged prefill
groups, see ``core/engine.py``; :class:`GraphedDecode`'s ``("rg", B,
long_context)``).
Each entry owns its static inputs, its outputs and the kernel launches its
capture recorded; all entries share one memory pool, which is safe because
every replay runs on the caller's stream, one after another. An input the
caller registered with :meth:`StepGraphs.keep` (a persistent buffer it
stages its inputs in, or an activation buffer a step updates in place) is
captured as it is: the graph reads and writes that buffer, and a replay
copies nothing into it. Any other input is cloned into a static buffer at
capture and copied into it before each replay. A step that writes its
result into a kept buffer keeps no output of its own in the pool, so the
pool holds about one step's intermediates, whatever the number of graphs.

On a miss the step runs once, eagerly, on the side stream the capture will
use, and that run is the call's result: it builds the kernel library,
fills the cached occupancy queries and creates the split decode's and the
fused launch's per-stream workspaces before capture, so none of them
comes from the graph's pool. It is the only eager run: a second would
advance a recurrent state (Mamba-2, RG-LRU) or an activation buffer twice.
The capture itself executes nothing, and the garbage collector is held off
while it runs (a collection could reset a dropped graph mid-capture).

A replay calls no kernel wrapper, so each entry adds to the wrappers'
launch counters exactly what its capture's calls added to them, and the
counters read the same as an eager run's. CPU tensors never reach a graph:
the step runs eagerly, as every kernel wrapper dispatches by device.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, Hashable, List, NamedTuple, Tuple

import torch

from repro_torch.kernels import bullet_attention as _BA
from repro_torch.kernels import decode_attention as _DA
from repro_torch.kernels import flash_attention as _FA
from repro_torch.kernels import paged_decode_attention as _PD
from repro_torch.kernels import rglru_scan as _RK
from repro_torch.kernels import ssd_scan as _SK
from repro_torch.models import transformer as T

#: every kernel wrapper's launch counter, (module, attribute)
COUNTERS = ((_FA, "launches"), (_PD, "launches"), (_DA, "launches"),
            (_BA, "launches"), (_BA, "dense_launches"), (_SK, "launches"),
            (_RK, "launches"), (_FA, "bwd_launches"), (_SK, "bwd_launches"),
            (_RK, "bwd_launches"))


def launch_counts() -> Tuple[int, ...]:
    """The wrappers' launch counters, in ``COUNTERS`` order."""
    return tuple(getattr(m, a) for m, a in COUNTERS)


def _set_counts(values) -> None:
    for (m, a), v in zip(COUNTERS, values):
        setattr(m, a, v)


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    output: object
    #: (module, counter, launches) of every counter the capture moved
    bumps: Tuple[Tuple[object, str, int], ...]


class StepGraphs:
    """A cache of CUDA graphs of one step function, by static shape key."""

    def __init__(self):
        self._entries: Dict[Hashable, _Entry] = {}
        self._pool = None
        self._stream = None
        #: the buffers registered by ``keep``, by id (weakly: a buffer the
        #: caller drops leaves the registry with it)
        self._kept = weakref.WeakValueDictionary()
        #: (key, capture seconds) of every capture, in order (drops kept)
        self.captures: List[Tuple[Hashable, float]] = []
        #: graphs released by ``drop`` so far
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._entries)

    def keep(self, *buffers: torch.Tensor) -> None:
        """Register persistent buffers: a graph captures such an input as
        it is, and a replay given the same buffer copies nothing."""
        for b in buffers:
            self._kept[id(b)] = b

    def static_inputs(self, inputs) -> Tuple[torch.Tensor, ...]:
        """The static buffers a capture reads: each kept input itself, a
        clone of any other."""
        return tuple(x if self._kept.get(id(x)) is x else x.clone()
                     for x in inputs)

    @staticmethod
    def stage(static, inputs) -> int:
        """Copy each input into its static buffer unless it is that buffer;
        returns the number of copies."""
        n = 0
        for buf, x in zip(static, inputs):
            if buf is not x:
                buf.copy_(x)
                n += 1
        return n

    def __call__(self, key: Hashable, fn: Callable, *inputs: torch.Tensor):
        """``fn(*inputs)`` (a tensor or a tuple of tensors): eagerly for
        CPU tensors, else through the graph captured for ``key``. The
        result of a replay is the entry's static output: read it before
        the next replay, of this key or of any other (the pool is shared,
        so a graph captured earlier may reuse its memory). A kept buffer
        the step writes in place is the caller's own, and must be passed
        on every call of the key (the graph writes the buffer it was
        captured with)."""
        if inputs[0].device.type != "cuda":
            return fn(*inputs)
        e = self._entries.get(key)
        if e is None:
            return self._capture(key, fn, inputs)
        self.stage(e.inputs, inputs)
        e.graph.replay()
        for m, a, d in e.bumps:
            setattr(m, a, getattr(m, a) + d)
        return e.output

    def _capture(self, key, fn, inputs):
        dev = inputs[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        caller, side = torch.cuda.current_stream(dev), self._stream
        static = self.static_inputs(inputs)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            out = fn(*inputs)
        t0 = time.perf_counter()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # not torch.cuda.graph(): its context synchronizes the device,
        # collects garbage and empties the allocator's cache at every
        # capture, none of which a capture on a stream that waits for the
        # caller needs (the eager steps would then allocate anew). The
        # collector is held off instead: a collection during the capture
        # would finalize the graphs of servers dropped in reference
        # cycles, and a graph's reset is not permitted while a stream
        # captures (it invalidates the capture)
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool)
                try:
                    static_out = fn(*static)
                finally:
                    graph.capture_end()
        finally:
            if gc_was_on:
                gc.enable()
        after = launch_counts()
        _set_counts(before)
        caller.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(caller)
        self._entries[key] = _Entry(graph, static, static_out, tuple(
            (m, a, y - x) for (m, a), x, y in zip(COUNTERS, before, after)
            if y != x))
        self.captures.append((key, time.perf_counter() - t0))
        return out

    def pool_bytes(self):
        """Bytes the caching allocator holds in the graphs' shared pool:
        its segments, which only grow while the graphs live, so this is
        the pool's peak. None where the allocator's snapshot does not name
        a segment's pool."""
        if self._pool is None:
            return 0
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == tuple(self._pool))

    def drop(self) -> None:
        """Release every graph, the pool they share (the caching allocator
        returns the pool's memory at its next ``empty_cache``) and the
        capture stream, so the next capture may be on another card."""
        for e in self._entries.values():
            e.graph.reset()
        self.dropped += len(self._entries)
        self._entries.clear()
        self._pool = None
        self._stream = None


class GraphedDecode:
    """``transformer.decode_step``'s logits over a dense slot cache,
    through :class:`StepGraphs` keyed by the batch: the models-level
    decode that RecurrentGemma runs (both engines refuse its
    ``pattern_tail``), and SeamlessM4T (cross-attention, its cross
    cache's position map made on the device inside the step) and
    InternVL2, and any dense cache after a chunked or long-context
    prefill, built from ``(params, cache, cfg)`` and called with
    ``(tokens (B, 1) int32, pos (B,) int32)``. ``long_context`` (the
    cache's, :func:`transformer.init_cache`) reaches ``decode_step`` and
    the graph key, ``("rg", B, long_context)``. The cache is updated in
    place; on the card the logits are the graph's static output, valid
    until the next call with the same B."""

    def __init__(self, params, cache, cfg, *, long_context: bool = False):
        self.params, self.cache, self.cfg = params, cache, cfg
        self.long_context = long_context
        self.graphs = StepGraphs()

    def _step(self, tokens, pos):
        return T.decode_step(self.params, self.cache, tokens, pos, self.cfg,
                             long_context=self.long_context)[0]

    def __call__(self, tokens, pos):
        return self.graphs(("rg", tokens.shape[0], self.long_context),
                           self._step, tokens, pos)
