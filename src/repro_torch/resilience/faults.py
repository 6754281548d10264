"""Deterministic fault injection for the serving stack (docs/RESILIENCE.md).

A :class:`FaultPlan` is a declarative, JSON-serializable list of
:class:`FaultSpec` entries addressed by *engine cycle index* — the same
virtual-clock cycle counter that drives deterministic replay — so a plan
replayed twice injects byte-identical failures. The :class:`FaultInjector`
interprets the plan behind narrow seams in ``core/engine.py``,
``kvcache/paged.py`` and ``launch/submesh.py``:

- ``straggler`` / ``drift`` — multiply the cycle's *measured* duration
  (the value the frontend feeds ``record_cycle_actual``) by ``factor``.
  Stragglers are transient (``p`` < 1 picks cycles with a seeded rng);
  drift is the sustained regime where the machine has moved away from
  the estimator's fitted parameters — exactly the divergence the
  OnlineRefitter and the SLO guard exist to detect.
- ``dispatch`` — raise :class:`DispatchError` before an executable
  dispatch of kind ``target`` (``fused`` / ``prefill`` / ``decode`` /
  ``chip_prefill`` / ``chip_decode`` / ``any``), at most ``count`` times.
- ``handoff`` — fail (or, with ``delay_s`` and ``factor<=1``, merely
  delay) a cross-mesh ``transfer_pages`` handoff by raising
  :class:`HandoffError` through the ``fault`` hook the engine passes in.
- ``pool_squeeze`` — allocate ``blocks`` pool blocks to a *phantom*
  request for the window, shrinking usable KV capacity and forcing the
  admission path into preemption storms. Phantom rids are negative and
  reported via :meth:`FaultInjector.phantom_rids` so the engine's
  invariant checker can account for them.

Production installs no injector: every seam is gated on
``faults.enabled`` (the :data:`NULL_FAULTS` singleton, mirroring
``obs.NULL_OBS``), so the happy path pays one attribute check.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

#: executable-dispatch kinds the engine reports through the seam
DISPATCH_KINDS = ("fused", "prefill", "decode", "chip_prefill",
                  "chip_decode")

#: fault kinds a FaultSpec may carry
FAULT_KINDS = ("straggler", "drift", "dispatch", "handoff", "pool_squeeze")

#: phantom rids (pool_squeeze holders) count down from here — real
#: requests use non-negative rids, so the ranges can never collide
PHANTOM_RID_BASE = -1000


class DispatchError(RuntimeError):
    """An executable dispatch failed (injected, or a real runtime error a
    hardware backend surfaces). ``kind`` names the dispatch site."""

    def __init__(self, msg: str, kind: str = "any"):
        super().__init__(msg)
        self.kind = kind


class HandoffError(RuntimeError):
    """A cross-mesh ``transfer_pages`` KV handoff failed. Transient by
    contract: the engine retries with backoff (launch/submesh.py's
    HandoffPolicy) before aborting the prefill task and degrading."""


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault. ``start``/``end`` bound the engine-cycle window
    (half-open); see the module docstring for per-kind field semantics."""

    kind: str
    start: int = 0
    end: int = 1 << 30
    factor: float = 1.0           # straggler/drift stretch on actuals
    target: str = "any"           # dispatch kind to fail
    count: int = 1 << 30          # max events to fire (dispatch/handoff)
    blocks: int = 0               # pool_squeeze size in pool blocks
    delay_s: float = 0.0          # handoff: extra seconds instead of failure
    p: float = 1.0                # per-cycle firing probability (seeded)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"want one of {FAULT_KINDS}")
        if self.target != "any" and self.target not in DISPATCH_KINDS:
            raise ValueError(f"unknown dispatch target {self.target!r}")

    def active(self, cycle: int) -> bool:
        return self.start <= cycle < self.end


@dataclass
class FaultPlan:
    """A seeded list of faults — the chaos replay's reproducible script."""

    specs: List[FaultSpec] = field(default_factory=list)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "specs": [asdict(s) for s in self.specs]},
                          indent=2)

    @classmethod
    def from_json(cls, src) -> "FaultPlan":
        """Build from a dict, a JSON string, or a path to a JSON file
        (the ``--fault-plan`` CLI flag hands a path here)."""
        if isinstance(src, dict):
            obj = src
        else:
            text = str(src)
            if not text.lstrip().startswith("{"):
                with open(text) as f:
                    text = f.read()
            obj = json.loads(text)
        return cls(specs=[FaultSpec(**s) for s in obj.get("specs", [])],
                   seed=int(obj.get("seed", 0)))


class FaultInjector:
    """Interprets a :class:`FaultPlan` against the engine's cycle counter.

    Deterministic by construction: every probabilistic decision draws
    from ``default_rng([seed, spec_index, cycle])``, so two replays of
    the same plan on the same trace perturb identically. ``injected``
    counts fired events per kind for tests and the chaos benchmark."""

    def __init__(self, plan: Optional[FaultPlan] = None, *,
                 enabled: bool = True):
        self.plan = plan if plan is not None else FaultPlan()
        self.enabled = enabled
        self.cycle = -1
        self._fired = [0] * len(self.plan.specs)
        #: spec index -> phantom rid currently holding squeezed blocks
        self._squeezed: Dict[int, int] = {}
        self._extra_delay_s = 0.0
        self.injected: Dict[str, int] = {}

    # -- bookkeeping -----------------------------------------------------
    def _count(self, what: str) -> None:
        self.injected[what] = self.injected.get(what, 0) + 1

    def _roll(self, spec_ix: int, p: float, salt: int = 0) -> bool:
        if p >= 1.0:
            return True
        rng = np.random.default_rng(
            [self.plan.seed, spec_ix, self.cycle, salt])
        return bool(rng.random() < p)

    def phantom_rids(self) -> Set[int]:
        """Rids of the pool-squeeze phantom allocations currently held —
        the engine invariant checker treats them as live owners."""
        return set(self._squeezed.values())

    # -- engine seams ----------------------------------------------------
    def begin_cycle(self, server) -> None:
        """Called once at the top of every engine step: advance the cycle
        counter and apply/release pool squeezes as their windows open and
        close. Squeezes allocate through the normal pool API (as a
        phantom request), so the allocator's own invariants keep holding."""
        self.cycle += 1
        for i, s in enumerate(self.plan.specs):
            if s.kind != "pool_squeeze":
                continue
            held = i in self._squeezed
            if s.active(self.cycle):
                pool = server.pool
                rid = PHANTOM_RID_BASE - i
                have = (len(pool.table(rid).blocks) if held else 0)
                # top up every cycle while the window is open: blocks
                # freed by finishing requests are re-grabbed, so the
                # squeeze keeps real traffic at OutOfBlocks pressure
                want = min(s.blocks - have, pool.free_blocks)
                if want > 0 and not held:
                    pool.allocate(rid, want * pool.block_size)
                    self._squeezed[i] = rid
                    self._count("pool_squeeze")
                elif want > 0:
                    pool.extend(rid, want * pool.block_size)
            elif held and not s.active(self.cycle):
                server.pool.free(self._squeezed.pop(i))

    def dispatch(self, kind: str) -> None:
        """Dispatch seam: raise :class:`DispatchError` when the plan says
        this cycle's ``kind`` dispatch fails."""
        for i, s in enumerate(self.plan.specs):
            if (s.kind == "dispatch" and s.active(self.cycle)
                    and s.target in ("any", kind)
                    and self._fired[i] < s.count
                    and self._roll(i, s.p, salt=self._fired[i])):
                self._fired[i] += 1
                self._count("dispatch")
                raise DispatchError(
                    f"injected {kind} dispatch failure "
                    f"(cycle {self.cycle}, spec {i})", kind=kind)

    def handoff_hook(self):
        """The ``fault`` callable ``transfer_pages`` invokes once per
        attempted handoff: raises :class:`HandoffError` (failure) or
        accumulates ``delay_s`` into the cycle's charged duration."""
        def hook(n_blocks: int) -> None:
            del n_blocks
            for i, s in enumerate(self.plan.specs):
                if (s.kind == "handoff" and s.active(self.cycle)
                        and self._fired[i] < s.count
                        and self._roll(i, s.p, salt=self._fired[i])):
                    self._fired[i] += 1
                    if s.delay_s > 0:
                        self._extra_delay_s += s.delay_s
                        self._count("handoff_delay")
                        continue
                    self._count("handoff")
                    raise HandoffError(
                        f"injected handoff failure "
                        f"(cycle {self.cycle}, spec {i})")
        return hook

    def charge_delay(self, seconds: float) -> None:
        """Add wall time to the current cycle's measured duration (retry
        backoff, injected handoff delay)."""
        self._extra_delay_s += max(0.0, seconds)

    def perturb_cycle(self, dt: float) -> float:
        """Frontend seam: the cycle's charged duration after straggler /
        drift stretching plus any accumulated handoff or backoff delay.
        Feeds straight into ``record_cycle_actual``."""
        extra, self._extra_delay_s = self._extra_delay_s, 0.0
        f = 1.0
        for i, s in enumerate(self.plan.specs):
            if (s.kind in ("straggler", "drift") and s.active(self.cycle)
                    and self._roll(i, s.p)):
                f *= s.factor
                self._count(s.kind)
        return dt * f + extra

    def end_of_run(self, server) -> None:
        """Release any squeeze still held (a plan window outliving the
        trace must not leave the pool dirty at shutdown)."""
        for i in list(self._squeezed):
            server.pool.free(self._squeezed.pop(i))


#: the disabled default (mirrors obs.NULL_OBS): every engine seam checks
#: ``faults.enabled`` once and moves on
NULL_FAULTS = FaultInjector(enabled=False)
