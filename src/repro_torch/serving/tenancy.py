"""Multi-tenant admission: identity, rate limits, and credit scores.

Production traffic is not a flat request stream — it is 10^4-10^5 users
behind a handful of apps with wildly different abuse profiles, and one
greedy tenant can starve everyone's TTFT while the engine dutifully
co-locates phases. This module adds the tenant layer above
``OnlineFrontend`` (docs/MULTITENANCY.md):

- **Identity** — :class:`App` / :class:`User`, threaded through
  ``Request`` (``user_id`` / ``app_id`` / ``session_id`` /
  ``turn_index``) and ``workload.Interaction``, with
  :func:`generate_tenant_interactions` producing Zipf-skewed per-app
  traffic over a 10^4-10^5-user id space.
- **Interaction-aware throttling (the OIT rule)** — per-tenant
  sliding-window rate limits that only ever reject *new* interactions
  (``turn_index == 0``); a mid-conversation turn is never throttled,
  so an in-flight session's later turns (which carry shared-prefix KV
  pages, docs/KV_SHARING.md) are never shed after their pages are
  resident. Under KV-pool pressure new interactions defer (bounded
  retries) instead of entering a pool that would immediately preempt.
- **Credit** — a scalar per-tenant score recomputed from that tenant's
  SLO-violation and tail-latency history. Credit biases admission
  order (a stable tier sort layered over the scheduler's slack sort in
  ``SLOScheduler.reorder_pending``) and preemption-victim choice
  (``BulletServer._preempt_for`` picks the youngest request *within
  the lowest-credit tenant* instead of the globally youngest).

The controller is a seam like ``obs``/``faults``/``guard``: pass it via
``ServerConfig(tenancy=...)``; ``None`` (the default) keeps every code
path byte-identical to the tenancy-free engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from collections import deque

import numpy as np

from repro_torch.serving.request import Phase, Request, SLO
from repro_torch.serving.workload import Interaction, Turn

#: gate() verdicts
ADMIT = "admit"
DEFER = "defer"
THROTTLE = "throttle"


@dataclass(frozen=True)
class App:
    """One tenant: an application a population of users sits behind."""
    app_id: int
    name: str = ""
    #: sliding-window budget of *new interactions* per window; 0 = use
    #: the controller default, < 0 = unlimited
    rate_limit: int = 0
    #: fraction of the user population assigned to this app (set by
    #: :func:`make_apps` from the Zipf share; informational)
    user_share: float = 0.0


@dataclass(frozen=True)
class User:
    """One end user, pinned to an app."""
    user_id: int
    app_id: int


@dataclass(frozen=True)
class TenancyConfig:
    """Knobs for :class:`TenancyController` (docs/MULTITENANCY.md)."""
    #: sliding rate-limit window (trace seconds)
    window_s: float = 1.0
    #: default per-app new-interaction budget per window; <= 0 = unlimited
    rate_limit: int = 0
    #: credit-biased admission order + preemption-victim choice
    credit: bool = True
    #: pool-occupancy fraction above which new interactions defer
    kv_pressure: float = 0.9
    #: retry delay for pressure-deferred new interactions (trace seconds)
    defer_s: float = 0.05
    #: deferral budget before a pressured new interaction is throttled
    max_defers: int = 8
    #: EWMA weight for the SLO-violation / tail-latency history
    ewma: float = 0.25
    #: credit = clip(1 - w_viol*viol_ewma - w_tail*tail_ewma, 0, 1)
    w_viol: float = 0.7
    w_tail: float = 0.3
    #: credit quantization levels for the stable admission tier sort
    #: (coarse on purpose: tiny credit noise must not thrash the
    #: scheduler's slack order)
    tiers: int = 4


@dataclass
class TenantStats:
    """Per-app counters (mirrored into the obs registry when enabled)."""
    submitted: int = 0
    admitted: int = 0
    deferred: int = 0
    throttled: int = 0
    finished: int = 0
    slo_met: int = 0
    violations: int = 0
    cancelled: int = 0

    @property
    def goodput(self) -> int:
        """Requests that finished meeting both SLOs (the fairness unit)."""
        return self.slo_met


@dataclass
class _CreditState:
    viol_ewma: float = 0.0
    tail_ewma: float = 0.0


class TenancyController:
    """Per-tenant admission policy: OIT throttling + credit scoring.

    Attach via ``ServerConfig(tenancy=controller)``; the engine calls
    :meth:`attach` at construction and the frontend consults
    :meth:`gate` in ``_try_submit`` before the SLOGuard. All state is
    plain Python driven by trace time, so virtual-clock replays are
    deterministic.
    """

    enabled = True

    def __init__(self, apps: Optional[List[App]] = None,
                 cfg: Optional[TenancyConfig] = None):
        self.cfg = cfg or TenancyConfig()
        self.apps: Dict[int, App] = {a.app_id: a for a in (apps or [])}
        self.stats: Dict[int, TenantStats] = {}
        self._credit: Dict[int, _CreditState] = {}
        #: admission timestamps of new interactions, per app (sliding
        #: window; pruned against ``window_s`` on every gate call)
        self._window: Dict[int, Deque[float]] = {}
        #: rid -> app_id for requests the engine has seen (fed by
        #: ``BulletServer.submit`` so the scheduler priority hook and
        #: the preemption bias can resolve pending/running rids)
        self._rid_app: Dict[int, int] = {}
        #: every throttle decision: (rid, app_id, turn_index, why) —
        #: the OIT audit trail (tests + fairness benchmark assert no
        #: entry ever has turn_index > 0)
        self.throttle_log: List[Tuple[int, int, int, str]] = []
        self._server = None
        self._obs_admitted = None
        self._obs_throttled = None
        self._obs_violations = None
        self._obs_goodput = None
        self._obs_credit = None

    # -- wiring ---------------------------------------------------------
    def attach(self, server) -> None:
        """Called by ``BulletServer.__init__``; resolves the obs handles."""
        self._server = server
        obs = getattr(server, "obs", None)
        if obs is not None and getattr(obs, "enabled", False):
            r = obs.registry
            self._obs_admitted = r.counter(
                "bullet_tenant_admitted_total",
                "requests admitted past the tenant gate", labels=("app",))
            self._obs_throttled = r.counter(
                "bullet_tenant_throttled_total",
                "new interactions rejected by the tenant gate "
                "(rate limit / KV pressure; never a mid-interaction turn)",
                labels=("app",))
            self._obs_violations = r.counter(
                "bullet_tenant_slo_violations_total",
                "finished requests missing an SLO, per tenant",
                labels=("app",))
            self._obs_goodput = r.counter(
                "bullet_tenant_goodput_total",
                "finished requests meeting both SLOs, per tenant",
                labels=("app",))
            self._obs_credit = r.gauge(
                "bullet_tenant_credit",
                "current per-tenant credit score in [0, 1]",
                labels=("app",))

    @property
    def credit_enabled(self) -> bool:
        return self.cfg.credit

    def _app_of(self, req: Request) -> int:
        app_id = getattr(req, "app_id", None)
        return 0 if app_id is None else int(app_id)

    def _stats(self, app_id: int) -> TenantStats:
        s = self.stats.get(app_id)
        if s is None:
            s = self.stats[app_id] = TenantStats()
        return s

    def _label(self, app_id: int) -> str:
        app = self.apps.get(app_id)
        return app.name if app is not None and app.name else str(app_id)

    # -- credit ---------------------------------------------------------
    def credit(self, app_id: int) -> float:
        """Scalar credit in [0, 1]; 1.0 until history says otherwise."""
        st = self._credit.get(app_id)
        if st is None:
            return 1.0
        c = 1.0 - self.cfg.w_viol * st.viol_ewma \
                - self.cfg.w_tail * st.tail_ewma
        return min(1.0, max(0.0, c))

    def credit_of(self, req: Request) -> float:
        return self.credit(self._app_of(req))

    def tier(self, rid: int) -> int:
        """Quantized credit of the tenant behind ``rid`` (the scheduler's
        admission-priority hook: higher tier admits earlier; unknown
        rids get the top tier, i.e. no bias)."""
        app_id = self._rid_app.get(rid)
        if app_id is None:
            return self.cfg.tiers - 1
        return min(self.cfg.tiers - 1,
                   int(self.credit(app_id) * self.cfg.tiers))

    # -- admission gate (the frontend calls this in _try_submit) --------
    def gate(self, req: Request, now: float, tries: int = 0) -> str:
        """ADMIT / DEFER / THROTTLE for one release-ready request.

        The OIT rule: only a *new* interaction (``turn_index == 0``) can
        be deferred or throttled — a mid-conversation turn always
        admits, whatever the window or the pool says."""
        app_id = self._app_of(req)
        st = self._stats(app_id)
        if tries == 0:
            st.submitted += 1
        if getattr(req, "turn_index", 0) > 0:
            return self._admit(req, app_id, now)
        limit = self._limit(app_id)
        if limit is not None:
            win = self._window.setdefault(app_id, deque())
            while win and win[0] <= now - self.cfg.window_s:
                win.popleft()
            if len(win) >= limit:
                return self._throttle(req, app_id, now, "rate_limit")
        if self._kv_pressured():
            if tries >= self.cfg.max_defers:
                return self._throttle(req, app_id, now, "kv_pressure")
            st.deferred += 1
            return DEFER
        return self._admit(req, app_id, now, count_window=limit is not None)

    def _limit(self, app_id: int) -> Optional[int]:
        app = self.apps.get(app_id)
        limit = self.cfg.rate_limit
        if app is not None and app.rate_limit != 0:
            limit = app.rate_limit
        return limit if limit > 0 else None

    def _kv_pressured(self) -> bool:
        pool = getattr(self._server, "pool", None)
        if pool is None or pool.n_blocks <= 0:
            return False
        used = 1.0 - pool.available_blocks / pool.n_blocks
        return used >= self.cfg.kv_pressure

    def _admit(self, req: Request, app_id: int, now: float,
               count_window: bool = False) -> str:
        if count_window:
            self._window.setdefault(app_id, deque()).append(now)
        self._stats(app_id).admitted += 1
        if self._obs_admitted is not None:
            self._obs_admitted.labels(app=self._label(app_id)).inc()
        return ADMIT

    def _throttle(self, req: Request, app_id: int, now: float,
                  why: str) -> str:
        self._stats(app_id).throttled += 1
        self.throttle_log.append(
            (req.rid, app_id, getattr(req, "turn_index", 0), why))
        if self._obs_throttled is not None:
            self._obs_throttled.labels(app=self._label(app_id)).inc()
        return THROTTLE

    # -- engine callbacks -----------------------------------------------
    def track(self, req: Request) -> None:
        """``BulletServer.submit`` registers every engine-side request so
        rid-keyed hooks (scheduler tier, preemption bias) resolve."""
        self._rid_app[req.rid] = self._app_of(req)

    def on_finish(self, req: Request, slo: SLO) -> None:
        """Recompute the tenant's credit from this request's outcome."""
        app_id = self._rid_app.get(req.rid, self._app_of(req))
        st = self._stats(app_id)
        st.finished += 1
        met = req.meets_slo(slo)
        a = self.cfg.ewma
        cs = self._credit.setdefault(app_id, _CreditState())
        cs.viol_ewma = (1 - a) * cs.viol_ewma + a * (0.0 if met else 1.0)
        nt = req.norm_ttft_ms
        excess = 0.0
        if nt is not None and slo.norm_ttft_ms > 0:
            excess = min(1.0, max(0.0, nt / slo.norm_ttft_ms - 1.0))
        cs.tail_ewma = (1 - a) * cs.tail_ewma + a * excess
        if met:
            st.slo_met += 1
            if self._obs_goodput is not None:
                self._obs_goodput.labels(app=self._label(app_id)).inc()
        else:
            st.violations += 1
            if self._obs_violations is not None:
                self._obs_violations.labels(app=self._label(app_id)).inc()
        if self._obs_credit is not None:
            self._obs_credit.labels(app=self._label(app_id)).set(
                self.credit(app_id))

    def on_cancel(self, req: Request, why: str) -> None:
        app_id = self._rid_app.get(req.rid, self._app_of(req))
        self._stats(app_id).cancelled += 1

    # -- reporting -------------------------------------------------------
    def per_tenant_goodput(self) -> Dict[int, int]:
        return {a: s.goodput for a, s in sorted(self.stats.items())}

    def check_oit(self) -> None:
        """Assert the OIT invariant: no throttle ever hit a
        mid-interaction turn."""
        bad = [e for e in self.throttle_log if e[2] > 0]
        assert not bad, f"mid-interaction turns throttled: {bad}"


# ---------------------------------------------------------------------------
# Multi-tenant workload generation (Zipf-skewed per-app traffic)
# ---------------------------------------------------------------------------

def zipf_shares(n: int, a: float = 1.1) -> np.ndarray:
    """Normalized Zipf popularity over ``n`` ranks: share_i ~ (i+1)^-a."""
    w = (np.arange(n, dtype=np.float64) + 1.0) ** -a
    return w / w.sum()


def make_apps(n_apps: int, *, rate_limit: int = 0,
              zipf_a: float = 1.1) -> List[App]:
    """``n_apps`` tenants with Zipf-skewed user shares; app 0 is the
    heavy hitter."""
    shares = zipf_shares(n_apps, zipf_a)
    return [App(app_id=i, name=f"app{i}", rate_limit=rate_limit,
                user_share=float(shares[i])) for i in range(n_apps)]


def generate_tenant_interactions(
        apps: List[App], n_sessions: int, rate_s: float, *,
        n_users: int = 50_000, zipf_a: float = 1.1,
        turns: int = 3, new_tokens: int = 12, output_tokens: int = 6,
        think_time_s: float = 0.0, seed: int = 0,
        rate_skew: Optional[Dict[int, float]] = None) -> List[Interaction]:
    """Zipf-skewed multi-tenant session trace, deterministic in ``seed``.

    Sessions arrive Poisson at ``rate_s`` overall; each is assigned an
    app by Zipf popularity (optionally reweighted per app via
    ``rate_skew``, e.g. ``{0: 20.0}`` to model one flooding tenant) and
    a user drawn from the app's slice of a ``n_users``-wide id space
    (10^4-10^5-user scale by default). Turn shapes jitter around the
    means exactly like ``generate_interactions``.
    """
    assert apps, "need at least one App"
    rng = np.random.default_rng(seed)
    p = zipf_shares(len(apps), zipf_a)
    if rate_skew:
        p = p.copy()
        for i, boost in rate_skew.items():
            p[i] *= boost
        p = p / p.sum()
    # partition the user-id space across apps by popularity share (at
    # least one user each)
    counts = np.maximum(1, (p * n_users).astype(np.int64))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out: List[Interaction] = []
    t = 0.0
    for sid in range(n_sessions):
        t += rng.exponential(1.0 / rate_s)
        ai = int(rng.choice(len(apps), p=p))
        uid = int(starts[ai] + rng.integers(0, counts[ai]))
        n_turns = max(1, int(rng.integers(max(1, turns // 2), turns + 1)))
        ts = []
        for _ in range(n_turns):
            nt = max(2, int(rng.integers(max(2, new_tokens // 2),
                                         new_tokens + new_tokens // 2 + 1)))
            ot = max(2, int(rng.integers(max(2, output_tokens // 2),
                                         output_tokens + output_tokens // 2
                                         + 1)))
            ts.append(Turn(nt, ot, think_time_s))
        out.append(Interaction(session_id=sid, arrival=t, turns=tuple(ts),
                               user_id=uid, app_id=apps[ai].app_id))
    return out


def generate_fleet_interactions(
        n_requests: int, rate_req_s: float, *, n_apps: int = 8,
        n_users: int = 50_000, turns: int = 4, new_tokens: int = 48,
        output_tokens: int = 32, think_time_s: float = 2.0,
        zipf_a: float = 1.1, seed: int = 0) -> List[Interaction]:
    """A fleet-sized multi-tenant closed-loop trace: at least
    ``n_requests`` total turns across Zipf-skewed apps, arriving at
    ``rate_req_s`` requests/second overall (session arrivals are scaled by
    the mean turns-per-session so the *turn* rate matches). This is the
    capacity-planning workload (docs/SIMULATOR.md): day-long
    million-request traces are just larger ``n_requests`` / smaller
    ``rate_req_s`` — the simulator's cost scales with event count, not
    trace duration. Deterministic in ``seed``.
    """
    apps = make_apps(n_apps, zipf_a=zipf_a)
    # E[turns/session] for integers(turns//2, turns+1)
    mean_turns = (max(1, turns // 2) + turns) / 2.0
    sessions = generate_tenant_interactions(
        apps, int(np.ceil(n_requests / mean_turns * 1.05)),
        rate_req_s / mean_turns, n_users=n_users, zipf_a=zipf_a,
        turns=turns, new_tokens=new_tokens, output_tokens=output_tokens,
        think_time_s=think_time_s, seed=seed)
    out: List[Interaction] = []
    total = 0
    for it in sessions:
        out.append(it)
        total += len(it.turns)
        if total >= n_requests:
            break
    return out


# ---------------------------------------------------------------------------
# Fairness metrics
# ---------------------------------------------------------------------------

def jain_index(values) -> float:
    """Jain's fairness index over per-tenant allocations: 1 = perfectly
    even, 1/n = one tenant has everything. Empty/zero input -> 1.0."""
    xs = [float(v) for v in values]
    if not xs or all(x == 0 for x in xs):
        return 1.0
    s, sq = sum(xs), sum(x * x for x in xs)
    return (s * s) / (len(xs) * sq)


def per_tenant_outcomes(requests, slo: SLO) -> Dict[int, TenantStats]:
    """Group a replay's requests by ``app_id`` into TenantStats (for
    runs without a controller, e.g. the FIFO baseline)."""
    out: Dict[int, TenantStats] = {}
    for r in requests:
        app_id = getattr(r, "app_id", None) or 0
        st = out.setdefault(app_id, TenantStats())
        st.submitted += 1
        if r.phase == Phase.FINISHED:
            st.finished += 1
            if r.meets_slo(slo):
                st.slo_met += 1
            else:
                st.violations += 1
        elif r.phase == Phase.CANCELLED:
            st.cancelled += 1
            if r.cancel_reason == "throttled":
                st.throttled += 1
    return out
