"""The adaptive admission-and-batching scheduler (port of the reference's
``pipeline/sched.py``).

A static service proves fixed `batch_size` slices and sheds the newest
requests beyond its admission cap.  This controller closes the loop on
signals the service already has: the arrival rate seen in spool mtimes,
the batch cost curve, the fleet's backlog trend and burn rates.  At low
load small batches keep latency down; at high load wide batches keep
throughput up.

  AmortModel        the batch cost curve batch_s(S): measured points,
                    linear between them ("S:sec,S:sec,..." specs or a
                    points dict; the built-in curve is conservative).
  BatchController   each sweep: an EWMA arrival rate from spool mtimes,
                    shedding by predicted deadline miss (a greedy walk
                    in service order: shed exactly what the model says
                    cannot finish, never what still can), priority lanes
                    (interactive requests batch first at a small width
                    while bulk rides wide), and batch sizing against the
                    deadline or objective, clamped to [1, cap] and to
                    the backlog.
  AutoscalePolicy   the fleet's grow / shrink between workers_min and
                    workers_max from the fleet plane's merged backlog
                    trend and burn rates, with the alert engine's
                    hysteresis: a condition must hold scale_up_s /
                    scale_down_s without a break before a decision, so
                    a signal that flaps at a boundary never flaps the
                    fleet.

Everything here is pure over (clock, inputs): the service and the
supervisor own the side effects (metrics, records, spawns).  The gates
are recorded through ``utils.audit.record_arm`` (``service_sched`` and
``worker_tier``), so that an adaptive run and a static one never share an
execution digest.

Where the port differs: the reference reads its knobs from its
environment and seeds the cost curve from `tune`'s host profile; here
each knob is an argument, and ``build_controller``'s `points` stands where
the profile stood (a curve measured on this card, which seeds the
calibration).  The port has no `tune` and no host profile.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# The built-in conservative curve: the reference's measured 499k venmo
# points (a single prove 3.17 s, a batch of 4 13.3 s).  Nearly linear,
# which keeps it conservative for batching: the controller never assumes
# an amortisation no one measured.
DEFAULT_AMORT_POINTS: Dict[int, float] = {1: 3.17, 4: 13.3}

# The built-in sharded-tier curve: a heavy floor a dispatch, a cheap
# marginal proof (the reference's mesh worker).  No port worker runs the
# sharded tier yet; the routing that reads it is ported all the same.
DEFAULT_SHARDED_AMORT_POINTS: Dict[int, float] = {1: 8.0, 4: 12.0, 16: 28.0}

# Interactive batches never exceed this many requests, however wide the
# bulk target is: an interactive request waits behind a small batch only.
INTERACTIVE_LANE_CAP = 2


class AmortModel:
    """Piecewise-linear batch cost: batch_s(S), the predicted seconds to
    prove a batch of S, interpolated between measured points.  Below the
    smallest S the cost scales in proportion; above the largest it goes
    on along the last segment's slope (one point: proportional
    everywhere).  Points must be positive and strictly increasing in S
    and in seconds: a curve that falls would let a wider batch finish
    sooner."""

    def __init__(self, points: Dict[int, float]):
        items = sorted((int(s), float(t)) for s, t in points.items())
        if not items:
            raise ValueError("AmortModel needs at least one (S, seconds) point")
        last_s, last_t = 0, 0.0
        for s, t in items:
            if s <= last_s or t <= last_t:
                raise ValueError(
                    f"amortization points must be strictly increasing: ({s}:{t}) after ({last_s}:{last_t})"
                )
            last_s, last_t = s, t
        self.points: List[Tuple[int, float]] = items

    @classmethod
    def from_spec(cls, spec: str) -> "AmortModel":
        """Parse an "S:seconds,S:seconds" spec ("" = the built-in curve).
        A malformed spec raises: a calibration that quietly fell back
        would make every decision wrong without a trace."""
        if not spec.strip():
            return cls(DEFAULT_AMORT_POINTS)
        pts: Dict[int, float] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                s_raw, t_raw = part.split(":")
                s, t = int(s_raw), float(t_raw)
            except ValueError as e:
                raise ValueError(f"bad sched_amort entry {part!r} (want 'S:seconds,...'): {e}") from None
            if s in pts:
                raise ValueError(f"duplicate sched_amort batch size {s}")
            pts[s] = t
        return cls(pts)

    def batch_s(self, s: int) -> float:
        """Predicted seconds for a batch of `s` live requests."""
        if s <= 0:
            return 0.0
        pts = self.points
        if s <= pts[0][0]:
            return pts[0][1] * s / pts[0][0]
        for (s0, t0), (s1, t1) in zip(pts, pts[1:]):
            if s <= s1:
                return t0 + (t1 - t0) * (s - s0) / (s1 - s0)
        if len(pts) >= 2:
            (s0, t0), (s1, t1) = pts[-2], pts[-1]
            slope = (t1 - t0) / (s1 - s0)
        else:
            slope = pts[0][1] / pts[0][0]
        return pts[-1][1] + slope * (s - pts[-1][0])

    def per_proof_s(self, s: int) -> float:
        return self.batch_s(s) / s if s > 0 else float("inf")

    def best_throughput_size(self, cap: int) -> int:
        """The S in [1, cap] with the fewest seconds a proof (a tie goes to
        the smaller batch: the same throughput, a shorter wait)."""
        cap = max(1, cap)
        best_s, best_t = 1, self.per_proof_s(1)
        for s in range(2, cap + 1):
            t = self.per_proof_s(s)
            if t < best_t - 1e-12:
                best_s, best_t = s, t
        return best_s


@dataclass(frozen=True)
class SchedRequest:
    """A queued request as the controller sees it: its id, its spool
    arrival time, its absolute deadline (None: none) and its lane."""

    rid: str
    t_submit: float
    deadline: Optional[float] = None
    interactive: bool = False


@dataclass
class SweepPlan:
    """One sweep's decisions: the batches in service order (the
    interactive lane first), the shed verdicts, and what the service
    records (the gauge, the decision line)."""

    batches: List[List[SchedRequest]] = field(default_factory=list)
    shed: List[Tuple[SchedRequest, str]] = field(default_factory=list)
    batch_target: int = 0           # the bulk lane's S (0: no bulk work)
    interactive_target: int = 0     # the interactive lane's S (0: none)
    batch_reason: str = "idle"      # slo | throughput | backlog | warmup | interactive | idle
    rate_hz: float = 0.0
    oldest_wait_s: float = 0.0
    lanes: Dict[str, int] = field(default_factory=dict)
    # tier routing: the tier planned for, the lanes left in the spool for a
    # live peer of the other tier (neither batched nor shed: the peer
    # claims them), and the tier-loss flag, True once when a live sharded
    # peer vanished while bulk work was queued
    tier: str = "native"
    deferred: Dict[str, int] = field(default_factory=dict)
    tier_fallback: bool = False


class BatchController:
    """The per-worker admission and batching controller.  Its state is
    the arrival-rate EWMA and the calibration; plan() is otherwise pure
    over (now, queue), so tests drive it with synthetic clocks."""

    def __init__(
        self,
        amort: AmortModel,
        objective_s: float = 0.0,
        target_fill: float = 0.8,
        ewma_tau_s: float = 10.0,
        tier: str = "native",
    ):
        self.amort = amort
        self.tier = normalize_tier(tier)
        # set when a plan has seen a live sharded peer, cleared when the
        # loss fires: the fallback counts once a loss, not once a sweep
        self._seen_sharded_peer = False
        self.objective_s = max(0.0, float(objective_s))
        # the share of the deadline / objective budget batches are planned
        # to: 0.8 leaves 20% for queue drift, witness time and model error
        self.target_fill = min(max(float(target_fill), 0.05), 1.0)
        self.ewma_tau_s = max(0.1, float(ewma_tau_s))
        self.rate_hz = 0.0
        self._last_now: Optional[float] = None
        # the online calibration, an EWMA of observed over modelled batch
        # cost.  Until the first batch is observed (or the curve was
        # measured on this card: seed_calibration), predictive shedding
        # sheds only requests whose deadline has already passed.
        self.model_scale = 1.0
        self.calibrated = False

    def observe_batch(self, fill: int, seconds: float) -> float:
        """Fold a finished batch's wall seconds into the calibration (the
        ratio clamped to [0.02, 50], so one outlier cannot blow up every
        prediction); returns the scale."""
        if fill <= 0 or seconds <= 0:
            return self.model_scale
        modelled = self.amort.batch_s(fill)
        if modelled <= 0:
            return self.model_scale
        ratio = min(max(seconds / modelled, 0.02), 50.0)
        if not self.calibrated:
            self.model_scale = ratio
            self.calibrated = True
        else:
            self.model_scale += 0.3 * (ratio - self.model_scale)
        return self.model_scale

    def seed_calibration(self) -> None:
        """Calibrated without an observed batch, for a curve measured on
        this card: the worker sizes and sheds from its first decision.  The
        scale stays 1.0, and the first observed batch folds its error in
        through the EWMA."""
        self.model_scale = 1.0
        self.calibrated = True

    def _batch_s(self, s: int) -> float:
        return self.model_scale * self.amort.batch_s(s)

    # ------------------------------------------------------------ arrivals

    def observe_arrivals(self, now: float, t_submits: List[float]) -> float:
        """Update the EWMA arrival rate from the queue's spool mtimes: the
        arrivals are the t_submits in (last now, now].  The first
        observation seeds the rate from the trailing tau window (a
        controller born into a storm must not start from zero).  Returns
        the rate in Hz."""
        if self._last_now is None:
            n = sum(1 for t in t_submits if now - t <= self.ewma_tau_s)
            self.rate_hz = n / self.ewma_tau_s
            self._last_now = now
            return self.rate_hz
        dt = now - self._last_now
        if dt <= 0:
            return self.rate_hz
        arrivals = sum(1 for t in t_submits if self._last_now < t <= now)
        inst = arrivals / dt
        alpha = 1.0 - math.exp(-dt / self.ewma_tau_s)
        self.rate_hz += alpha * (inst - self.rate_hz)
        self._last_now = now
        return self.rate_hz

    # ------------------------------------------------------------- sizing

    def _budget_s(self, req: SchedRequest, now: float) -> Optional[float]:
        """The request's remaining budget: to its deadline, else to the
        objective from its arrival; None when neither bounds it."""
        if req.deadline is not None:
            return req.deadline - now
        if self.objective_s > 0:
            return (req.t_submit + self.objective_s) - now
        return None

    def _size_for(
        self, now: float, reqs: List[SchedRequest], cap: int, parallelism: int = 1,
    ) -> Tuple[int, str]:
        """The S in [1, min(cap, backlog)] that serves the most of `reqs`
        (in service order) inside target_fill of their budgets, the
        request at position p done at (p // (S * parallelism) + 1) *
        batch_s(S); a tie goes to the larger S.  Uncalibrated: the cap
        ("warmup", the static arm's size); no budget anywhere: the cap
        ("backlog"); nobody served in time by any S: the best throughput
        size ("throughput": the shed pass owns the hopeless)."""
        n = len(reqs)
        if n == 0:
            return 0, "idle"
        hi = max(1, min(cap, n))
        if not self.calibrated:
            return hi, "warmup"
        par = max(1, int(parallelism))
        budgets = [self._budget_s(r, now) for r in reqs]
        if all(b is None for b in budgets):
            return hi, "backlog"
        best_s, best_count = 1, -1
        for s in range(1, hi + 1):
            bs = self._batch_s(s)
            count = 0
            for p, b in enumerate(budgets):
                if b is None or (p // (s * par) + 1) * bs <= self.target_fill * b:
                    count += 1
            if count >= best_count:
                best_s, best_count = s, count
        if best_count <= 0:
            return min(hi, self.amort.best_throughput_size(hi)), "throughput"
        return best_s, "slo"

    # -------------------------------------------------------------- plan

    def plan(
        self,
        now: float,
        reqs: List[SchedRequest],
        cap: int,
        spool_cap: int = 0,
        allow_shed: bool = True,
        parallelism: int = 1,
        peer_tiers: Optional[List[str]] = None,
    ) -> SweepPlan:
        """One sweep's decision: tier routing, lane order, shedding, the
        partition.

        `peer_tiers` (None: no tier information, serve everything) are the
        tiers of the other live workers on this spool.  Routing defers, it
        never claims: a native worker with a live sharded peer leaves the
        bulk lane in the spool; a sharded worker with a live native peer
        leaves the interactive lane.  Deferred requests are never shed
        here.  A native worker that loses its sharded peer with bulk work
        queued sets tier_fallback once.

        1. service order: interactive first, then (t_submit, rid).
        2. predicted-miss shed (allow_shed): a request with a deadline at
           kept position p is predicted done at now + the best partition's
           seconds for p + 1 requests (min over S of ceil(n / S) *
           batch_s(S)), optimistic on purpose; uncalibrated, only an
           expired deadline sheds.  A request without a deadline is never
           shed by prediction.
        3. the admission cap: still over `spool_cap`, shed by ascending
           slack (budget minus predicted completion; no budget sorts the
           last positions first).
        4. the partition: the interactive lane in batches of at most
           INTERACTIVE_LANE_CAP, then bulk in batches of the sized S.

        `parallelism` (live workers sharing the spool, >= 1) divides
        positions in every prediction: a worker must never shed what its
        peers could still serve."""
        plan = SweepPlan()
        plan.tier = self.tier
        plan.rate_hz = round(self.observe_arrivals(now, [r.t_submit for r in reqs]), 6)

        # tier routing first: deferred lanes leave the shed walk, the
        # sizing and the partition.  The edge detector runs on an empty
        # queue too, so that a loss while idle fires no stale fallback.
        sharded_peer = peer_tiers is not None and "sharded" in peer_tiers
        native_peer = peer_tiers is not None and "native" in peer_tiers
        has_bulk = any(not r.interactive for r in reqs)
        if self.tier == "native":
            if sharded_peer:
                self._seen_sharded_peer = True
            elif self._seen_sharded_peer:
                self._seen_sharded_peer = False
                if has_bulk:
                    plan.tier_fallback = True
        if self.tier == "native" and sharded_peer:
            deferred = [r for r in reqs if not r.interactive]
            reqs = [r for r in reqs if r.interactive]
            if deferred:
                plan.deferred["bulk"] = len(deferred)
        elif self.tier == "sharded" and native_peer:
            deferred = [r for r in reqs if r.interactive]
            reqs = [r for r in reqs if not r.interactive]
            if deferred:
                plan.deferred["interactive"] = len(deferred)

        if not reqs:
            return plan
        order = sorted(reqs, key=lambda r: (not r.interactive, r.t_submit, r.rid))
        plan.oldest_wait_s = round(max(0.0, now - min(r.t_submit for r in reqs)), 6)

        par = max(1, int(parallelism))
        kept: List[SchedRequest] = []
        if allow_shed:
            hi = max(1, min(cap, len(order)))
            pred_cache: Dict[int, float] = {}

            def best_serve_s(count: int) -> float:
                t = pred_cache.get(count)
                if t is None:
                    t = min(-(-count // s) * self._batch_s(s) for s in range(1, hi + 1))
                    pred_cache[count] = t
                return t

            for r in order:
                if r.deadline is not None:
                    pred = now + best_serve_s(-(-(len(kept) + 1) // par))
                    miss = (pred > r.deadline) if self.calibrated else (now >= r.deadline)
                    if miss:
                        plan.shed.append((r, f"predicted completion +{pred - now:.2f}s past deadline"))
                        continue
                kept.append(r)
            if spool_cap and len(kept) > spool_cap:
                def slack(item: Tuple[int, SchedRequest]) -> Tuple[float, float, str]:
                    p, r = item
                    pred = now + best_serve_s(-(-(p + 1) // par))
                    b = self._budget_s(r, now)
                    s = (b - (pred - now)) if b is not None else float("inf")
                    return (s, -p, r.rid)

                ranked = sorted(enumerate(kept), key=slack)
                to_shed = {id(r) for _p, r in ranked[: len(kept) - spool_cap]}
                survivors = []
                for r in kept:
                    if id(r) in to_shed:
                        plan.shed.append((r, f"backlog over admission cap {spool_cap}"))
                    else:
                        survivors.append(r)
                kept = survivors
        else:
            kept = order

        interactive = [r for r in kept if r.interactive]
        bulk = [r for r in kept if not r.interactive]
        plan.lanes = {"interactive": len(interactive), "bulk": len(bulk)}
        if interactive:
            s_int, _ = self._size_for(now, interactive, cap, parallelism=par)
            s_int = max(1, min(s_int, INTERACTIVE_LANE_CAP))
            plan.interactive_target = s_int
            for i in range(0, len(interactive), s_int):
                plan.batches.append(interactive[i : i + s_int])
        if bulk:
            s_bulk, reason = self._size_for(now, bulk, cap, parallelism=par)
            plan.batch_target = s_bulk
            plan.batch_reason = reason
            for i in range(0, len(bulk), s_bulk):
                plan.batches.append(bulk[i : i + s_bulk])
        elif interactive:
            plan.batch_target = plan.interactive_target
            plan.batch_reason = "interactive"
        return plan


# ---------------------------------------------------------------------------
# Fleet autoscaling.


class AutoscalePolicy:
    """Grow / shrink decisions in [workers_min, workers_max] with the
    alert engine's hysteresis: the scale-up condition (the merged backlog
    growing, or both burn rates at or over the threshold) must hold for
    scale_up_s without a break before a +1; the scale-down condition (no
    backlog, none growing) for scale_down_s before a -1.  A tick where a
    condition is false resets its clock; a tick without the signal holds
    it.  Every decision resets both clocks, so a signal that oscillates
    at a boundary makes no decision at all."""

    def __init__(
        self,
        workers_min: int,
        workers_max: int,
        scale_up_s: float = 10.0,
        scale_down_s: float = 30.0,
        burn_threshold: float = 2.0,
    ):
        self.workers_min = max(1, int(workers_min))
        self.workers_max = max(self.workers_min, int(workers_max))
        self.scale_up_s = max(0.0, float(scale_up_s))
        self.scale_down_s = max(0.0, float(scale_down_s))
        self.burn_threshold = float(burn_threshold)
        self._up_since: Optional[float] = None
        self._down_since: Optional[float] = None
        self._last_reason = ""

    def _up_cond(self, signals: Dict) -> Optional[bool]:
        growing = signals.get("backlog_growing")
        bf, bs = signals.get("burn_fast"), signals.get("burn_slow")
        burn = None
        if isinstance(bf, (int, float)) and isinstance(bs, (int, float)):
            n = signals.get("slo_n")
            burn = bool(n) and bf >= self.burn_threshold and bs >= self.burn_threshold
        if growing is None and burn is None:
            return None
        if growing is True:
            self._last_reason = "backlog_growth"
            return True
        if burn:
            self._last_reason = "slo_burn"
            return True
        return False

    def _down_cond(self, signals: Dict) -> Optional[bool]:
        backlog = signals.get("backlog")
        if not isinstance(backlog, (int, float)):
            return None
        return backlog <= 0 and signals.get("backlog_growing") is not True

    def update(self, now: float, live: int, signals: Dict) -> Optional[Dict]:
        """One tick: {"direction": "up" | "down", "reason": ...} when a
        held condition crosses its window and the band allows the step,
        else None."""
        up = self._up_cond(signals)
        down = self._down_cond(signals)
        if up is True:
            self._down_since = None
            if self._up_since is None:
                self._up_since = now
            if now - self._up_since >= self.scale_up_s and live < self.workers_max:
                self._up_since = self._down_since = None
                return {"direction": "up", "reason": self._last_reason}
        elif up is False:
            self._up_since = None
        if down is True and up is not True:
            if self._down_since is None:
                self._down_since = now
            if now - self._down_since >= self.scale_down_s and live > self.workers_min:
                self._up_since = self._down_since = None
                return {"direction": "down", "reason": "idle"}
        elif down is False:
            self._down_since = None
        return None


# ---------------------------------------------------------------------------
# The gates: the scheduler's arm and the worker's tier are code paths.


def normalize_sched(value: str) -> str:
    """Anything but the literal "adaptive" is the static "off" arm."""
    return "adaptive" if value == "adaptive" else "off"


def normalize_tier(value: str) -> str:
    """Anything but the literal "sharded" is "native" (a mistyped tier
    must not strand the bulk lane waiting for a mesh worker)."""
    return "sharded" if value == "sharded" else "native"


def sched_arm(value: str) -> str:
    """Record the ``service_sched`` gate's arm, "adaptive" or "off", and
    return it."""
    from ..utils.audit import record_arm

    return record_arm("service_sched", normalize_sched(value))


def worker_tier_arm(value: str) -> str:
    """Record the ``worker_tier`` gate's arm, "sharded" or "native", and
    return it."""
    from ..utils.audit import record_arm

    return record_arm("worker_tier", normalize_tier(value))


def build_controller(spec: str = "", points: Optional[Dict[int, float]] = None, objective_s: float = 0.0,
                     target_fill: float = 0.8, tier: str = "") -> BatchController:
    """The controller the service builds on its first adaptive sweep.  The
    cost curve resolves in the reference's order, with `points` where the
    reference reads `tune`'s host profile:

      1. `spec` ("S:sec,..."): it wins, and the controller starts
         uncalibrated (the spec may describe another circuit than the
         traffic);
      2. `points` ({S: seconds}, measured on this card): the curve and the
         calibration (``seed_calibration``), so the first sweep already
         sizes and sheds on it;
      3. the built-in curve of the tier, uncalibrated.

    Records the ``worker_tier`` arm."""
    tier = worker_tier_arm(tier)
    seeded = False
    if spec.strip():
        amort = AmortModel.from_spec(spec)
    elif points:
        amort = AmortModel(points)
        seeded = True
    else:
        amort = AmortModel(DEFAULT_SHARDED_AMORT_POINTS if tier == "sharded" else DEFAULT_AMORT_POINTS)
    ctl = BatchController(amort, objective_s=objective_s, target_fill=target_fill, tier=tier)
    if seeded:
        ctl.seed_calibration()
    return ctl
