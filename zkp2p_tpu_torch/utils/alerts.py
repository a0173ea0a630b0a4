"""The fleet plane's alert engine (port of the reference's
``utils/alerts.py``): rules over the signals only the supervisor sees (the
burn rate of the merged SLO windows, the spool's backlog trend, restart
storms, breaker parks, lingering governor degrades, heartbeat gaps),
each with hysteresis, so that a signal flapping across its threshold
raises one alert and later one clear, not a transition every tick.

A rule's states:

  ok --cond true--> pending --held for_s--> FIRING --cond false
     <--cond false--          (counter, log)    held clear_s--> ok

  * `for_s`: how long the condition must hold before the rule fires;
  * `clear_s`: how long it must be false without a break before a firing
    alert clears; a re-trip inside it keeps the original alert (its
    `since`, no second count);
  * a rule whose signal is absent this tick (its condition returns None)
    keeps its state: missing data is evidence of nothing.

A transition is returned by ``evaluate``, counted in
``zkp2p_fleet_alerts_total{rule}`` (fires only), shown by ``active()`` and
``state()`` (the fleet's /status and status.json) and logged.
Evaluation is a function of (signals, now): tests drive it with a clock
of their own.

The reference reads the thresholds from its environment; ``fleet_rules``
takes them as keywords whose defaults are the reference's (burn rate 2.0,
restarts 3, for 5 s, clear 30 s, heartbeat gap 15 s).  Its
`perf_regression` rule reads the stage-budget overruns that each
worker's perf sentry (``utils.perfledger`` in the service) puts in its
heartbeat's `perf` block: the fleet plane sums them over the workers
that have budgets, and the rule holds while none has (a fresh ledger
must not page).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass
class Rule:
    """One alert rule: `cond(signals)` returns True (met), False (not met)
    or None (no data this tick: hold).  `detail(signals)` is the line
    stamped on the alert when it fires."""

    name: str
    cond: Callable[[Dict], Optional[bool]]
    for_s: float = 0.0
    clear_s: float = 30.0
    detail: Optional[Callable[[Dict], str]] = None


@dataclass
class _RuleState:
    firing: bool = False
    since: float = 0.0  # the fire time while firing
    pending_since: Optional[float] = None
    clear_since: Optional[float] = None
    fired_count: int = 0
    last_detail: str = ""


class TrendTracker:
    """A rolling (t, value) history for trend rules: ``update`` each
    evaluation; ``growing(window_s)`` says whether the value rose by at
    least `min_delta` across the last `window_s`, None while the history
    is too short to tell (a fresh supervisor must not clear a real alert
    for want of a past)."""

    def __init__(self, keep_s: float = 600.0):
        self.keep_s = keep_s
        self._hist: deque = deque()  # (t, value), oldest first

    def update(self, now: float, value: float) -> None:
        self._hist.append((now, float(value)))
        edge = now - self.keep_s
        while self._hist and self._hist[0][0] < edge:
            self._hist.popleft()

    def _base(self, window_s: float, now: float, default):
        base = default
        for t, v in self._hist:
            if t > now - window_s:
                break
            base = v
        return base

    def growing(self, window_s: float, now: float, min_delta: float = 1.0) -> Optional[bool]:
        if not self._hist:
            return None
        base = self._base(window_s, now, None)
        if base is None:
            # the history does not span the window yet: only a value at
            # or below zero is a safe False
            return False if self._hist[-1][1] <= 0 else None
        cur = self._hist[-1][1]
        return cur > 0 and (cur - base) >= min_delta

    def delta(self, window_s: float, now: float) -> Optional[float]:
        """value now - value at (now - window_s), for cumulative signals
        (restart counts); a history shorter than the window takes its
        oldest sample as the base (an underestimate, never an invented
        spike).  None with no history."""
        if not self._hist:
            return None
        return self._hist[-1][1] - self._base(window_s, now, self._hist[0][1])


class AlertEngine:
    def __init__(self, rules: List[Rule], registry=None, log: Optional[Callable[[str], None]] = None,
                 clock=time.time):
        self.rules = list(rules)
        self._states: Dict[str, _RuleState] = {r.name: _RuleState() for r in self.rules}
        self._registry = registry
        self._log = log
        self._clock = clock

    def _counter(self, rule: str):
        reg = self._registry
        if reg is None:
            from .metrics import REGISTRY as reg  # noqa: N811
        return reg.counter("zkp2p_fleet_alerts_total", {"rule": rule})

    def evaluate(self, signals: Dict, now: Optional[float] = None) -> List[Dict]:
        """One tick; returns this tick's transitions (fired, cleared)."""
        t = self._clock() if now is None else now
        transitions: List[Dict] = []
        for rule in self.rules:
            st = self._states[rule.name]
            try:
                cond = rule.cond(signals)
            except Exception:  # noqa: BLE001 — a broken rule does not end the tick
                cond = None
            if cond is None:
                continue
            if cond:
                st.clear_since = None
                if st.firing:
                    continue
                if st.pending_since is None:
                    st.pending_since = t
                if t - st.pending_since >= rule.for_s:
                    st.firing, st.since, st.pending_since = True, t, None
                    st.fired_count += 1
                    st.last_detail = rule.detail(signals) if rule.detail else ""
                    self._counter(rule.name).inc()
                    transitions.append({"rule": rule.name, "event": "fired", "ts": round(t, 3),
                                        "detail": st.last_detail})
                    if self._log:
                        self._log(f"ALERT {rule.name}: FIRED ({st.last_detail})")
            else:
                st.pending_since = None
                if not st.firing:
                    continue
                if st.clear_since is None:
                    st.clear_since = t
                if t - st.clear_since >= rule.clear_s:
                    st.firing, st.clear_since = False, None
                    transitions.append({"rule": rule.name, "event": "cleared", "ts": round(t, 3),
                                        "after_s": round(t - st.since, 3)})
                    if self._log:
                        self._log(f"ALERT {rule.name}: cleared after {t - st.since:.1f}s")
        return transitions

    def active(self) -> List[Dict]:
        """The firing alerts (/status, status.json)."""
        return [{"rule": name, "since": round(st.since, 3), "detail": st.last_detail}
                for name, st in self._states.items() if st.firing]

    def state(self) -> Dict:
        """Every rule's state; `fired_count` outlives its clears (what has
        fired in this run)."""
        return {name: {"firing": st.firing, "since": round(st.since, 3) if st.firing else None,
                       "fired_count": st.fired_count, "detail": st.last_detail}
                for name, st in self._states.items()}


# ---------------------------------------------------------------------------
# The fleet's rules.  The signals (pipeline.fleet_obs builds them from the
# merged scrape and the supervisor's state; any may be absent, which a rule
# takes as "hold"):
#
#   burn_fast / burn_slow   the merged windows' burn rates (utils.slo)
#   slo_n                   the merged window's sample count
#   backlog_growing         bool | None from a TrendTracker over the spool
#   backlog                 open spool requests now
#   restarts_recent         the supervisor's restarts inside the breaker window
#   parked                  workers parked by the breaker
#   degraded                workers whose heartbeat says degraded
#   hb_gap_s                the oldest live heartbeat's age (None before any)
#   budget_overruns         stage-budget overruns of the workers that report
#                           budgets (None when none does)
#   overruns_recent         their increase inside the trend window


def _num(signals: Dict, key: str):
    v = signals.get(key)
    return v if isinstance(v, (int, float)) else None


# how long a condition must hold before its rule fires (the reference's
# alert_for_s default); the fleet plane watches its trends as long
DEFAULT_FOR_S = 5.0


def fleet_rules(burn_rate: float = 2.0, restarts: int = 3, for_s: float = DEFAULT_FOR_S, clear_s: float = 30.0,
                hb_gap_s: float = 15.0) -> List[Rule]:
    """The fleet's rules at these thresholds (the reference's
    alert_burn_rate, alert_restarts, alert_for_s, alert_clear_s and
    alert_hb_gap_s, at its defaults), as plain Rules a caller may extend."""

    def slo_burn(s: Dict) -> Optional[bool]:
        bf, bs = _num(s, "burn_fast"), _num(s, "burn_slow")
        if bf is None or bs is None:
            return None
        if not _num(s, "slo_n"):
            return False  # an empty window: no traffic is not an outage
        # both windows over the threshold: fast alone is a blip, slow
        # alone is history
        return bf >= burn_rate and bs >= burn_rate

    def backlog_growth(s: Dict) -> Optional[bool]:
        return s.get("backlog_growing")

    def restart_storm(s: Dict) -> Optional[bool]:
        parked, rr = _num(s, "parked"), _num(s, "restarts_recent")
        if parked is None and rr is None:
            return None
        # a park is the storm's end state: fire even when its restarts
        # fell before the trend window
        return bool(parked) or (rr is not None and rr >= restarts)

    def governor_degrade(s: Dict) -> Optional[bool]:
        d = _num(s, "degraded")
        return None if d is None else bool(d)

    def heartbeat_gap(s: Dict) -> Optional[bool]:
        gap = _num(s, "hb_gap_s")
        return None if gap is None else gap >= hb_gap_s

    def perf_regression(s: Dict) -> Optional[bool]:
        # no worker with budgets: hold (a fresh ledger must not page);
        # fires only while overruns still accrue
        if _num(s, "budget_overruns") is None:
            return None
        return (_num(s, "overruns_recent") or 0) > 0

    return [
        Rule("slo_burn", slo_burn, for_s=for_s, clear_s=clear_s,
             detail=lambda s: (f"burn fast={s.get('burn_fast')} slow={s.get('burn_slow')} "
                               f">= {burn_rate:g} over n={s.get('slo_n')}")),
        Rule("backlog_growth", backlog_growth, for_s=for_s, clear_s=clear_s,
             detail=lambda s: f"backlog {s.get('backlog')} and growing"),
        # a park fires at once: the breaker's window already held the flap
        Rule("restart_storm", restart_storm, for_s=0.0, clear_s=clear_s,
             detail=lambda s: (f"parked={s.get('parked')} restarts_recent={s.get('restarts_recent')}"
                               f" (threshold {restarts})")),
        Rule("governor_degrade", governor_degrade, for_s=for_s, clear_s=clear_s,
             detail=lambda s: f"{s.get('degraded')} worker(s) soft-degraded"),
        Rule("heartbeat_gap", heartbeat_gap, for_s=0.0, clear_s=clear_s,
             detail=lambda s: f"max heartbeat age {s.get('hb_gap_s')}s >= {hb_gap_s:g}s"),
        Rule("perf_regression", perf_regression, for_s=for_s, clear_s=clear_s,
             detail=lambda s: (f"stage budget overruns {s.get('budget_overruns')} total, "
                               f"+{s.get('overruns_recent')} in window")),
    ]
