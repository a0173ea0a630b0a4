"""Service-level objective for the proving service (port of the
reference's ``utils/slo.py``): a rolling-window latency tracker with an
explicit objective, attainment and burn rate, the ``zkp2p_slo_*`` gauges,
the window serialised for another process (``window_state``), the fleet
plane's merge of N such windows (``merge_window_states``,
``publish_fleet_slo``) and the ``/status`` payload.

  objective   latency bound in seconds over a request's whole life, from
              its arrival in the spool (the request file's mtime) to its
              terminal artifact; 0 = none (latencies still tracked).
  good        a request that ended `done` within the objective (with no
              objective: any `done`).
  attainment  good / total over the rolling window (1.0 on an empty
              window: no traffic is not an outage).
  burn rate   (1 - attainment) / (1 - target): how many times faster
              than sustainable the error budget burns.

The merge pools the workers' raw samples and recomputes attainment and
percentiles over the pooled set, which is what one tracker observing
every worker's traffic would report: the mean of two p95s is no
percentile of anything, and an idle worker's vacuous 1.0 must not dilute
a drowning one's.  Burn rates come as the multi-window pair: `burn_fast`
over the trailing `fast_window_s` (a fresh cliff), `burn_slow` over the
whole window (a blip stays below it).

The reference reads the objective, target, window and fast window from
its environment; the port takes them as arguments whose defaults are the
reference's (0.0 s, 0.95, 300 s, 60 s).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

# Hard cap on samples held whatever the time window; evictions beyond it
# are counted in the snapshot (`capped`).
MAX_WINDOW_SAMPLES = 65536

DEFAULT_OBJECTIVE_S = 0.0
DEFAULT_TARGET = 0.95
DEFAULT_WINDOW_S = 300.0
DEFAULT_FAST_WINDOW_S = 60.0


class SloTracker:
    """Rolling-window latency / outcome tracker: `observe(latency_s, ok)`
    for each terminal request, `snapshot()` for attainment, burn rate and
    the window's exact percentiles.  The clock is injectable."""

    def __init__(self, objective_s: float = DEFAULT_OBJECTIVE_S, target: float = DEFAULT_TARGET,
                 window_s: float = DEFAULT_WINDOW_S, clock=time.monotonic):
        self.objective_s = max(0.0, float(objective_s))
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0,1), got {target}")
        self.target = target
        self.window_s = max(0.0, float(window_s))
        self._clock = clock
        # (t, latency_s, good) triples, oldest first
        self._samples: deque = deque()
        self._lock = threading.Lock()
        self._capped = 0

    def _is_good(self, latency_s: float, ok: bool) -> bool:
        if not ok:
            return False
        return self.objective_s <= 0 or latency_s <= self.objective_s

    def observe(self, latency_s: float, ok: bool = True, now: Optional[float] = None) -> None:
        t = self._clock() if now is None else now
        with self._lock:
            self._samples.append((t, float(latency_s), self._is_good(latency_s, ok)))
            if len(self._samples) > MAX_WINDOW_SAMPLES:
                self._samples.popleft()
                self._capped += 1
            self._prune(t)

    def _prune(self, now: float) -> None:
        # the caller holds the lock; window_s 0 keeps everything
        if self.window_s <= 0:
            return
        edge = now - self.window_s
        while self._samples and self._samples[0][0] < edge:
            self._samples.popleft()

    def snapshot(self, now: Optional[float] = None) -> Dict:
        """Attainment, burn rate and the window's percentiles."""
        t = self._clock() if now is None else now
        with self._lock:
            self._prune(t)
            samples = list(self._samples)
            capped = self._capped
        lats = sorted(s[1] for s in samples)
        n = len(samples)
        good = sum(1 for s in samples if s[2])
        attainment = (good / n) if n else 1.0
        burn = (1.0 - attainment) / (1.0 - self.target)

        def pct(q: float) -> float:
            if not lats:
                return 0.0
            return lats[max(0, min(n - 1, int(round(q * (n - 1)))))]

        return {
            "objective_p95_s": self.objective_s,
            "target": self.target,
            "window_s": self.window_s,
            "n": n,
            "good": good,
            "attainment": round(attainment, 6),
            "burn_rate": round(burn, 4),
            "p50_s": round(pct(0.50), 6),
            "p95_s": round(pct(0.95), 6),
            "max_s": round(lats[-1], 6) if lats else 0.0,
            "capped": capped,
        }

    def window_state(self, max_samples: int = 4096, now: Optional[float] = None) -> Dict:
        """The window for another process (a heartbeat, ``/snapshot``):
        samples as [age_s, latency_s, good] triples, newest last (ages,
        because two processes' monotonic clocks share no epoch).  Past
        `max_samples` the oldest are left out and counted in `dropped`;
        `n` stays the window's true size."""
        t = self._clock() if now is None else now
        with self._lock:
            self._prune(t)
            samples = list(self._samples)
            capped = self._capped
        dropped = max(0, len(samples) - max_samples)
        return {
            "objective_s": self.objective_s,
            "target": self.target,
            "window_s": self.window_s,
            "n": len(samples),
            "samples": [[round(max(0.0, t - s[0]), 3), round(s[1], 6), 1 if s[2] else 0] for s in samples[dropped:]],
            "dropped": dropped,
            "capped": capped,
        }


def merge_window_states(states: List[Dict], fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                        target: Optional[float] = None) -> Dict:
    """N workers' ``window_state`` dicts merged into one fleet snapshot by
    pooling their samples.  `n` is the sum of the workers' true window
    sizes (samples a transport cap left out included); attainment and the
    percentiles are over the samples that arrived (`n_merged`).
    `burn_slow` is over every pooled sample, `burn_fast` over those
    younger than `fast_window_s`.  The target is the highest the workers
    state (0.95 with none, or with one outside (0, 1))."""
    states = [s for s in states if s]
    tgt = target
    if tgt is None:
        tgt = max((s.get("target", DEFAULT_TARGET) for s in states), default=DEFAULT_TARGET)
    if not 0.0 < tgt < 1.0:
        tgt = DEFAULT_TARGET
    pooled: List[List[float]] = []  # [age_s, latency_s, good]
    n_true = capped = 0
    objective = 0.0
    for s in states:
        pooled.extend(s.get("samples") or [])
        n_true += int(s.get("n", len(s.get("samples") or [])))
        capped += int(s.get("capped", 0))
        objective = max(objective, float(s.get("objective_s", 0.0)))

    def burn(sub: List[List[float]]) -> Dict:
        k = len(sub)
        good = sum(1 for x in sub if x[2])
        att = (good / k) if k else 1.0
        return {"n": k, "good": good, "attainment": round(att, 6), "burn": round((1.0 - att) / (1.0 - tgt), 4)}

    full = burn(pooled)
    fast = burn([x for x in pooled if x[0] <= fast_window_s])
    lats = sorted(x[1] for x in pooled)

    def pct(q: float) -> float:
        if not lats:
            return 0.0
        return lats[max(0, min(len(lats) - 1, int(round(q * (len(lats) - 1)))))]

    return {
        "objective_p95_s": objective,
        "target": tgt,
        "fast_window_s": fast_window_s,
        "workers": len(states),
        "n": n_true,
        "n_merged": full["n"],
        "good": full["good"],
        "attainment": full["attainment"],
        "burn_slow": full["burn"],
        "burn_fast": fast["burn"],
        "n_fast": fast["n"],
        "p50_s": round(pct(0.50), 6),
        "p95_s": round(pct(0.95), 6),
        "max_s": round(lats[-1], 6) if lats else 0.0,
        "capped": capped,
    }


def publish_fleet_slo(snap: Dict, registry=None) -> None:
    """Mirror a merged fleet snapshot into the ``zkp2p_fleet_slo_*`` gauges."""
    from .metrics import REGISTRY

    reg = registry if registry is not None else REGISTRY
    reg.gauge("zkp2p_fleet_slo_attainment").set(snap["attainment"])
    reg.gauge("zkp2p_fleet_slo_burn_fast").set(snap["burn_fast"])
    reg.gauge("zkp2p_fleet_slo_burn_slow").set(snap["burn_slow"])
    reg.gauge("zkp2p_fleet_slo_window_p95_s").set(snap["p95_s"])
    reg.gauge("zkp2p_fleet_slo_window_requests").set(snap["n"])
    reg.gauge("zkp2p_fleet_slo_objective_s").set(snap["objective_p95_s"])


# The process-wide tracker: the service observes into it and the
# time-series sampler reads it, so the two cannot disagree.
_default: Optional[SloTracker] = None
_default_lock = threading.Lock()


def default_tracker(objective_s: Optional[float] = None) -> SloTracker:
    """The process-wide tracker, made at the reference's defaults on first
    use; `objective_s`, when given, becomes its objective."""
    global _default
    with _default_lock:
        if _default is None:
            _default = SloTracker()
        if objective_s is not None:
            _default.objective_s = max(0.0, float(objective_s))
        return _default


def publish_slo(registry=None) -> Dict:
    """Refresh the ``zkp2p_slo_*`` gauges from the process-wide tracker;
    returns its snapshot."""
    from .metrics import REGISTRY

    reg = registry if registry is not None else REGISTRY
    snap = default_tracker().snapshot()
    reg.gauge("zkp2p_slo_attainment").set(snap["attainment"])
    reg.gauge("zkp2p_slo_burn_rate").set(snap["burn_rate"])
    reg.gauge("zkp2p_slo_window_p95_s").set(snap["p95_s"])
    reg.gauge("zkp2p_slo_window_requests").set(snap["n"])
    reg.gauge("zkp2p_slo_objective_s").set(snap["objective_p95_s"])
    return snap


def slo_arm(objective_s: float = DEFAULT_OBJECTIVE_S, target: float = DEFAULT_TARGET) -> str:
    """Record the ``service_slo`` gate's arm: "off" or "p95=<s>s@<target>"."""
    from .audit import record_arm

    return record_arm("service_slo", "off" if objective_s <= 0 else f"p95={objective_s:g}s@{target:g}")


def timeseries_arm(interval_s: float) -> str:
    """Record the ``service_timeseries`` gate's arm: "off" or "<interval>s"."""
    from .audit import record_arm

    return record_arm("service_timeseries", "off" if interval_s <= 0 else f"{interval_s:g}s")


# The /status payload fails closed (503) until a preflight has run: a
# scrape must not call a process healthy whose gates nobody armed.

_t_start = time.time()

# the registry's service counters /status reports, under its names
_STATUS_COUNTERS = {
    "zkp2p_service_retries_total": "retries",
    "zkp2p_service_bisections_total": "bisections",
    "zkp2p_service_deadline_total": "deadline",
    "zkp2p_service_shed_total": "shed",
    "zkp2p_service_emit_failures_total": "emit_failures",
    "zkp2p_service_deferred_total": "deferred",
}


def status_payload(identity: Optional[Dict[str, str]] = None) -> Dict:
    """The ``/status`` JSON: ok (a preflight has run in this process), ts,
    run_id, pid, uptime_s, execution_digest, `identity`'s worker and fleet
    where set, the preflight's summary (or the reason for ok False), the
    SLO snapshot, the terminal states' counts and the rescue counters.
    The endpoint answers 503 for ok False."""
    import os

    from .audit import execution_digest, last_preflight
    from .metrics import REGISTRY, run_id

    pf = last_preflight()
    body: Dict = {
        "ok": pf is not None,
        "ts": round(time.time(), 3),
        "run_id": run_id(),
        "pid": os.getpid(),
        "uptime_s": round(time.time() - _t_start, 3),
        "execution_digest": execution_digest(),
        **{k: v for k, v in (identity or {}).items() if v},
    }
    if pf is None:
        body["reason"] = "preflight has not run (gates unarmed; see python -m zkp2p_tpu_torch doctor)"
    else:
        body["preflight"] = pf
    body["slo"] = default_tracker().snapshot()
    # read out of a snapshot: a get-or-create read would make zero-valued
    # instruments
    states: Dict[str, float] = {}
    counters: Dict[str, float] = {}
    for rec in REGISTRY.snapshot():
        name = rec["name"]
        if name == "zkp2p_service_requests_total":
            states[rec["labels"].get("state", "?")] = rec["value"]
        elif name in _STATUS_COUNTERS:
            counters[_STATUS_COUNTERS[name]] = counters.get(_STATUS_COUNTERS[name], 0) + rec["value"]
        elif name == "zkp2p_service_degraded_total":
            counters["degraded"] = counters.get("degraded", 0) + rec["value"]
        elif name == "zkp2p_service_takeovers_total":
            key = "takeovers_" + rec["labels"].get("result", "?")
            counters[key] = counters.get(key, 0) + rec["value"]
    body["requests"] = states
    body["counters"] = counters
    return body
