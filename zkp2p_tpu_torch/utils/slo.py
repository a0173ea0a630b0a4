"""Service-level objective for the proving service (port of the
reference's ``utils/slo.py`` without its fleet merge and ``/status``
payload): a rolling-window latency tracker with an explicit objective,
attainment and burn rate, and the ``zkp2p_slo_*`` gauges.

  objective   latency bound in seconds over a request's whole life, from
              its arrival in the spool (the request file's mtime) to its
              terminal artifact; 0 = none (latencies still tracked).
  good        a request that ended `done` within the objective (with no
              objective: any `done`).
  attainment  good / total over the rolling window (1.0 on an empty
              window: no traffic is not an outage).
  burn rate   (1 - attainment) / (1 - target): how many times faster
              than sustainable the error budget burns.

The reference reads the objective, target and window from its
environment; the port takes them as arguments whose defaults are the
reference's (0.0 s, 0.95, 300 s).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

# Hard cap on samples held whatever the time window; evictions beyond it
# are counted in the snapshot (`capped`).
MAX_WINDOW_SAMPLES = 65536

DEFAULT_OBJECTIVE_S = 0.0
DEFAULT_TARGET = 0.95
DEFAULT_WINDOW_S = 300.0


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
