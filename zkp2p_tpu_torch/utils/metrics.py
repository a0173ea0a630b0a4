"""The process's metrics registry: counters, gauges and fixed-bucket
histograms that the provers, ``utils.trace`` and ``utils.audit`` publish
into, a run id, and the run manifest that makes a trace dump say which
process, card and code paths produced it (the part of the reference's
``utils/metrics.py`` that its trace and audit modules use; no exposition
server, no native counters).

Instruments are plain attribute updates under the interpreter lock; the
registry's lock is taken only to get or create one.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
import uuid
from typing import Dict, Optional, Tuple

# millisecond buckets, from one kernel launch to a cold proof at full size
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000, 60000, 180000,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    kind = "counter"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: _LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    kind = "gauge"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: _LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Counts a bucket (DEFAULT_MS_BUCKETS' upper bounds, +Inf last), sum,
    count and max."""

    kind = "histogram"
    __slots__ = ("name", "labels", "buckets", "counts", "sum", "count", "max")

    def __init__(self, name: str, labels: _LabelKey = ()):
        self.name = name
        self.labels = labels
        self.buckets = DEFAULT_MS_BUCKETS
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        if v > self.max:
            self.max = v


class Registry:
    """Get-or-create store of instruments.  ``reset`` drops them all and
    bumps ``generation``, so that a caller caching instruments knows to
    fetch them again."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, _LabelKey], object] = {}
        self.generation = 0

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]]):
        key = (cls.kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, key[2])
            return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get(Histogram, name, labels)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self.generation += 1


REGISTRY = Registry()

_run_id: Optional[str] = None


def run_id() -> str:
    """This process's run id (12 hex characters)."""
    global _run_id
    if _run_id is None:
        _run_id = uuid.uuid4().hex[:12]
    return _run_id


def run_manifest() -> Dict:
    """{run_id, pid, ts, the card's name (or "cpu"), the torch and CUDA
    versions, the gate arms seen so far and their execution digest}."""
    import torch

    from .audit import execution_digest, gate_arms

    return {
        "run_id": run_id(),
        "pid": os.getpid(),
        "ts": round(time.time(), 3),
        "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "gates": gate_arms(),
        "execution_digest": execution_digest(),
    }
