"""The process's metrics registry: counters, gauges and fixed-bucket
histograms that the provers, the service, ``utils.trace`` and
``utils.audit`` publish into, a run id, the run manifest that makes a
trace dump say which process, card and code paths produced it, and the
rotating JSON-lines sink the service writes its records to (port of the
reference's ``utils/metrics.py``).  The reference's Prometheus endpoint
is not ported yet; its ``publish_native_stats`` reads the counters of
the reference's C++ prover, which the port does not have.

Instruments are plain attribute updates under the interpreter lock; the
registry's lock is taken only to get or create one.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

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

    def state(self) -> Dict:
        return {"value": self.value}


class Gauge:
    kind = "gauge"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: _LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def state(self) -> Dict:
        return {"value": self.value}


class Histogram:
    """Counts a bucket (upper bounds, DEFAULT_MS_BUCKETS unless given;
    +Inf last), sum, count and max."""

    kind = "histogram"
    __slots__ = ("name", "labels", "buckets", "counts", "sum", "count", "max")

    def __init__(self, name: str, labels: _LabelKey = (), buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.labels = labels
        self.buckets = tuple(buckets) if buckets else DEFAULT_MS_BUCKETS
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

    def state(self) -> Dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts), "sum": self.sum, "count": self.count,
                "max": self.max}


class Registry:
    """Get-or-create store of instruments.  ``reset`` drops them all and
    bumps ``generation``, so that a caller caching instruments knows to
    fetch them again."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, _LabelKey], object] = {}
        self.generation = 0

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]], **kw):
        key = (cls.kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, key[2], **kw)
            return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def snapshot(self) -> List[Dict]:
        """{kind, name, labels, and the instrument's state} of every
        instrument."""
        with self._lock:
            metrics = list(self._metrics.values())
        return [{"kind": m.kind, "name": m.name, "labels": dict(m.labels), **m.state()} for m in metrics]

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


class JsonlSink:
    """Rotating JSON-lines file: one record a line, each record batch one
    O_APPEND write (so the lines of several writers stay whole), a
    manifest line (``run_manifest``) at the head of each file this
    instance starts or first writes to, rotation past `max_bytes` into
    `backups` numbered files.  An flock on <path>.lock serialises
    rotation between processes sharing the path."""

    def __init__(self, path: str, max_bytes: int = 16 << 20, backups: int = 3):
        self.path = path
        self.max_bytes = max_bytes
        self.backups = backups
        self._lock = threading.Lock()
        # (st_dev, st_ino) of the file this instance last stamped its
        # manifest into: a restarted service appending to an existing file,
        # and a rotation by another process, both re-stamp
        self._stamped_id: Optional[Tuple[int, int]] = None

    def _rotate_locked(self) -> None:
        for i in range(self.backups - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        if os.path.exists(self.path):
            os.replace(self.path, f"{self.path}.1")

    def write(self, record: Dict) -> None:
        self.write_many([record])

    def write_many(self, records: List[Dict]) -> None:
        if not records:
            return
        payload = "".join(json.dumps(r, default=str) + "\n" for r in records)
        with self._lock:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            lock_fd = -1
            try:
                import fcntl

                lock_fd = os.open(self.path + ".lock", os.O_CREAT | os.O_WRONLY, 0o644)
                fcntl.flock(lock_fd, fcntl.LOCK_EX)
            except (ImportError, OSError):  # no flock here: the in-process lock only
                if lock_fd >= 0:
                    os.close(lock_fd)
                    lock_fd = -1
            try:
                try:
                    st = os.stat(self.path)
                    size, cur_id = st.st_size, (st.st_dev, st.st_ino)
                except OSError:
                    size, cur_id = -1, None  # a fresh file
                if size >= 0 and size + len(payload) > self.max_bytes:
                    self._rotate_locked()
                    size, cur_id = -1, None
                if size < 0 or cur_id != self._stamped_id:
                    payload = json.dumps({"type": "manifest", **run_manifest()}) + "\n" + payload
                fd = os.open(self.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
                try:
                    os.write(fd, payload.encode())
                    fst = os.fstat(fd)
                    self._stamped_id = (fst.st_dev, fst.st_ino)
                finally:
                    os.close(fd)
            finally:
                if lock_fd >= 0:
                    os.close(lock_fd)  # releases the flock
