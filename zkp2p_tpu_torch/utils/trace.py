"""Nested stage spans with one JSON-lines sink (port of the reference's
``utils/trace.py``), and a ``torch.profiler`` capture.

    with trace("gpu/prove"):
        with trace("msm"):
            ...
    records()  ->  [{"stage": "gpu/prove/msm", "ms": ...}, {"stage": "gpu/prove", ...}]

Spans read the host clock.  CUDA launches return before the card has
run them, so a span around device work measures that work only where
the work ends in a synchronise inside the span (a copy to the host, or
``torch.cuda.synchronize()``); otherwise it measures the enqueue.

Each thread nests its own spans; ``current_stack`` / ``adopt_stack`` and
``current_context`` / ``adopt_context`` hand a thread's stage path and
ambient attributes to the workers it submits to.  Every closed span also
feeds the ``zkp2p_stage_ms{stage=...}`` histogram of ``metrics.REGISTRY``.

Records are held in a bounded ring (``RING_CAPACITY`` records unless
``resize_ring`` says otherwise): the oldest go first and are counted
(``dropped``, ``zkp2p_trace_dropped_total`` and the dump's manifest).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from .metrics import REGISTRY, run_id, run_manifest

RING_CAPACITY = 65536

_records: Deque[Dict[str, Any]] = collections.deque(maxlen=RING_CAPACITY)
_dropped = 0
_append_lock = threading.Lock()
_tls = threading.local()

# stage path -> histogram, valid for one registry generation
_stage_hists: Dict[str, Any] = {}
_stage_hists_gen = -1


def _observe_stage(path: str, ms: float) -> None:
    global _stage_hists_gen
    if REGISTRY.generation != _stage_hists_gen:
        _stage_hists.clear()
        _stage_hists_gen = REGISTRY.generation
    h = _stage_hists.get(path)
    if h is None:
        h = _stage_hists[path] = REGISTRY.histogram("zkp2p_stage_ms", {"stage": path})
    h.observe(ms)


def _append(rec: Dict[str, Any]) -> None:
    # locked: two threads appending at a full ring must each count a drop
    global _dropped
    with _append_lock:
        dropped = len(_records) == _records.maxlen
        if dropped:
            _dropped += 1
        _records.append(rec)
    if dropped:
        REGISTRY.counter("zkp2p_trace_dropped_total").inc()


@contextlib.contextmanager
def trace(stage: str, **attrs):
    """A span named by this thread's stage path; `attrs` and the
    thread's context (explicit attributes win) go into its record."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(stage)
    path = "/".join(stack)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        rec = {"stage": path, "ms": ms}
        rec.update(getattr(_tls, "ctx", None) or {})
        rec.update(attrs)
        _append(rec)
        _observe_stage(path, ms)
        stack.pop()


def current_stack() -> List[str]:
    return list(getattr(_tls, "stack", None) or [])


def adopt_stack(stack: List[str]) -> None:
    _tls.stack = list(stack)


def set_context(**attrs) -> None:
    """Merge attributes into every record this thread closes; a None
    value removes the key."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = _tls.ctx = {}
    for k, v in attrs.items():
        if v is None:
            ctx.pop(k, None)
        else:
            ctx[k] = v


def clear_context() -> None:
    _tls.ctx = {}


def current_context() -> Dict[str, Any]:
    return dict(getattr(_tls, "ctx", None) or {})


def adopt_context(ctx: Dict[str, Any]) -> None:
    _tls.ctx = dict(ctx)


def resize_ring(capacity: int = RING_CAPACITY) -> None:
    """Bound the ring at `capacity` records, keeping the newest."""
    global _records
    with _append_lock:
        _records = collections.deque(_records, maxlen=max(1, capacity))


def records() -> List[Dict[str, Any]]:
    return list(_records)


def dropped() -> int:
    return _dropped


def reset() -> None:
    global _dropped
    with _append_lock:
        _records.clear()
        _dropped = 0


def drain() -> List[Dict[str, Any]]:
    """Take every buffered record; records appended meanwhile stay for
    the next drain."""
    out: List[Dict[str, Any]] = []
    while True:
        try:
            out.append(_records.popleft())
        except IndexError:
            return out


def dump_trace(path: Optional[str] = None) -> None:
    """Write the buffered records.  To `path`: one O_APPEND write of a
    manifest line (``metrics.run_manifest`` and the drop count) and the
    records, each with the run id and pid, so that dumps of several
    processes into one file stay whole and separable.  Without a path:
    the records to stderr."""
    recs = records()
    if not path:
        print("\n".join(json.dumps(r) for r in recs), file=sys.stderr)
        return
    rid, pid = run_id(), os.getpid()
    lines = [json.dumps({"type": "manifest", **run_manifest(), "trace_dropped": _dropped})]
    lines += [json.dumps({**r, "run_id": rid, "pid": pid}) for r in recs]
    payload = ("\n".join(lines) + "\n").encode()
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, payload)
    finally:
        os.close(fd)


@contextlib.contextmanager
def profile(name: str = "zkp2p", trace_dir: Optional[str] = None):
    """A ``torch.profiler`` capture of the block (the CPU, and CUDA where
    there is a card), written as a Chrome trace to
    ``<trace_dir>/<name>.json``; nothing when `trace_dir` is None.
    Yields the profiler, or None."""
    if not trace_dir:
        yield None
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, name + ".json"))
