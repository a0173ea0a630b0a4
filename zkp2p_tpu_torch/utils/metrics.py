"""The process's metrics registry: counters, gauges and fixed-bucket
histograms that the provers, the service, ``utils.trace`` and
``utils.audit`` publish into, a run id, the run manifest that makes a
trace dump say which process, card and code paths produced it, the
rotating JSON-lines sink the service writes its records to, and the
Prometheus exposition endpoint (port of the reference's
``utils/metrics.py``).  The reference's ``publish_native_stats``, which
its endpoint also calls at each scrape, reads the counters of the
reference's C++ prover; the port has no such prover and leaves it out.

Instruments are plain attribute updates under the interpreter lock; the
registry's lock is taken only to get or create one.  Snapshots of two
registries merge (counters add, gauges keep the max, histograms of the
same buckets add); the fleet plane (``pipeline.fleet_obs``) builds its
view this way, a fresh registry each scrape, with each worker's gauges
labelled by worker.
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

# The `# HELP` text of each family the port publishes, the reference's
# words (the exposition's text equals the reference's for the same
# instruments); a family not here gets the generic line.
METRIC_HELP: Dict[str, str] = {
    "zkp2p_stage_ms": "Stage latency histogram fed by every trace() span",
    "zkp2p_proves_total": "Proofs produced, by prover backend",
    "zkp2p_service_requests_total": "Terminal request transitions, by state (docs/ROBUSTNESS.md state machine)",
    "zkp2p_service_retries_total": "Transient failures retried or deferred instead of terminal-ed",
    "zkp2p_service_bisections_total": "Batch proves split in half to isolate a poisoned request",
    "zkp2p_service_degraded_total": "Proves rescued by the degradation ladder, by rung",
    "zkp2p_service_deadline_total": "Requests terminal-ed error-deadline-exceeded",
    "zkp2p_service_shed_total": "Requests shed by the spool admission cap",
    "zkp2p_service_emit_failures_total": "Proof-emit failures (transient ones defer the request)",
    "zkp2p_service_deferred_total": "Non-terminal sweep outcomes: claim released for a later sweep to retry",
    "zkp2p_service_takeovers_total": "Stale-claim steal attempts, by result (won|lost)",
    "zkp2p_service_batch_fill": "Live requests per batch handed to the prover (fill vs batch_size)",
    "zkp2p_service_backlog": "Open spool requests at the last time-series sample",
    "zkp2p_service_in_flight": "Open spool requests under a fresh claim at the last time-series sample",
    "zkp2p_slo_attainment": "Fraction of rolling-window requests meeting the SLO (1.0 on an empty window)",
    "zkp2p_slo_burn_rate": "(1-attainment)/(1-target): error-budget burn multiple; 1.0 = at target",
    "zkp2p_slo_window_p95_s": "Exact p95 request latency (arrival->terminal) over the rolling window",
    "zkp2p_slo_window_requests": "Requests in the rolling SLO window",
    "zkp2p_slo_objective_s": "Configured p95 latency objective (ZKP2P_SLO_P95_S; 0 = none)",
    "zkp2p_trace_dropped_total": "Trace ring-buffer overflow evictions",
    "zkp2p_path_taken_total": "Gate consultations by resolved arm (execution audit)",
    "zkp2p_hbm_bytes_in_use": "Live device memory per device",
    "zkp2p_hbm_peak_bytes": "Process-lifetime device memory high-water mark per device",
    "zkp2p_hbm_bytes_limit": "Device memory capacity per device",
    "zkp2p_hbm_stage_peak_bytes": "Max-semantics per-stage device memory peak",
    "zkp2p_fleet_workers": "Fleet worker slots by state (up|backoff|parked|done) at the last supervisor tick",
    "zkp2p_fleet_restarts_total": "Worker restarts performed by the fleet supervisor, by worker",
    "zkp2p_fleet_parked_total": "Workers parked by the crash-loop circuit breaker",
    "zkp2p_fleet_drain_escalations_total": "Drains that exceeded ZKP2P_DRAIN_TIMEOUT_S and were escalated to SIGKILL",
    "zkp2p_fleet_governor_soft_total": "Soft RSS-budget breaches (degradation ctl written), by worker",
    "zkp2p_fleet_governor_hard_total": "Hard RSS-budget breaches (worker drained + restarted), by worker",
    "zkp2p_fleet_worker_rss_bytes": "Per-worker resident-set size at the last governor sample",
    "zkp2p_fleet_watchdog_kills_total": "Hung workers (stale heartbeat, live pid) killed by the supervisor watchdog",
    "zkp2p_fleet_degrade_applied_total": "Governor soft-degrade overlays applied inside a worker",
    "zkp2p_fleet_scrapes_total": "Fleet-plane scrape cycles completed by the supervisor",
    "zkp2p_fleet_scrape_failures_total": "Worker snapshot scrapes that failed (counted, never fatal), by worker",
    "zkp2p_fleet_merge_refusals_total": "Metric families refused during fleet merge (histogram bucket-layout mismatch), by family",
    "zkp2p_fleet_alerts_total": "Alert FIRE transitions by rule (hysteresis: one inc per episode, not per flap)",
    "zkp2p_fleet_slo_attainment": "Merged-window fleet SLO attainment (pooled worker samples)",
    "zkp2p_fleet_slo_burn_fast": "Fleet error-budget burn over the trailing fast window (merged samples)",
    "zkp2p_fleet_slo_burn_slow": "Fleet error-budget burn over the full merged window",
    "zkp2p_fleet_slo_window_p95_s": "Exact p95 over the pooled fleet SLO window",
    "zkp2p_fleet_slo_window_requests": "Samples across every worker's SLO window (sum of window sizes)",
    "zkp2p_fleet_slo_objective_s": "Configured p95 objective the fleet windows are judged against",
    "zkp2p_fleet_backlog": "Open spool requests at the last supervisor scrape (supervisor's own scan)",
    "zkp2p_stage_budget_overruns_total": "Terminal-request spans over their ledger-derived stage budget, by stage (utils.perfledger)",
    "zkp2p_perf_budget_stages": "Stage budgets loaded from the perf ledger for this worker's circuit",
    "zkp2p_flame_captures_total": "Flame-sampler captures written, by trigger (overrun|manual) (utils.flameprof)",
    "zkp2p_sched_batch_size": "Adaptive controller's bulk-lane batch target at the last sweep plan",
    "zkp2p_sched_decisions_total": "Scheduler decisions by kind (batch|shed|lane|scale_up|scale_down)",
    "zkp2p_fleet_workers_target": "Autoscaler's live-worker target after the last evaluation",
}


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

    def merge_state(self, st: Dict) -> None:
        self.value += st["value"]


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

    def merge_state(self, st: Dict) -> None:
        # across processes a gauge keeps the max: the port's gauges are
        # peaks, depths or flags
        self.value = max(self.value, st["value"])


class Histogram:
    """Counts a bucket (upper bounds, DEFAULT_MS_BUCKETS unless given;
    +Inf last), sum, count and max.  Two merge only with the same
    buckets."""

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

    def quantile(self, q: float) -> float:
        """The upper bound of the bucket holding the q-th sample (the max
        past the last bound); 0 when empty."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.buckets[i] if i < len(self.buckets) else self.max
        return self.max

    def state(self) -> Dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts), "sum": self.sum, "count": self.count,
                "max": self.max}

    def merge_state(self, st: Dict) -> None:
        if tuple(st["buckets"]) != self.buckets:
            raise ValueError(f"histogram {self.name}: bucket layout mismatch")
        for i, c in enumerate(st["counts"]):
            self.counts[i] += c
        self.sum += st["sum"]
        self.count += st["count"]
        self.max = max(self.max, st["max"])


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

    def merge(self, snapshot: List[Dict]) -> None:
        """Fold another registry's snapshot() into this one."""
        for rec in snapshot:
            cls = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}[rec["kind"]]
            kw = {"buckets": tuple(rec["buckets"])} if rec["kind"] == "histogram" else {}
            self._get(cls, rec["name"], rec["labels"], **kw).merge_state(rec)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self.generation += 1

    def to_prometheus(self) -> str:
        """The Prometheus text format (0.0.4): a HELP and a TYPE line a
        family, families sorted by name; integral values exactly, others
        at full precision."""

        def esc(v: str) -> str:
            return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")

        def fmt_labels(labels: _LabelKey, extra: str = "") -> str:
            parts = [f'{k}="{esc(v)}"' for k, v in labels]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        def num(v: float) -> str:
            return str(int(v)) if float(v).is_integer() else repr(float(v))

        with self._lock:
            metrics = list(self._metrics.values())
        by_name: Dict[Tuple[str, str], List] = {}
        for m in metrics:
            by_name.setdefault((m.name, m.kind), []).append(m)
        out: List[str] = []
        for (name, kind), ms in sorted(by_name.items()):
            help_s = METRIC_HELP.get(name, "zkp2p metric (docs/OBSERVABILITY.md)")
            out.append("# HELP %s %s" % (name, help_s.replace("\\", r"\\").replace("\n", r"\n")))
            out.append(f"# TYPE {name} {kind}")
            for m in ms:
                if kind != "histogram":
                    out.append(f"{name}{fmt_labels(m.labels)} {num(m.value)}")
                    continue
                cum = 0
                for ub, c in zip(m.buckets, m.counts):
                    cum += c
                    le = 'le="%g"' % ub
                    out.append(f"{name}_bucket{fmt_labels(m.labels, le)} {cum}")
                cum += m.counts[-1]
                le = 'le="+Inf"'
                out.append(f"{name}_bucket{fmt_labels(m.labels, le)} {cum}")
                out.append(f"{name}_sum{fmt_labels(m.labels)} {num(m.sum)}")
                out.append(f"{name}_count{fmt_labels(m.labels)} {m.count}")
        return "\n".join(out) + "\n"


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
    versions, the gate arms seen so far and their execution digest, and
    metrics_port_bound where this process's endpoint listens}."""
    import torch

    from .audit import execution_digest, gate_arms

    man = {
        "run_id": run_id(),
        "pid": os.getpid(),
        "ts": round(time.time(), 3),
        "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "gates": gate_arms(),
        "execution_digest": execution_digest(),
    }
    # the port the OS gave an auto-port endpoint: how a scraper finds it
    if _bound_port is not None:
        man["metrics_port_bound"] = _bound_port
    return man


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


# ---------------------------------------------------------------------------
# The Prometheus exposition: a stdlib HTTP endpoint, one a process, served
# by a daemon thread (it never keeps a prover alive), off unless a port is
# given.

_server = None
_server_lock = threading.Lock()
# the port the endpoint listens on: the given one, or the OS's for port 0
_bound_port: Optional[int] = None


def bound_metrics_port() -> Optional[int]:
    """The port the endpoint listens on; None when it is off."""
    return _bound_port


def maybe_start_metrics_server(port: Optional[int] = None, addr: str = "127.0.0.1",
                               registry: Optional[Registry] = None, identity: Optional[Dict[str, str]] = None):
    """Start the endpoint once a process; returns the server, or None when
    `port` is None (off, the reference's default) or cannot be bound.
    Port 0 binds a port the OS chooses (the reference's "auto"; read it
    with ``bound_metrics_port``).  `addr` defaults to localhost: the
    payloads name the host's process and its code paths.  `identity`
    ({"worker", "fleet"}, empty values left out) is what /status and
    /snapshot say of the process; the reference reads it from its
    environment.  Routes:

      /metrics   the registry as Prometheus text (the SLO gauges refreshed)
      /status    ``slo.status_payload``: 200 once a preflight has run in
                 this process, 503 before
      /healthz   200 while the process serves HTTP
      /snapshot  {ts, pid, run_id, metrics (``snapshot()``, which
                 ``merge`` takes), armed, slo_window, worker, fleet}
      other      404

    A port that cannot be bound (taken by another process, privileged)
    is said on stderr and the endpoint stays off."""
    global _server, _bound_port
    if port is None:
        return None
    reg = registry if registry is not None else REGISTRY
    ident = {k: v for k, v in (identity or {}).items() if v}
    with _server_lock:
        if _server is not None:
            return _server
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from .audit import last_preflight
        from .slo import default_tracker, publish_slo, status_payload

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, body: Dict) -> None:
                self._send(code, (json.dumps(body) + "\n").encode(), "application/json")

            def do_GET(self):  # noqa: N802 (the stdlib's name)
                path = self.path.split("?", 1)[0].rstrip("/")
                if path in ("", "/metrics"):
                    publish_slo(reg)
                    self._send(200, reg.to_prometheus().encode(), "text/plain; version=0.0.4")
                elif path == "/status":
                    try:
                        body = status_payload(ident)
                        code = 200 if body["ok"] else 503
                    except Exception as e:  # noqa: BLE001 — an endpoint that answers, not one that dies
                        body, code = {"ok": False, "reason": f"status error: {e}"}, 500
                    self._json(code, body)
                elif path == "/healthz":
                    self._json(200, {"ok": True})
                elif path == "/snapshot":
                    publish_slo(reg)
                    self._json(200, {"ts": round(time.time(), 3), "pid": os.getpid(), "run_id": run_id(),
                                     "metrics": reg.snapshot(), "armed": last_preflight() is not None,
                                     "slo_window": default_tracker().window_state(), **ident})
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *_a):  # scrapes write nothing to stderr
                pass

        try:
            srv = ThreadingHTTPServer((addr, int(port)), Handler)
        except OSError as e:
            import sys

            print(f"[metrics] endpoint on {addr}:{port} unavailable ({e}); exposition off", file=sys.stderr,
                  flush=True)
            return None
        threading.Thread(target=srv.serve_forever, daemon=True, name="zkp2p-metrics").start()
        _server = srv
        _bound_port = int(srv.server_address[1])
        if not port:
            import sys

            print(f"[metrics] auto port: listening on {addr}:{_bound_port}", file=sys.stderr, flush=True)
        return srv


def stop_metrics_server() -> None:
    """Shut the endpoint down and release its port."""
    global _server, _bound_port
    with _server_lock:
        if _server is not None:
            srv, _server, _bound_port = _server, None, None
            srv.shutdown()
            srv.server_close()
