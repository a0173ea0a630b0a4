"""The fleet observability plane: the supervisor's federation of its
workers' metrics (port of the reference's ``pipeline/fleet_obs.py``).

Each worker serves its own endpoint on a port the OS chose and keeps its
own SLO window; the plane answers the fleet's question (is the fleet
meeting its objective, and which worker is why not) on one endpoint:

  worker (N of them)                    supervisor (FleetPlane)
    /snapshot  -- registry snapshot -->  scrape thread, every scrape_s
    heartbeat  -- SLO window (fallback)    | merge (rules below)
                                           v
                              fleet registry + merged SLO + alerts
                                           |
           the plane's port serves  /metrics  /status  /healthz

A family merges as its meaning asks:

  counters    summed over the workers, labels kept: the fleet's
              requests_total is the sum of the workers'.  The sum covers
              each worker's current process: a restarted worker's
              counters start again at zero, as a restarted Prometheus
              target's do.
  gauges      labelled by worker (`worker="w0"`), never summed or maxed:
              N workers sweeping one spool each report the same backlog,
              and their batch fills are skew only attribution keeps.
  histograms  merged bucket by bucket; a bucket layout that differs is
              refused (the family is left out and counted in
              zkp2p_fleet_merge_refusals_total), never binned wrong.

The fleet registry is built anew each cycle: the workers' counters are
cumulative, and folding them into yesterday's sums would count them
twice.  A failed scrape is counted for its worker and never fatal (the
worker may be restarting; its heartbeat's SLO window stands in for it).
`/status` fails closed (503) until every live worker has armed its gates
(run its preflight): a load balancer must not trust a fleet whose
members nobody has checked.

The reference reads the plane's port, interval, address, fast window and
alert thresholds from its environment; the port takes the port, the
interval and the address as keywords (the reference's defaults: off,
2.0 s, 127.0.0.1) and keeps the rest at the reference's defaults (a 60 s
fast window, ``utils.alerts.fleet_rules()``).  Besides the
reference's fields, /status's `scrape` block carries the last cycle's
milliseconds (`last_ms`), which the card's smoke run reads.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.metrics import REGISTRY, Registry


def merge_worker_metrics(fleet_reg: Registry, snapshot: List[Dict], worker: Optional[str],
                         refused: Optional[Callable[[str], None]] = None) -> None:
    """Fold one worker's registry snapshot into `fleet_reg` by the rules
    above.  `worker=None` merges without labelling gauges (the
    supervisor's own instruments are fleet-wide already).  `fleet_reg`
    must be fresh each cycle: the counters here are cumulative."""
    for rec in snapshot:
        try:
            kind = rec["kind"]
            if kind == "counter":
                fleet_reg.counter(rec["name"], rec["labels"]).merge_state(rec)
            elif kind == "gauge":
                labels = dict(rec["labels"])
                if worker is not None:
                    labels["worker"] = worker
                fleet_reg.gauge(rec["name"], labels).merge_state(rec)
            elif kind == "histogram":
                fleet_reg.histogram(rec["name"], rec["labels"], buckets=tuple(rec["buckets"])).merge_state(rec)
        except Exception:  # noqa: BLE001 — a layout mismatch or a torn record: refuse the family, not the cycle
            if refused:
                refused(rec.get("name", "?"))


class FleetPlane:
    """The supervisor's aggregation and exposition: a scrape thread of its
    own (a wedged worker socket must not delay the supervisor's watchdog)
    and one HTTP endpoint.  It reads the supervisor through `slots`
    (liveness, restarts), `_hb` / `_hb_age_s` (heartbeats), `spool` and
    `status()`, and changes nothing of it.

    port: the endpoint's port (0: one the OS chooses, in `bound_port`).
    scrape_s: the interval between cycles.  addr: the endpoint's address
    (the workers' too).  breaker_window_s: the window of the restart-storm
    count (the supervisor's breaker window).  The rules are
    ``fleet_rules()``, the fast burn window 60 s (the reference's
    defaults)."""

    def __init__(self, supervisor, port: int = 0, scrape_s: float = 2.0, addr: str = "127.0.0.1",
                 breaker_window_s: float = 60.0, clock=time.time, log: Optional[Callable[[str], None]] = None):
        from ..utils.alerts import DEFAULT_FOR_S, AlertEngine, TrendTracker, fleet_rules

        self.sup = supervisor
        self.port = port
        self.scrape_s = scrape_s
        self.addr = addr or "127.0.0.1"
        self._clock = clock
        self._log = log or supervisor.log
        self.engine = AlertEngine(fleet_rules(), registry=REGISTRY, log=self._log, clock=clock)
        self._trend = TrendTracker(keep_s=max(10 * scrape_s, 4 * DEFAULT_FOR_S, 60.0))
        self._restart_trend = TrendTracker(keep_s=max(breaker_window_s, 60.0))
        # the perf_regression rule fires on the overruns' increase inside
        # its hysteresis window, so the trend keeps at least that much
        self._overrun_trend = TrendTracker(keep_s=max(10 * scrape_s, 4 * DEFAULT_FOR_S, 60.0))
        self._restarts_window_s = breaker_window_s
        self._alert_for_s = DEFAULT_FOR_S
        self._lock = threading.Lock()
        # before the first cycle an empty registry, not this process's:
        # the supervisor's process may run other instrumented work
        self._view: Dict = {"registry": Registry(), "ready": False, "reason": "no scrape cycle has completed",
                            "slo": None, "workers_scraped": {}, "ts": None, "ms": None}
        self._alert_log: List[Dict] = []  # every fire and clear of this run
        self.scrapes = 0
        self._stop = threading.Event()
        self._srv = None
        self._thread: Optional[threading.Thread] = None
        self.bound_port: Optional[int] = None

    # ----------------------------------------------------------- scrape

    def _fetch_snapshot(self, port: int) -> Optional[Dict]:
        # the workers bind the supervisor's address: loopback when that
        # is loopback or the wildcard, else that interface
        addr = "127.0.0.1" if self.addr in ("", "0.0.0.0", "127.0.0.1") else self.addr
        try:
            with urllib.request.urlopen(f"http://{addr}:{port}/snapshot", timeout=2.0) as resp:
                return json.loads(resp.read())
        except Exception:  # noqa: BLE001 — counted by the caller
            return None

    def scrape_once(self, now: Optional[float] = None) -> Dict:
        """One cycle: scrape every live worker, merge, score the fleet's SLO,
        evaluate the alerts, publish the new view; returns it."""
        from ..utils.slo import merge_window_states, publish_fleet_slo
        from .service import scan_spool

        t0 = time.perf_counter()
        t = self._clock() if now is None else now
        slo_states: List[Dict] = []
        workers_scraped: Dict[str, Dict] = {}
        snapshots: List[Tuple[str, List[Dict]]] = []
        live = unarmed = unreachable = degraded = 0
        hb_gap: Optional[float] = None
        # the perf sentry's overruns over the workers that report budgets;
        # none reporting keeps the signal None (the rule holds)
        perf_workers = perf_overruns = 0
        for slot in list(self.sup.slots.values()):
            alive = slot.proc is not None and slot.proc.poll() is None
            if not alive or slot.state not in ("up", "starting", "draining", "retiring"):
                continue
            live += 1
            hb = self.sup._hb(slot) or {}
            if hb.get("degraded"):
                degraded += 1
            perf_hb = hb.get("perf")
            if perf_hb and perf_hb.get("budgets"):
                perf_workers += 1
                try:
                    perf_overruns += int(perf_hb.get("overruns") or 0)
                except (TypeError, ValueError):
                    pass
            age = self.sup._hb_age_s(slot)
            if age is not None:
                hb_gap = age if hb_gap is None else max(hb_gap, age)
            port = hb.get("port")
            snap = self._fetch_snapshot(port) if port else None
            if snap is None:
                unreachable += 1
                # counted only for an attempted scrape: a worker with no
                # port yet (still starting) is no scrape failure
                if port:
                    REGISTRY.counter("zkp2p_fleet_scrape_failures_total", {"worker": slot.wid}).inc()
                # the heartbeat's window stands in, its ages shifted by the
                # heartbeat's own age (a wedged worker's samples must age
                # out of the fast window); it cannot vouch for armed gates
                win = hb.get("slo_window")
                if win:
                    if age:
                        win = dict(win)
                        win["samples"] = [[a + age, lat, good] for a, lat, good in win.get("samples") or []]
                    slo_states.append(win)
                workers_scraped[slot.wid] = {"scraped": False, "armed": None, "port": port}
                continue
            if not snap.get("armed"):
                unarmed += 1
            if snap.get("slo_window"):
                slo_states.append(snap["slo_window"])
            snapshots.append((slot.wid, snap.get("metrics") or []))
            workers_scraped[slot.wid] = {"scraped": True, "armed": bool(snap.get("armed")), "port": port,
                                         "pid": snap.get("pid")}

        # the supervisor's own spool scan: the backlog does not depend on
        # any worker answering
        scan = scan_spool(self.sup.spool, t, self.scrape_s, 300.0)
        REGISTRY.gauge("zkp2p_fleet_backlog").set(scan["backlog"])
        self._trend.update(t, scan["backlog"])

        merged_slo = merge_window_states(slo_states)
        publish_fleet_slo(merged_slo, registry=REGISTRY)

        total_restarts = sum(s.restarts for s in list(self.sup.slots.values()))
        self._restart_trend.update(t, total_restarts)
        budget_overruns: Optional[int] = perf_overruns if perf_workers else None
        overruns_recent: Optional[float] = None
        if budget_overruns is not None:
            self._overrun_trend.update(t, budget_overruns)
            overruns_recent = self._overrun_trend.delta(self._alert_for_s, t)
        signals = {
            "burn_fast": merged_slo["burn_fast"],
            "burn_slow": merged_slo["burn_slow"],
            "slo_n": merged_slo["n"],
            "backlog": scan["backlog"],
            "backlog_growing": self._trend.growing(self._alert_for_s, t),
            "restarts_recent": self._restart_trend.delta(self._restarts_window_s, t),
            "parked": sum(1 for s in list(self.sup.slots.values()) if s.state == "parked"),
            "degraded": degraded,
            "hb_gap_s": hb_gap,
            "budget_overruns": budget_overruns,
            "overruns_recent": overruns_recent,
        }
        self._alert_log.extend(self.engine.evaluate(signals, now=t))

        fleet_reg = Registry()

        def refused(name: str) -> None:
            REGISTRY.counter("zkp2p_fleet_merge_refusals_total", {"family": name}).inc()

        # the supervisor's own zkp2p_fleet_* instruments first, unlabelled;
        # nothing else of this process, so that the fleet's service
        # counters stay the sums of the workers'
        sup_snap = [m for m in REGISTRY.snapshot() if m["name"].startswith("zkp2p_fleet_")]
        merge_worker_metrics(fleet_reg, sup_snap, worker=None, refused=refused)
        for wid, snap in snapshots:
            merge_worker_metrics(fleet_reg, snap, worker=wid, refused=refused)
        self.scrapes += 1
        REGISTRY.counter("zkp2p_fleet_scrapes_total").inc()

        ready = live > 0 and unreachable == 0 and unarmed == 0
        reason = None
        if not ready:
            if live == 0:
                reason = "no live workers"
            elif unreachable:
                reason = f"{unreachable}/{live} live worker(s) unreachable (no armed snapshot)"
            else:
                reason = f"{unarmed}/{live} live worker(s) have not armed their gates (preflight)"
        view = {"registry": fleet_reg, "ready": ready, "reason": reason, "slo": merged_slo, "signals": signals,
                "workers_scraped": workers_scraped, "ts": round(t, 3),
                "ms": round((time.perf_counter() - t0) * 1e3, 3)}
        with self._lock:
            self._view = view
        return view

    # ------------------------------------------------------------ status

    def status_payload(self) -> Dict:
        """The fleet's /status body (the supervisor also writes it as
        status.json): the supervisor's worker table, the merged SLO, the
        alerts and the scrape's health.  `ok` False answers 503."""
        with self._lock:
            view = dict(self._view)
        body = self.sup.status()
        body["ok"] = bool(view.get("ready"))
        if not body["ok"]:
            body["reason"] = view.get("reason") or "fleet plane not ready"
        body["slo"] = view.get("slo")
        body["alerts"] = self.engine.active()
        body["alerts_state"] = self.engine.state()
        body["signals"] = view.get("signals")
        body["scrape"] = {"cycles": self.scrapes, "interval_s": self.scrape_s, "last_ts": view.get("ts"),
                          "last_ms": view.get("ms"), "workers": view.get("workers_scraped")}
        if self.bound_port is not None:
            body["metrics_port"] = self.bound_port
        return body

    def alert_log(self) -> List[Dict]:
        return list(self._alert_log)

    def last_signals(self) -> Optional[Dict]:
        """The newest cycle's signal map (None before the first cycle)."""
        with self._lock:
            return self._view.get("signals")

    # --------------------------------------------------------- lifecycle

    def start(self) -> Optional[int]:
        """Bind the endpoint (port 0: the OS's, in `bound_port` and
        status.json) and start the scrape thread.  Returns the bound port,
        or None when the port cannot be bound (said in the log; the fleet
        runs on, its exposition off)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        plane = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (the stdlib's name)
                path = self.path.split("?", 1)[0].rstrip("/")
                if path in ("", "/metrics"):
                    with plane._lock:
                        reg = plane._view["registry"]
                    self._send(200, reg.to_prometheus().encode(), "text/plain; version=0.0.4")
                elif path == "/status":
                    try:
                        body = plane.status_payload()
                        code = 200 if body.get("ok") else 503
                    except Exception as e:  # noqa: BLE001 — an endpoint that answers, not one that dies
                        body, code = {"ok": False, "reason": f"status error: {e}"}, 500
                    self._send(code, (json.dumps(body) + "\n").encode(), "application/json")
                elif path == "/healthz":
                    self._send(200, b'{"ok": true}\n', "application/json")
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *_a):  # scrapes write nothing to stderr
                pass

        try:
            self._srv = ThreadingHTTPServer((self.addr, int(self.port or 0)), Handler)
        except OSError as e:
            self._log(f"fleet metrics endpoint on :{self.port} unavailable ({e}); plane exposition off")
            self._srv = None
        else:
            self.bound_port = int(self._srv.server_address[1])
            threading.Thread(target=self._srv.serve_forever, daemon=True, name="zkp2p-fleet-metrics").start()
            self._log(f"fleet observability plane on :{self.bound_port} (/metrics /status /healthz)")

        def loop():
            while not self._stop.wait(self.scrape_s):
                try:
                    self.scrape_once()
                except Exception as e:  # noqa: BLE001 — the plane outlives a bad cycle
                    self._log(f"fleet scrape cycle failed: {e}")

        self._thread = threading.Thread(target=loop, daemon=True, name="zkp2p-fleet-scrape")
        self._thread.start()
        return self.bound_port

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.scrape_s + 5)
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None


# ---------------------------------------------------------------------------
# The clients of the fleet's /status (`top`, the chaos harness) go through
# these two.


def http_status_json(url: str, timeout: float = 3.0) -> Optional[Dict]:
    """GET `url` as JSON.  An HTTP error whose body is JSON is returned, not
    raised (the fleet's 503 body is its status); a transport failure
    returns None."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read())
        except ValueError:
            return None
    except (OSError, ValueError):
        return None


def discover_fleet_port(fleet_dir: str) -> Optional[int]:
    """The plane's bound port from `<fleet_dir>/status.json` (`metrics_port`,
    written each supervisor tick once the plane is up); None while there is
    no such file or field."""
    try:
        with open(os.path.join(fleet_dir, "status.json")) as f:
            port = json.load(f).get("metrics_port")
        return int(port) if port else None
    except (OSError, ValueError, TypeError):
        return None


# ---------------------------------------------------------------------------
# `top`: one fleet /status body as a terminal frame (the CLI loops fetch and
# render; the frame is the reference's for the same body).


def render_top(body: Dict) -> str:
    """One frame of the fleet: health, merged SLO, queue signals, the
    scheduler's block where a body has one, alerts, the worker table, the
    scrape."""
    lines: List[str] = []
    ok = body.get("ok")
    lines.append(
        f"fleet {body.get('fleet_id', '?')}  "
        f"{'READY' if ok else 'NOT READY'}"
        + (f" ({body.get('reason')})" if not ok and body.get("reason") else "")
        + ("  DRAINING" if body.get("draining") else "")
    )
    slo = body.get("slo")
    if slo:
        lines.append(
            f"slo: attainment {slo['attainment']:.4f}  "
            f"burn fast/slow {slo['burn_fast']:g}/{slo['burn_slow']:g}  "
            f"p95 {slo['p95_s']:.3f}s"
            + (f" (objective {slo['objective_p95_s']:g}s)" if slo.get("objective_p95_s") else "")
            + f"  n={slo['n']} across {slo.get('workers', 0)} window(s)"
        )
    sig = body.get("signals") or {}
    if sig:
        lines.append(
            f"queue: backlog {sig.get('backlog')}  "
            f"restarts(win) {sig.get('restarts_recent')}  "
            f"parked {sig.get('parked')}  degraded {sig.get('degraded')}"
        )
    sched = body.get("sched") or {}
    wsched = {wid: w["sched"] for wid, w in (body.get("workers") or {}).items() if w.get("sched")}
    if wsched:
        lines.append("sched: " + "  ".join(
            f"{wid}[{s.get('mode', '?')}] tgt={s.get('batch_target')}"
            + (f" lanes i{s.get('lane_interactive', 0)}/b{s.get('lane_bulk', 0)}" if s.get("mode") == "adaptive"
               else "")
            for wid, s in sorted(wsched.items())
        ))
    if sched.get("autoscale"):
        last = sched.get("last_scale")
        lines.append(
            f"autoscale: {sched.get('workers_live')} live in "
            f"[{sched.get('workers_min')}..{sched.get('workers_max')}]  "
            f"events {sched.get('scale_events', 0)}"
            + (f"  last {last['direction']} ({last.get('reason')}) -> {last.get('workers')} @ {last.get('ts')}"
               if last else "  last none")
        )
    alerts = body.get("alerts") or []
    if alerts:
        for a in alerts:
            lines.append(f"ALERT {a['rule']}: {a.get('detail', '')} (since {a.get('since')})")
    else:
        lines.append("alerts: none firing")
    workers = body.get("workers") or {}
    if workers:
        # a flame column only when some worker's perf block points at a
        # capture
        flame_col = any((w.get("perf") or {}).get("capture") for w in workers.values())
        lines.append(f"{'worker':<8} {'state':<9} {'pid':>7} {'port':>6} "
                     f"{'restarts':>8} {'rss_mb':>8} {'hb_age':>7} {'degr':>5} {'overrun':>8}"
                     + ("  flame" if flame_col else ""))
        for wid in sorted(workers):
            w = workers[wid]
            rss = w.get("rss_mb")
            age = w.get("hb_age_s")
            # stage-budget overruns ("-": no budgets loaded, which is no
            # clean bill of health)
            perf = w.get("perf") or {}
            over = perf.get("overruns") if perf.get("budgets") else None
            cap = perf.get("capture") or {}
            lines.append(
                f"{wid:<8} {w.get('state', '?'):<9} {str(w.get('pid') or '-'):>7} "
                f"{str(w.get('port') or '-'):>6} {w.get('restarts', 0):>8} "
                f"{(f'{rss:.0f}' if isinstance(rss, (int, float)) else '-'):>8} "
                f"{(f'{age:.1f}' if isinstance(age, (int, float)) else '-'):>7} "
                f"{('y' if w.get('degraded') else '-'):>5} "
                f"{(str(over) if isinstance(over, (int, float)) else '-'):>8}"
                + (f"  {cap.get('file', '-')}" if flame_col else "")
            )
    scrape = body.get("scrape") or {}
    if scrape:
        lines.append(
            f"scrape: {scrape.get('cycles', 0)} cycle(s) @ {scrape.get('interval_s')}s"
            f"  last {scrape.get('last_ts')}"
        )
    return "\n".join(lines)
