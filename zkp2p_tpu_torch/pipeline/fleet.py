"""The supervised proving fleet: N service workers on one spool (port of
the reference's ``pipeline/fleet.py``).

  supervisor (FleetSupervisor, ``python -m zkp2p_tpu_torch fleet``)
    - spawns N workers, each `worker_cmd(wid)` with its identity appended
      as flags (below); the default worker is this CLI's `service`
    - liveness: a heartbeat file a worker (written between sweeps and
      after each) and the process's exit code; a live pid whose heartbeat
      has gone stale since its first one is hung and gets SIGKILL
    - restarts: exponential backoff a consecutive failure; K failures
      inside W seconds park the worker (the fleet runs N - 1)
    - drain: SIGTERM to every worker, each finishes what it claimed and
      exits 0; stragglers past the drain timeout get SIGKILL (counted)
    - governor: each worker's RSS from /proc; over the soft budget the
      worker is told (its ctl file) to degrade, over the hard one it is
      drained and restarted, without a breaker penalty
    - autoscaling (workers_max > 0): ``pipeline.sched.AutoscalePolicy``
      on the fleet plane's merged signals grows the fleet by a fresh
      worker (ids never come back) or retires the newest live one (a
      drain: SIGTERM, SIGKILL past the drain timeout) inside
      [workers_min, workers_max]

Files in `fleet_dir` (default <spool>/.fleet/), replaced atomically:

  <wid>.hb     the worker's heartbeat: {pid, ts, worker, fleet, state,
               port (its endpoint's bound port), rss_mb, degraded,
               slo_window, tier, sched (its last sweep's decisions), perf
               (the perf sentry's overruns, checked spans, budgets and the
               newest flame capture)}
  <wid>.ctl    supervisor -> worker: {"degrade": 1} asks for the soft
               degrade at the worker's next sweep
  status.json  the supervisor's state, rewritten each tick; with the
               fleet plane on (``fleet_metrics_port``), the plane's /status
               body: the merged SLO, the alerts, the scrape's health and
               the plane's bound port (`metrics_port`)

The supervisor holds no request state: killing it loses nothing (the
claims arbitrate), and a new one spawns fresh workers on the same spool.

Where the port differs from the reference:
  - Identity travels in argv, not the environment: the supervisor
    appends `--worker-id <wid> --fleet-id <id> --fleet-dir <dir>
    --metrics-port 0` to each worker's argv (port 0: each worker's
    endpoint on a port the OS chooses, so that N workers never collide;
    the heartbeat carries the port), `--sched <arm>` when given one, and
    the perf sentry's and flame sampler's settings given in `perf`
    (`--no-perf-ledger`, `--perf-window N`, `--cache-dir DIR`, ...,
    `--flame`, `--flame-hz HZ`, ...).  The workers inherit the supervisor's environment, which
    nothing here reads.
  - The soft degrade halves the batch and frees nothing else: the port
    has no fixed-base precomputed tables to drop.
  - The policy is keyword arguments whose defaults are the reference's
    configuration defaults (2 workers, drain 30 s, RSS budgets off,
    breaker 5 in 60 s, backoff 0.5 s, liveness 60 s, no fleet plane, a
    plane's scrape every 2 s, autoscaling off: workers_max 0, scale-up
    and scale-down windows 10 s and 30 s).
  - The supervisor only spawns processes: it never touches CUDA.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# The worker side: drain signals, the heartbeat, the governor's degrade.
# These run inside the service process (ProvingService.run).


def install_drain_handlers(svc) -> bool:
    """SIGTERM / SIGINT -> svc.request_drain(): stop claiming, finish the
    batches in flight, flush, and leave run() with "drained".  A second
    signal while draining restores the default action and delivers itself
    again, so that a worker stuck in its drain stays killable.  Main
    thread only (a CPython rule): returns False elsewhere.  A signal that
    arrives before these are installed (a worker still building its
    circuit) ends the process by the default action; in a fleet drain the
    supervisor takes any exit as final, so that is no crash."""

    def _handler(signum, _frame):
        if svc.draining:
            print(f"[service] signal {signum} again while draining: exiting NOW", flush=True)
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        print(f"[service] signal {signum}: draining (finish in-flight, claim nothing)", flush=True)
        svc.request_drain()

    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
        return True
    except ValueError:  # not the main thread
        return False


def slowed_prover(inner, per_request_s: float, batch_overhead_s: float = 0.0):
    """A batch prover with service time added: `batch_overhead_s +
    per_request_s * fill` seconds a call, then `inner`.  Keeps
    `reads_msm_knobs`, on which the degradation ladder gates."""
    if per_request_s <= 0 and batch_overhead_s <= 0:
        return inner

    def slowed(dpk, wits, **kw):
        time.sleep(batch_overhead_s + per_request_s * max(1, len(wits)))
        return inner(dpk, wits, **kw)

    slowed.reads_msm_knobs = getattr(inner, "reads_msm_knobs", False)
    return slowed


def _rss_mb(pid: int) -> Optional[float]:
    """`pid`'s resident set in MiB from /proc; None when there is no such
    file or process (no sample, never zero)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return None


def apply_soft_degrade(svc) -> None:
    """The governor's soft degrade inside a worker, once: halve the batch
    (a batch's device memory grows with it), count it, and record the
    ``fleet_governor`` arm "soft-applied", so that a degraded run never
    shares a digest with a clean one.  The reference also turns off its
    fixed-base precomputed tables and drops them; the port has none, so
    nothing else is freed.  Proof bytes do not depend on the batch."""
    if svc._fleet_degraded:
        return
    from ..utils.audit import record_arm
    from ..utils.metrics import REGISTRY

    svc.batch_size = max(1, svc.batch_size // 2)
    svc._fleet_degraded = True
    REGISTRY.counter("zkp2p_fleet_degrade_applied_total").inc()
    record_arm("fleet_governor", "soft-applied")
    print(f"[service] governor: soft degrade applied (batch={svc.batch_size})", flush=True)


def _atomic_write_json(path: str, obj: Dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


def _worker_name(svc) -> str:
    return svc._worker_id or f"pid{os.getpid()}"


def _write_heartbeat(svc, fleet_dir: str, state: Optional[str] = None) -> None:
    from ..utils.metrics import bound_metrics_port
    from ..utils.slo import default_tracker

    os.makedirs(fleet_dir, exist_ok=True)
    hb = {
        "pid": os.getpid(),
        "ts": round(time.time(), 3),
        "worker": _worker_name(svc),
        "fleet": svc._fleet_id,
        "state": state or ("draining" if svc.draining else "up"),
        "port": bound_metrics_port(),
        "rss_mb": _rss_mb(os.getpid()),
        "degraded": svc._fleet_degraded,
        # the SLO window (capped: a heartbeat lands every few seconds),
        # for the fleet plane to merge when a scrape fails
        "slo_window": default_tracker().window_state(max_samples=512),
    }
    # the tier this worker advertises: its peers route their lanes by it
    # (pipeline.sched; run() records it as the worker_tier arm)
    from .sched import normalize_tier

    hb["tier"] = normalize_tier(getattr(svc, "worker_tier", ""))
    # the last sweep's scheduler decisions, for the fleet's /status and `top`
    sched_hb = getattr(svc, "_sched_hb", None)
    if sched_hb:
        hb["sched"] = dict(sched_hb)
    # the perf sentry's counters: the fleet plane sums them into the
    # perf_regression rule's signal, `top` renders them
    perf_hb = getattr(svc, "_perf_hb", None)
    if perf_hb:
        hb["perf"] = dict(perf_hb)
    _atomic_write_json(os.path.join(fleet_dir, hb["worker"] + ".hb"), hb)


def start_heartbeat_thread(svc, fleet_dir: str, interval_s: float = 5.0) -> threading.Event:
    """Beat every `interval_s` between sweeps: a sweep may run for minutes
    (a flagship batch's witnesses), which a beat a sweep alone would show
    as a hang.  The thread beats while the sweep runs code that releases
    the interpreter lock or that the interpreter switches away from; a
    worker wedged holding the lock stops beating, which is what the
    watchdog looks for.  Returns the Event that stops it."""
    stop = threading.Event()

    def beat():
        while not stop.wait(interval_s):
            try:
                _write_heartbeat(svc, fleet_dir)
            except Exception:  # noqa: BLE001 — liveness never crashes the worker
                pass

    threading.Thread(target=beat, daemon=True, name="zkp2p-fleet-hb").start()
    return stop


def worker_tick(svc, fleet_dir: str, state: Optional[str] = None) -> None:
    """A worker's tick after each sweep: the heartbeat out, then the
    supervisor's ctl file in.  The ctl is applied here only, never from
    the heartbeat thread: changing the batch mid-sweep would race the
    producer."""
    _write_heartbeat(svc, fleet_dir, state=state)
    ctl_path = os.path.join(fleet_dir, _worker_name(svc) + ".ctl")
    if svc._fleet_degraded or not os.path.exists(ctl_path):
        return
    try:
        with open(ctl_path) as f:
            ctl = json.load(f)
    except (OSError, ValueError):
        return
    if ctl.get("degrade"):
        apply_soft_degrade(svc)


# ---------------------------------------------------------------------------
# Gates: fleet membership and the governor's budgets are code-path arms (a
# degraded fleet run must not share a digest with a clean solo run).


def fleet_member_arm(worker_id: str) -> str:
    """Record the ``service_fleet`` gate: "worker" for a worker a
    supervisor named, else "off"."""
    from ..utils.audit import record_arm

    return record_arm("service_fleet", "worker" if worker_id else "off")


def governor_arm(rss_soft_mb: int, rss_hard_mb: int) -> str:
    """Record the ``fleet_governor`` gate: "off" or
    "soft=<mb>mb,hard=<mb>mb"."""
    from ..utils.audit import record_arm

    arm = "off" if not (rss_soft_mb or rss_hard_mb) else f"soft={rss_soft_mb}mb,hard={rss_hard_mb}mb"
    return record_arm("fleet_governor", arm)


# ---------------------------------------------------------------------------
# The supervisor.


@dataclass
class WorkerSlot:
    """One worker as the supervisor sees it.  States: starting -> up ->
    (done | backoff -> up | parked | draining -> done | retiring -> done).
    `done` is an exit with rc 0 (drained, or the spool ended), any exit in
    a fleet drain or any exit of a retiring worker, and is never
    restarted; `parked` is the breaker's, and is never restarted either."""

    wid: str
    proc: Optional[subprocess.Popen] = None
    state: str = "starting"
    started_at: float = 0.0
    restarts: int = 0
    last_rc: Optional[int] = None
    failures: List[float] = field(default_factory=list)  # failure times inside the breaker's window
    consec_failures: int = 0
    backoff_until: float = 0.0
    soft_signalled: bool = False
    governor_deadline: float = 0.0  # the hard governor's drain deadline (0 = none)
    governor_restart: bool = False  # the next exit is the governor's restart, not a crash
    # the autoscaler's scale-down: SIGTERMed to leave the fleet (a drain),
    # its exit final whatever the rc; SIGKILL past scale_deadline
    retiring: bool = False
    scale_deadline: float = 0.0


# the service's perf sentry and flame settings -> the worker's flag (the
# booleans' flags turn the ledger off and the sampler on)
PERF_FLAGS = {"perf_ledger": "--no-perf-ledger", "perf_window": "--perf-window", "perf_tolerance": "--perf-tolerance",
              "cache_dir": "--cache-dir", "flame": "--flame", "flame_hz": "--flame-hz", "flame_capture_n": "--flame-capture-n",
              "flame_cooldown_s": "--flame-cooldown-s"}


class FleetSupervisor:
    """Spawn N workers on one spool and keep them healthy.  `worker_cmd`
    maps a worker id to its argv, to which the supervisor appends the
    worker's identity flags (`--sched` when `sched` is given, and the flags
    of the settings in `perf`: perf_ledger, perf_window, perf_tolerance,
    cache_dir, flame, flame_hz, flame_capture_n, flame_cooldown_s).  With
    workers_max > 0 the fleet autoscales in [max(1, workers_min),
    workers_max] (`workers` clamped into the band), which turns on the
    fleet plane (on a port the OS chooses when none is given).  Exit codes
    of run(): 0 clean, 3 the drain escalated to SIGKILL, 4 every worker
    parked."""

    def __init__(
        self,
        spool: str,
        worker_cmd: Callable[[str], List[str]],
        workers: int = 2,
        fleet_dir: Optional[str] = None,
        fleet_id: Optional[str] = None,
        drain_timeout_s: float = 30.0,
        breaker_k: int = 5,
        breaker_window_s: float = 60.0,
        restart_backoff_s: float = 0.5,
        rss_soft_mb: int = 0,
        rss_hard_mb: int = 0,
        liveness_s: float = 60.0,
        fleet_metrics_port: Optional[int] = None,
        scrape_s: float = 2.0,
        workers_min: int = 0,
        workers_max: int = 0,
        scale_up_s: float = 10.0,
        scale_down_s: float = 30.0,
        sched: Optional[str] = None,
        perf: Optional[Dict] = None,
        log: Callable[[str], None] = lambda m: print(f"[fleet] {m}", flush=True),
    ):
        from ..utils.audit import record_arm

        self.spool = spool
        self.worker_cmd = worker_cmd
        self.n = workers
        self.fleet_dir = fleet_dir or os.path.join(spool, ".fleet")
        self.fleet_id = fleet_id or uuid.uuid4().hex[:8]
        self.drain_timeout_s = drain_timeout_s
        self.breaker_k = breaker_k
        self.breaker_window_s = breaker_window_s
        self.restart_backoff_s = restart_backoff_s
        self.rss_soft_mb = rss_soft_mb
        self.rss_hard_mb = rss_hard_mb
        self.liveness_s = liveness_s
        # the fleet plane (pipeline.fleet_obs): scrape, merge, alert and
        # serve on this port (0: one the OS chooses); None: off
        self.fleet_metrics_port = fleet_metrics_port
        self.scrape_s = scrape_s
        self.plane = None
        self.log = log
        self.slots: Dict[str, WorkerSlot] = {f"w{i}": WorkerSlot(wid=f"w{i}") for i in range(self.n)}
        self.escalations = 0
        self.watchdog_kills = 0
        self._stop = threading.Event()
        self._draining = False
        # the workers' scheduler arm (None: their own default)
        self.sched = sched
        # the workers' perf sentry and flame settings (absent: their defaults)
        self.perf = dict(perf or {})
        unknown = set(self.perf) - set(PERF_FLAGS)
        if unknown:
            raise ValueError(f"unknown perf settings {sorted(unknown)} (have: {', '.join(PERF_FLAGS)})")
        # autoscaling (pipeline.sched.AutoscalePolicy): workers_max 0 is
        # off, the static fleet
        self.workers_min = workers_min
        self.workers_max = workers_max
        self.scale_up_s = scale_up_s
        self.scale_down_s = scale_down_s
        self.autoscale = workers_max > 0
        self._autoscaler = None
        self._scale_events: List[Dict] = []
        self._next_widx = self.n
        if self.autoscale:
            from .sched import AutoscalePolicy

            self.workers_min = max(1, workers_min)
            self.workers_max = max(self.workers_min, workers_max)
            # --workers seeds the fleet inside the band
            if not self.workers_min <= self.n <= self.workers_max:
                was = self.n
                self.n = min(max(self.n, self.workers_min), self.workers_max)
                log(f"autoscale: initial workers {was} clamped to {self.n} "
                    f"(band [{self.workers_min}, {self.workers_max}])")
                self.slots = {f"w{i}": WorkerSlot(wid=f"w{i}") for i in range(self.n)}
                self._next_widx = self.n
            self._autoscaler = AutoscalePolicy(self.workers_min, self.workers_max, scale_up_s=scale_up_s,
                                               scale_down_s=scale_down_s)
            # the policy reads the plane's merged signals
            if self.fleet_metrics_port is None:
                self.fleet_metrics_port = 0
                log("autoscale needs the fleet plane: enabling an ephemeral fleet metrics port")
        os.makedirs(self.fleet_dir, exist_ok=True)
        record_arm("service_fleet", f"supervisor:{self.n}")
        governor_arm(rss_soft_mb, rss_hard_mb)

    # ------------------------------------------------------------ spawn

    def _argv(self, wid: str) -> List[str]:
        argv = list(self.worker_cmd(wid)) + ["--worker-id", wid, "--fleet-id", self.fleet_id,
                                             "--fleet-dir", self.fleet_dir, "--metrics-port", "0"]
        if self.sched is not None:
            argv += ["--sched", self.sched]
        for name, value in self.perf.items():
            flag = PERF_FLAGS[name]
            if name == "perf_ledger":
                argv += [] if value else [flag]
            elif name == "flame":
                argv += [flag] if value else []
            else:
                argv += [flag, str(value)]
        return argv

    def _spawn(self, slot: WorkerSlot) -> None:
        # a new incarnation inherits neither the old ctl nor the old
        # heartbeat: a stale .hb would look ready and backdate the watchdog
        for suffix in (".ctl", ".hb"):
            try:
                os.unlink(os.path.join(self.fleet_dir, slot.wid + suffix))
            except OSError:
                pass
        slot.proc = subprocess.Popen(self._argv(slot.wid))
        slot.state = "up"
        slot.started_at = time.time()
        slot.soft_signalled = False
        slot.governor_deadline = 0.0
        self.log(f"{slot.wid}: up (pid {slot.proc.pid})")

    def start(self) -> None:
        if self.fleet_metrics_port is not None and self.plane is None:
            from .fleet_obs import FleetPlane

            self.plane = FleetPlane(self, port=self.fleet_metrics_port, scrape_s=self.scrape_s,
                                    breaker_window_s=self.breaker_window_s, log=self.log)
            self.plane.start()
        for slot in self.slots.values():
            self._spawn(slot)

    # ------------------------------------------------------------- tick

    def _hb(self, slot: WorkerSlot) -> Optional[Dict]:
        try:
            with open(os.path.join(self.fleet_dir, slot.wid + ".hb")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _hb_age_s(self, slot: WorkerSlot) -> Optional[float]:
        try:
            return time.time() - os.path.getmtime(os.path.join(self.fleet_dir, slot.wid + ".hb"))
        except OSError:
            return None

    def _on_failure(self, slot: WorkerSlot, now: float, why: str) -> None:
        """A crashed or hung worker: a count toward the breaker, then park
        it or schedule its restart after a backoff."""
        from ..utils.metrics import REGISTRY

        slot.failures.append(now)
        slot.failures = [t for t in slot.failures if now - t <= self.breaker_window_s]
        # a crash after a healthy run longer than the breaker's window
        # starts the backoff afresh
        if slot.started_at and now - slot.started_at > self.breaker_window_s:
            slot.consec_failures = 0
        slot.consec_failures += 1
        if len(slot.failures) >= self.breaker_k:
            slot.state = "parked"
            REGISTRY.counter("zkp2p_fleet_parked_total").inc()
            live = sum(1 for s in self.slots.values() if s.state in ("up", "backoff", "starting"))
            self.log(f"{slot.wid}: PARKED by circuit breaker ({len(slot.failures)} failures inside "
                     f"{self.breaker_window_s:g}s; {why}) — fleet degrades to {live} workers")
            return
        delay = min(self.restart_backoff_s * (2 ** (slot.consec_failures - 1)), 30.0)
        slot.backoff_until = now + delay
        slot.state = "backoff"
        self.log(f"{slot.wid}: {why}; restart in {delay:.2f}s (failure {len(slot.failures)}/{self.breaker_k})")

    def _governor(self, slot: WorkerSlot, now: float) -> None:
        from ..utils.metrics import REGISTRY

        if not (self.rss_soft_mb or self.rss_hard_mb) or slot.proc is None:
            return
        rss = _rss_mb(slot.proc.pid)
        if rss is None:
            return
        REGISTRY.gauge("zkp2p_fleet_worker_rss_bytes", {"worker": slot.wid}).set(rss * 1048576)
        if self.rss_hard_mb and rss > self.rss_hard_mb and not slot.governor_deadline:
            # hard: drain, so that the batch in flight ends, then restart;
            # past the deadline, SIGKILL
            REGISTRY.counter("zkp2p_fleet_governor_hard_total", {"worker": slot.wid}).inc()
            self.log(f"{slot.wid}: RSS {rss:.0f} MiB over hard budget {self.rss_hard_mb} MiB — draining for restart")
            try:
                slot.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            slot.governor_deadline = now + (self.drain_timeout_s or 10.0)
            slot.governor_restart = True
        elif self.rss_soft_mb and rss > self.rss_soft_mb and not slot.soft_signalled and not slot.governor_deadline:
            REGISTRY.counter("zkp2p_fleet_governor_soft_total", {"worker": slot.wid}).inc()
            self.log(f"{slot.wid}: RSS {rss:.0f} MiB over soft budget {self.rss_soft_mb} MiB — writing degrade ctl")
            _atomic_write_json(os.path.join(self.fleet_dir, slot.wid + ".ctl"), {"degrade": 1, "ts": now})
            slot.soft_signalled = True

    def _kill(self, slot: WorkerSlot) -> None:
        try:
            slot.proc.kill()
        except OSError:
            pass

    def tick(self) -> None:
        """One pass: reap exits, restart or park, the hung-worker watchdog,
        the governor, the gauges and status.json."""
        from ..utils.metrics import REGISTRY

        now = time.time()
        for slot in self.slots.values():
            if slot.state in ("parked", "done"):
                continue
            if slot.state == "backoff":
                if now >= slot.backoff_until and not self._draining:
                    slot.restarts += 1
                    REGISTRY.counter("zkp2p_fleet_restarts_total", {"worker": slot.wid}).inc()
                    self._spawn(slot)
                continue
            if slot.proc is None:
                continue
            rc = slot.proc.poll()
            if rc is not None:
                slot.last_rc = rc
                if self._draining:
                    slot.state = "done"  # in a fleet drain any exit is final
                elif slot.retiring:
                    # the scale-down's exit: final whatever the rc (a
                    # straggler's claims go stale and its peers take them)
                    slot.state = "done"
                    slot.retiring = False
                    slot.scale_deadline = 0.0
                    self.log(f"{slot.wid}: scaled down (rc={rc})")
                elif slot.governor_restart:
                    # the governor's recycle, before the rc 0 branch: a worker
                    # that drains cleanly on the governor's SIGTERM is
                    # restarted, not counted as leaving, and pays no breaker
                    slot.governor_restart = False
                    slot.governor_deadline = 0.0
                    slot.restarts += 1
                    REGISTRY.counter("zkp2p_fleet_restarts_total", {"worker": slot.wid}).inc()
                    self._spawn(slot)
                elif rc == 0:
                    # drained, or the spool ended: a worker that chose to
                    # leave is not restarted
                    slot.state = "done"
                    slot.consec_failures = 0
                    self.log(f"{slot.wid}: exited cleanly")
                else:
                    self._on_failure(slot, now, f"exited rc={rc}")
                continue
            if slot.retiring:
                if slot.scale_deadline and now > slot.scale_deadline:
                    self.log(f"{slot.wid}: scale-down drain timed out — SIGKILL")
                    self.escalations += 1
                    REGISTRY.counter("zkp2p_fleet_drain_escalations_total").inc()
                    self._kill(slot)
                    slot.scale_deadline = 0.0
                continue  # leaving: no watchdog, no governor
            if slot.governor_deadline and now > slot.governor_deadline:
                self.log(f"{slot.wid}: governor drain timed out — SIGKILL")
                self.escalations += 1
                REGISTRY.counter("zkp2p_fleet_drain_escalations_total").inc()
                self._kill(slot)
                slot.governor_deadline = 0.0
                continue
            # Liveness starts at the first heartbeat: a flagship worker
            # spends minutes building its circuit and importing its key
            # before run() beats, and must not be killed for it.  After
            # that, a live pid whose heartbeat is stale is hung: SIGKILL
            # (a SIGTERM would need the loop that stopped running).
            hb_age = self._hb_age_s(slot)
            if hb_age is not None and hb_age > max(self.liveness_s, 2.0) and slot.started_at < now - hb_age:
                self.watchdog_kills += 1
                REGISTRY.counter("zkp2p_fleet_watchdog_kills_total").inc()
                self.log(f"{slot.wid}: heartbeat stale ({hb_age:.1f}s) with a live pid — watchdog SIGKILL")
                self._kill(slot)
                continue
            self._governor(slot, now)
        self._autoscale_tick(now)
        counts: Dict[str, int] = {}
        for slot in self.slots.values():
            counts[slot.state] = counts.get(slot.state, 0) + 1
        for state in ("up", "backoff", "parked", "done", "starting", "retiring"):
            REGISTRY.gauge("zkp2p_fleet_workers", {"state": state}).set(counts.get(state, 0))
        self._write_status()

    # -------------------------------------------------------- autoscale

    def _live_workers(self) -> List[WorkerSlot]:
        """The slots serving or about to (up, starting, backoff; not
        retiring): the count the band governs.  A list, because the plane's
        threads read `slots` while a scale-up adds to it."""
        return [s for s in list(self.slots.values())
                if s.state in ("up", "starting", "backoff") and not s.retiring]

    def _autoscale_tick(self, now: float) -> None:
        """One evaluation: the plane's merged signals through the policy,
        at most one step.  Up: a fresh slot (wN never comes back).  Down:
        the newest live `up` worker drains (SIGTERM; it finishes its claims
        and exits), never below workers_min running workers (a slot in
        backoff or starting counts as live for the policy, not for the
        floor)."""
        if self._autoscaler is None or self._draining or self.plane is None:
            return
        from ..utils.metrics import REGISTRY

        signals = self.plane.last_signals()
        if signals is None:
            return
        live = self._live_workers()
        REGISTRY.gauge("zkp2p_fleet_workers_target").set(len(live))
        decision = self._autoscaler.update(now, len(live), signals)
        if decision is None:
            return
        if decision["direction"] == "up":
            wid = f"w{self._next_widx}"
            self._next_widx += 1
            slot = self.slots[wid] = WorkerSlot(wid=wid)
            self._spawn(slot)
            n_after = len(live) + 1
        else:
            candidates = [s for s in live if s.state == "up" and s.proc is not None and not s.governor_deadline]
            if not candidates or len(candidates) - 1 < self.workers_min:
                return
            victim = max(candidates, key=lambda s: int(s.wid[1:]) if s.wid[1:].isdigit() else 0)
            try:
                victim.proc.send_signal(signal.SIGTERM)
            except OSError:
                return
            victim.state = "retiring"
            victim.retiring = True
            victim.scale_deadline = now + (self.drain_timeout_s or 10.0)
            wid = victim.wid
            n_after = len(live) - 1
        REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": f"scale_{decision['direction']}"}).inc()
        REGISTRY.gauge("zkp2p_fleet_workers_target").set(n_after)
        event = {"ts": round(now, 3), "direction": decision["direction"], "reason": decision["reason"],
                 "worker": wid, "workers": n_after}
        self._scale_events.append(event)
        self.log(f"autoscale: {decision['direction']} ({decision['reason']}) — {wid}, fleet now targets {n_after} "
                 f"worker(s) in [{self.workers_min}, {self.workers_max}]")

    def status(self) -> Dict:
        workers = {}
        # a list: the plane's threads call this while a scale-up adds a slot
        for slot in list(self.slots.values()):
            hb = self._hb(slot) or {}
            age = self._hb_age_s(slot)
            workers[slot.wid] = {
                "pid": slot.proc.pid if slot.proc is not None else None,
                "state": slot.state,
                "restarts": slot.restarts,
                "last_rc": slot.last_rc,
                # the worker's bound endpoint port: its /status, /metrics,
                # /healthz and /snapshot are at 127.0.0.1:<port>
                "port": hb.get("port"),
                "rss_mb": hb.get("rss_mb"),
                "hb_age_s": round(age, 3) if age is not None else None,
                "hb_state": hb.get("state"),
                "degraded": hb.get("degraded", False),
            }
            # the worker's last scheduler decisions and its perf sentry's
            # counters, from its heartbeat
            if hb.get("sched"):
                workers[slot.wid]["sched"] = hb["sched"]
            if hb.get("perf"):
                workers[slot.wid]["perf"] = hb["perf"]
        sched_block: Dict = {"autoscale": self.autoscale}
        if self.autoscale:
            sched_block.update({
                "workers_min": self.workers_min, "workers_max": self.workers_max,
                "workers_live": len(self._live_workers()), "scale_events": len(self._scale_events),
                "last_scale": self._scale_events[-1] if self._scale_events else None,
                # every grow and shrink of the run (the newest 50)
                "events": list(self._scale_events[-50:]),
            })
        return {
            "type": "fleet_status",
            "fleet_id": self.fleet_id,
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "spool": self.spool,
            "workers": workers,
            "sched": sched_block,
            "drain_timeout_s": self.drain_timeout_s,
            "escalations": self.escalations,
            "watchdog_kills": self.watchdog_kills,
            "draining": self._draining,
        }

    def _write_status(self) -> None:
        # with the plane on, status.json is what its /status serves
        status = None
        if self.plane is not None:
            try:
                status = self.plane.status_payload()
            except Exception:  # noqa: BLE001 — status.json always lands
                status = None
        _atomic_write_json(os.path.join(self.fleet_dir, "status.json"), status or self.status())

    # ------------------------------------------------------------ drain

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """SIGTERM every live worker and wait, up to the timeout, for their
        exits; SIGKILL the stragglers (counted).  True when none needed
        it."""
        from ..utils.metrics import REGISTRY

        timeout = timeout_s if timeout_s is not None else self.drain_timeout_s
        self._draining = True
        live = [s for s in self.slots.values() if s.proc is not None and s.proc.poll() is None]
        for slot in live:
            # a retiring worker has its SIGTERM already: a second one while
            # it drains means "exit now" and would strand its claims
            if slot.retiring:
                continue
            slot.state = "draining"
            try:
                slot.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        self.log(f"draining {len(live)} worker(s), timeout {timeout:g}s")
        deadline = time.time() + max(timeout, 0.0)
        clean = True
        for slot in live:
            try:
                slot.proc.wait(timeout=max(deadline - time.time(), 0.05))
            except subprocess.TimeoutExpired:
                clean = False
                self.escalations += 1
                REGISTRY.counter("zkp2p_fleet_drain_escalations_total").inc()
                self.log(f"{slot.wid}: drain timed out — SIGKILL")
                self._kill(slot)
                try:
                    slot.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            slot.last_rc = slot.proc.returncode
            slot.state = "done"
        self._write_status()
        return clean

    def stop(self) -> None:
        """Ask run() to drain and return."""
        self._stop.set()

    # -------------------------------------------------------------- run

    def run(self, poll_s: float = 0.25, max_seconds: Optional[float] = None, install_signals: bool = True) -> int:
        """Supervise until every worker is done or parked, a signal (or
        stop()) asks for a drain, or `max_seconds` pass (then drain).
        Returns 0 (clean), 3 (the final drain escalated: requests may have
        been stranded mid-prove; recovered governor escalations do not
        count) or 4 (every worker parked)."""
        if install_signals:
            def _handler(signum, _frame):
                self.log(f"signal {signum}: draining the fleet")
                self._stop.set()

            try:
                signal.signal(signal.SIGTERM, _handler)
                signal.signal(signal.SIGINT, _handler)
            except ValueError:
                pass  # not the main thread: the caller uses stop()
        self.start()
        deadline = (time.time() + max_seconds) if max_seconds else None
        while not self._stop.is_set():
            self.tick()
            if {s.state for s in self.slots.values()} <= {"done", "parked"}:
                break
            if deadline is not None and time.time() > deadline:
                self.log("max-seconds expired: draining")
                break
            self._stop.wait(poll_s)
        clean = self.drain()
        self.tick()
        if self.plane is not None:
            # a last view into status.json (an alert that fired mid-run
            # stays on record), then the scrape thread stops and the port
            # is released
            try:
                self.plane.scrape_once()
            except Exception:  # noqa: BLE001
                pass
            self._write_status()
            self.plane.stop()
        parked = sum(1 for s in self.slots.values() if s.state == "parked")
        if parked:
            self.log(f"{parked} worker(s) parked by the circuit breaker")
        if parked == len(self.slots):
            return 4
        return 0 if clean else 3
