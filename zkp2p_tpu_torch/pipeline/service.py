"""The batched proving service on one NVIDIA GPU (port of the reference's
``pipeline/service.py``): spool -> witness || prove -> verify a sample
-> emit, many witnesses against one resident key.

Each request ends in exactly one of
  done | error-bad-input | error-failed-to-prove |
  error-deadline-exceeded | error-shed
with its artifact beside it in the spool (no silent drops), and every
batch's first proof is verified before the batch is emitted.

Requests are JSON files in a spool directory: <name>.req.json in,
<name>.proof.json and <name>.public.json, or <name>.error.json, out.
Workers sharing a spool partition it by O_EXCL <name>.claim files; a
claim older than `stale_claim_s` is a dead worker's and is taken over.
Failures are handled in layers:

  transient retries (bounded, exponential backoff)
    -> batch bisection (a poisoned request ends in an error alone; its
       batchmates still end `done`, <= log2(S) extra proves each)
      -> the degradation ladder (only for a prover that opts in)
        -> error-failed-to-prove

plus per-request deadlines (the payload's `deadline_s` or the
service's, checked at claim and again at batch assembly) and a spool
backlog cap that sheds load visibly.  Every layer can be made to fail
on demand through the injection sites of ``utils.faults``.

Admission and batching have two arms (`sched`).  "off", the default, is
the static path: fixed `batch_size` slices in scan order, the newest
shed beyond the cap.  "adaptive" hands each sweep to
``pipeline.sched.BatchController``: priority lanes (a payload's
`priority`, "interactive" or "bulk"), shedding by predicted deadline
miss, batches sized against the deadline or objective, and the
calibration fed by each batch's wall seconds.

The reference reads its policy from its environment; here each setting
is a keyword of ``ProvingService`` with the reference's default, and
nothing reads the environment.  The default prover is
``prove_gpu_batch`` on the card.  ``run`` serves the Prometheus endpoint
when given a port (``utils.metrics``), logs the preflight, and, as a
fleet worker (``pipeline.fleet``), writes its heartbeat and applies the
supervisor's soft degrade.

The perf sentry (``utils.perfledger``) checks every span of a terminal
request against the stage budgets of the card's ledger in `cache_dir`
(``zkp2p_stage_budget_overruns_total{stage}``; the heartbeat's `perf`
block), and ``run`` stamps one ledger entry of the run's span costs at
exit.  With `flame` on, an overrun starts an overrun-triggered capture of
the flame sampler (``utils.flameprof``) over the next `flame_capture_n`
sweeps, written beside the ledger.
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import queue
import re
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..formats.proof_json import dump, proof_to_json, public_to_json
from ..prover.groth16_gpu import prove_gpu_batch
from ..snark.groth16 import verify
from ..utils import flameprof, perfledger
from ..utils.audit import execution_digest, preflight, sample_device_memory
from ..utils.device import resolve_device
from ..utils.faults import FaultInjected, fault_point, faults_arm
from ..utils.metrics import REGISTRY, JsonlSink, maybe_start_metrics_server, run_id
from ..utils.slo import default_tracker, publish_slo, slo_arm, timeseries_arm
from ..utils.trace import drain as drain_trace, set_context, trace

# Every request ends in exactly one of these, recorded as a
# .proof.json / .error.json artifact, a request record and a
# requests_total{state} count.
TERMINAL_STATES = (
    "done",
    "error-bad-input",
    "error-failed-to-prove",
    "error-deadline-exceeded",
    "error-shed",
)

# A torn .req.json younger than this is left alone for one more sweep (a
# non-atomic uploader may still be writing it) before the sweep judges
# it corrupt and ends it error-bad-input.
TORN_REQ_GRACE_S = 2.0

# The degradation ladder's rungs, in the reference's order and under its
# names.  The reference overlays its native prover's knobs through the
# environment for one attempt a rung; no prover of the port reads those
# knobs, so a prover that opts in (`reads_msm_knobs`) is called with the
# rung's name instead: prover(dpk, witnesses, rung=name).
DEGRADATION_RUNGS = ("no-precomp", "no-multi", "no-batch-affine", "sequential")

# Text that marks an exception transient (worth a retry) where its type
# alone does not: allocator and pool exhaustion surface as RuntimeError
# text (a CUDA out-of-memory error reads "CUDA out of memory").  Word
# bounded, so that "spool" or a path never matches; an illegal address or
# a failed launch matches nothing and is never retried.
_TRANSIENT_RE = re.compile(
    r"\balloc\w*\b|\bpool\b|\bout of memory\b|\btemporarily unavailable\b|\bresource exhausted\b"
)

# OSError errnos of pressure that can clear (disk, descriptors, memory,
# interruption).  The rest of the class (ENOENT, EACCES, ...) is the
# payload's fault: a request naming a missing file ends error-bad-input.
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "ENOSPC", "EDQUOT", "EIO", "EAGAIN", "EWOULDBLOCK", "EINTR",
        "EMFILE", "ENFILE", "ENOMEM", "EBUSY", "ETIMEDOUT",
    )
    if hasattr(errno, name)
)

# Live requests a batch handed to the prover (upper bounds; +Inf implicit)
BATCH_FILL_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64)


@contextlib.contextmanager
def _lifespan(reqs, name: str, **attrs):
    """A lifecycle span over every request in `reqs` (one Request or a
    list): one shared wall-clock [t0, t0 + ms] interval appended to each
    request's `spans`, written with its next record.  Wall clock, so that
    spans share the spool's arrival clock (the request file's mtime)."""
    t0 = time.time()
    try:
        yield
    finally:
        rec = {"name": name, "t0": round(t0, 6), "ms": round((time.time() - t0) * 1e3, 3)}
        rec.update(attrs)
        for r in (reqs if isinstance(reqs, (list, tuple)) else (reqs,)):
            r.spans.append(dict(rec))


def scan_spool(spool: str, now: float, window_s: float, stale_claim_s: float) -> Dict:
    """One pass over a spool's queue state: arrivals inside the trailing
    `window_s` (counted before the terminal skip: a request that arrived
    and finished inside the window is still offered load), the open
    backlog, and its split into claimable and in flight by claim
    freshness.  An unreadable spool reads as zeros."""
    arrivals = backlog = claimable = in_flight = 0
    try:
        names = set(os.listdir(spool))
    except OSError:
        return {"arrivals": 0, "backlog": 0, "claimable": 0, "in_flight": 0}
    for fn in names:
        if not fn.endswith(".req.json"):
            continue
        base = fn[: -len(".req.json")]
        try:
            if window_s > 0 and now - os.path.getmtime(os.path.join(spool, fn)) <= window_s:
                arrivals += 1
        except OSError:
            pass
        if base + ".proof.json" in names or base + ".error.json" in names:
            continue
        backlog += 1
        fresh = False
        if base + ".claim" in names:
            try:
                fresh = now - os.path.getmtime(os.path.join(spool, base + ".claim")) < stale_claim_s
            except OSError:
                pass
        if fresh:
            in_flight += 1
        else:
            claimable += 1
    return {"arrivals": arrivals, "backlog": backlog, "claimable": claimable, "in_flight": in_flight}


def spool_terminal(spool: str) -> bool:
    """True when every request in `spool` has a terminal artifact (an
    unreadable spool reads as not terminal)."""
    try:
        names = set(os.listdir(spool))
    except OSError:
        return False
    for fn in names:
        if not fn.endswith(".req.json"):
            continue
        base = fn[: -len(".req.json")]
        if base + ".proof.json" not in names and base + ".error.json" not in names:
            return False
    return True


def _is_transient(exc: BaseException) -> bool:
    """Transient = a retry may succeed: injected faults, memory pressure
    and the exhaustion slice of OSError.  Everything else (bad witnesses,
    missing files, a wrong proof count, a failed sample verify, a CUDA
    launch error) is permanent and goes straight to isolation: a
    permanent failure classed transient would be re-claimed and failed
    again every sweep, never reaching a terminal state."""
    if isinstance(exc, (FaultInjected, MemoryError)):
        return True
    if isinstance(exc, OSError) and exc.errno is not None:
        return exc.errno in _TRANSIENT_ERRNOS
    if isinstance(exc, (RuntimeError, OSError)):
        # other types never match the text: a ValueError that mentions
        # "resource" is a bad payload, not load
        return _TRANSIENT_RE.search(str(exc).lower()) is not None
    return False


@dataclass
class Request:
    path: str
    payload: Dict
    witness: Optional[list] = None
    error: Optional[str] = None
    # the spool base name (unique, stable across takeovers) and the claim time
    rid: str = ""
    t_claim: float = 0.0
    # the deadline's anchor: the request file's mtime (the spool's arrival
    # clock, which survives crashes and takeovers)
    t_submit: float = 0.0
    # the terminal state assigned this sweep (None = still open), and the
    # deliberate non-terminal outcome: a deferred request released its
    # claim for a later sweep (a transient emit or witness failure)
    done: Optional[str] = None
    deferred: bool = False
    # the degradation rung that rescued the prove (None = the first try)
    degraded_rung: Optional[str] = None
    # the slot of the batch the request was claimed into (records keep it
    # across bisection), and the batch size intended when it was assembled
    batch_index: Optional[int] = None
    batch_target: Optional[int] = None
    # the priority lane, "interactive" or "bulk" (the adaptive arm batches
    # interactive first; the static arm ignores it)
    priority: str = "bulk"
    # this sweep's lifecycle spans, written with every record it emits
    spans: List[Dict] = field(default_factory=list)


class TimeseriesSampler:
    """One `{"type": "timeseries", ...}` line every `interval_s` (0 = off)
    in the service's sink: ts / run_id / pid, window_s, arrivals and
    arrival_rate_hz, backlog / claimable / in_flight (``scan_spool``),
    batch_fill_last and batch_size_target (the newest batch's live size
    and the size intended for it), counters (the service's cumulative
    counters), slo (the tracker's snapshot), hbm_* (device memory; on the
    card only) and `identity`'s worker and fleet where set."""

    def __init__(self, interval_s: float, stale_claim_s: float = 300.0, identity: Optional[Dict[str, str]] = None):
        self.interval_s = interval_s
        self.stale_claim_s = stale_claim_s
        self.identity = {k: v for k, v in (identity or {}).items() if v}
        self.batch_fill_last = 0
        self.batch_target_last = 0
        self._last_ts: Optional[float] = None

    def maybe_sample(self, spool: str, sink: JsonlSink) -> Optional[Dict]:
        """Sample when the interval has passed: returns the record, also
        written to `sink`, or None when off or not due.  A failure reads
        as None: a sample must never stop a sweep."""
        if self.interval_s <= 0:
            return None
        now = time.time()
        if self._last_ts is not None and now - self._last_ts < self.interval_s:
            return None
        try:
            window_s = (now - self._last_ts) if self._last_ts is not None else self.interval_s
            self._last_ts = now
            scan = scan_spool(spool, now, window_s, self.stale_claim_s)
            rec: Dict = {
                "type": "timeseries",
                "ts": round(now, 3),
                "run_id": run_id(),
                "pid": os.getpid(),
                "window_s": round(window_s, 3),
                "arrival_rate_hz": round(scan["arrivals"] / window_s, 4) if window_s > 0 else 0.0,
                "batch_fill_last": self.batch_fill_last,
                "batch_size_target": self.batch_target_last,
                **scan,
                **self.identity,
            }
            counters: Dict[str, float] = {}
            for m in REGISTRY.snapshot():
                name = m["name"]
                if not name.startswith("zkp2p_service_") or m["kind"] != "counter":
                    continue
                key = name[len("zkp2p_service_"):]
                if key.endswith("_total"):
                    key = key[: -len("_total")]
                if m["labels"]:
                    key += "_" + "_".join(str(v) for v in m["labels"].values())
                counters[key] = counters.get(key, 0) + m["value"]
            rec["counters"] = counters
            REGISTRY.gauge("zkp2p_service_backlog").set(scan["backlog"])
            REGISTRY.gauge("zkp2p_service_in_flight").set(scan["in_flight"])
            rec["slo"] = publish_slo()
            mem = sample_device_memory("service/timeseries")
            if mem is not None:
                rec["hbm_bytes_in_use"] = mem["bytes_in_use"]
                rec["hbm_peak_bytes"] = mem["peak_bytes_in_use"]
            sink.write(rec)
            return rec
        except Exception:  # noqa: BLE001 — the sweep must not die for a sample
            return None


class ProvingService:
    def __init__(
        self,
        cs,
        dpk,
        vk,
        witness_fn: Callable[[Dict], list],
        public_fn: Callable[[list], list],
        batch_size: int = 4,
        inputs_fn: Optional[Callable[[Dict], tuple]] = None,
        prover_fn: Optional[Callable] = None,
        prefetch: int = 1,
        stale_claim_s: float = 300.0,
        deadline_s: float = 0.0,
        spool_cap: int = 0,
        retries: int = 2,
        retry_backoff_s: float = 0.25,
        sink: Optional[str] = None,
        slo_p95_s: float = 0.0,
        ts_sample_s: float = 10.0,
        device=None,
        metrics_port: Optional[int] = None,
        metrics_addr: str = "127.0.0.1",
        worker_id: str = "",
        fleet_id: str = "",
        fleet_dir: str = "",
        sched: str = "off",
        sched_amort: str = "",
        sched_target_fill: float = 0.8,
        sched_priority_default: str = "bulk",
        worker_tier: str = "",
        amort_points: Optional[Dict[int, float]] = None,
        circuit: str = "",
        perf_ledger: bool = True,
        perf_window: int = perfledger.DEFAULT_WINDOW,
        perf_tolerance: float = perfledger.DEFAULT_TOLERANCE,
        flame: bool = False,
        flame_hz: float = flameprof.DEFAULT_HZ,
        flame_capture_n: int = flameprof.DEFAULT_CAPTURE_N,
        flame_cooldown_s: float = flameprof.DEFAULT_COOLDOWN_S,
        cache_dir: Optional[str] = perfledger.DEFAULT_CACHE_DIR,
    ):
        """witness_fn: payload -> witness (raises on bad input);
        public_fn: witness -> public signals.

        inputs_fn: payload -> (public_inputs, private_inputs); when given,
        the producer runs a batch through ``cs.witness_batch`` and falls
        back to witness_fn a request when the batch fails.
        prover_fn: (dpk, [witness]) -> [Proof]; None: ``prove_gpu_batch``
        on `device`.
        prefetch: ready batches the producer may hold (the witness ||
        prove overlap; 1 = double buffering).
        stale_claim_s: a claim older than this is a dead worker's.
        deadline_s: the default deadline, seconds after the request file's
        mtime (a payload's `deadline_s` overrides it; 0 = none).
        spool_cap: pending requests admitted a sweep; the newest beyond
        it are shed as error-shed (0 = no cap).
        retries / retry_backoff_s: transient-failure retries a batch prove
        and the base of their exponential backoff.
        sink: the JSON-lines file of request records (None: beside the
        spool, <spool>.metrics.jsonl).
        slo_p95_s: the latency objective run() gives the SLO tracker (0 =
        none); ts_sample_s: run()'s time-series interval (0 = off).
        device: where the default prover runs: CUDA unless "cpu"; raises
        here when CUDA is asked for and absent.
        metrics_port / metrics_addr: run()'s Prometheus endpoint (None =
        off; 0 = a port the OS chooses).
        worker_id / fleet_id / fleet_dir: fleet membership, given by the
        supervisor (the reference's ZKP2P_WORKER_ID, _FLEET_ID, _FLEET_DIR):
        records, time-series lines and the endpoint carry the ids, and
        with a fleet_dir run() writes heartbeats there and reads the
        supervisor's control file.
        sched: the admission and batching arm, "adaptive" or "off" (the
        static path; anything else reads as "off"), read each sweep.
        sched_amort / amort_points / sched_target_fill: the adaptive
        controller's cost curve, as an "S:sec,..." spec (which wins) or
        as {S: seconds} measured on this card (which also seeds the
        calibration), and the share of a budget batches are planned to
        (``pipeline.sched.build_controller``; slo_p95_s is its objective).
        sched_priority_default: the lane of a payload without a valid
        `priority` ("interactive" or "bulk").
        worker_tier: the tier this worker advertises in its heartbeat and
        plans for ("sharded" or "native"; anything else reads as native).
        circuit: the label of the ledger's entries and the budgets' circuit
        ("service" when empty).
        perf_ledger / perf_window / perf_tolerance: the perf sentry (off: no
        budgets, no checks, no stamp) and its budgets, the trailing window's
        upper median of a stage's p50 times the tolerance (>= 1).
        flame / flame_hz / flame_capture_n / flame_cooldown_s: whether an
        overrun starts a flame capture, its sampling rate, the sweeps it
        spans and the least seconds between two captures.
        cache_dir: where the ledger and the captures live (None: nowhere,
        the sentry then has no budgets and stamps nothing).
        The defaults are the reference's."""
        if perf_window < 1 or perf_tolerance < 1.0:
            raise ValueError(f"perf_window {perf_window} must be >= 1 and perf_tolerance {perf_tolerance} >= 1.0")
        if flame_hz <= 0 or flame_capture_n < 1 or flame_cooldown_s < 0:
            raise ValueError(f"flame_hz {flame_hz} must be > 0, flame_capture_n {flame_capture_n} >= 1 and "
                             f"flame_cooldown_s {flame_cooldown_s} >= 0")
        self.cs = cs
        self.dpk = dpk
        self.vk = vk
        self.witness_fn = witness_fn
        self.public_fn = public_fn
        self.batch_size = batch_size
        self.inputs_fn = inputs_fn
        self.prover_fn = prover_fn
        self.prefetch = max(1, prefetch)
        self.stale_claim_s = stale_claim_s
        self.deadline_s = deadline_s
        self.spool_cap = spool_cap
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.sink_path = sink
        self.slo_p95_s = slo_p95_s
        self.ts_sample_s = ts_sample_s
        self.device = resolve_device(device)
        self.metrics_port = metrics_port
        self.metrics_addr = metrics_addr
        self._worker_id = worker_id
        self._fleet_id = fleet_id
        self.fleet_dir = fleet_dir
        self.sched = sched
        self.sched_amort = sched_amort
        self.sched_target_fill = sched_target_fill
        self.worker_tier = worker_tier
        self.amort_points = amort_points
        self._priority_default = "interactive" if sched_priority_default == "interactive" else "bulk"
        # the adaptive controller, built at the first adaptive sweep, and
        # the last sweep's decisions, which the fleet heartbeat carries
        self._sched_ctl = None
        self._sched_hb: Optional[Dict] = None
        # set by the governor's soft degrade (pipeline.fleet.apply_soft_degrade)
        self._fleet_degraded = False
        # the perf sentry: the budget book (loaded at the first terminal
        # request), the heartbeat's counters, the run's span costs for the
        # exit stamp
        self.circuit = circuit or "service"
        self.perf_ledger = perf_ledger
        self.perf_window = perf_window
        self.perf_tolerance = perf_tolerance
        self.flame = flame
        self.flame_hz = flame_hz
        self.flame_capture_n = flame_capture_n
        self.flame_cooldown_s = flame_cooldown_s
        self.cache_dir = cache_dir
        self._perf_book = None
        self._perf_lock = threading.Lock()
        self._perf_hb: Optional[Dict] = None
        self._perf_agg: Dict[str, List[float]] = {}
        # the policy, stamped on every request record
        self.knobs = {
            "batch_size": batch_size, "prefetch": self.prefetch, "stale_claim_s": stale_claim_s,
            "deadline_s": deadline_s, "spool_cap": spool_cap, "retries": retries,
            "retry_backoff_s": retry_backoff_s, "slo_p95_s": slo_p95_s, "ts_sample_s": ts_sample_s,
            "device": str(self.device), "sched": sched, "sched_amort": sched_amort,
            "sched_target_fill": sched_target_fill, "sched_priority_default": self._priority_default,
            "worker_tier": worker_tier, "perf_ledger": perf_ledger, "perf_window": perf_window,
            "perf_tolerance": perf_tolerance, "flame": flame, "flame_hz": flame_hz,
            "flame_capture_n": flame_capture_n, "flame_cooldown_s": flame_cooldown_s,
        }
        # per-path rotating sinks; the producer and the consumer thread
        # both emit records, and two sinks for one path would rotate
        # against each other
        self._sinks: Dict[str, JsonlSink] = {}
        self._sinks_lock = threading.Lock()
        # run() installs one; process_dir works without it
        self._sampler: Optional[TimeseriesSampler] = None
        # graceful drain: once set, the producer claims nothing more; the
        # batches already claimed prove, verify and emit, and run() ends
        self._drain = threading.Event()

    def request_drain(self) -> None:
        """Stop claiming, finish the work in flight, then leave run().
        Idempotent; callable from a signal handler."""
        self._drain.set()

    @property
    def draining(self) -> bool:
        return self._drain.is_set()

    def identity(self) -> Dict[str, str]:
        """{"worker", "fleet"}: this process's place in a fleet ("" when
        solo)."""
        return {"worker": self._worker_id, "fleet": self._fleet_id}

    # a heartbeat younger than this marks a live fleet peer (a beat every
    # ~5 s: three beats of slack before a peer stops counting)
    _PEER_HB_FRESH_S = 15.0

    def _live_peers(self) -> int:
        """Live workers on this spool, this one included, from the fresh
        heartbeat files in the fleet dir: the scheduler's parallelism (N
        workers pull one queue, and a worker that predicted as if it served
        the backlog alone would shed what its peers could still serve).
        Solo (no fleet dir) or an unreadable dir: 1."""
        if not self.fleet_dir:
            return 1
        n = 0
        now = time.time()
        try:
            for fn in os.listdir(self.fleet_dir):
                if not fn.endswith(".hb"):
                    continue
                try:
                    if now - os.path.getmtime(os.path.join(self.fleet_dir, fn)) < self._PEER_HB_FRESH_S:
                        n += 1
                except OSError:
                    pass
        except OSError:
            return 1
        return max(1, n)

    def _live_peer_tiers(self) -> List[str]:
        """The tiers the live peers advertise (this worker left out), from
        the `tier` of fresh heartbeats: the scheduler's tier routing.  Solo,
        or heartbeats without a readable tier: [] (both lanes served here,
        never a starved lane)."""
        if not self.fleet_dir:
            return []
        mine = (self._worker_id or "") + ".hb"
        tiers: List[str] = []
        now = time.time()
        try:
            for fn in os.listdir(self.fleet_dir):
                if not fn.endswith(".hb") or fn == mine:
                    continue
                path = os.path.join(self.fleet_dir, fn)
                try:
                    if now - os.path.getmtime(path) >= self._PEER_HB_FRESH_S:
                        continue
                    with open(path) as f:
                        hb = json.load(f)
                    tier = hb.get("tier")
                    if isinstance(tier, str) and tier:
                        tiers.append(tier)
                except (OSError, ValueError):
                    pass  # a torn heartbeat: a peer for parallelism, not for routing
        except OSError:
            return []
        return tiers

    def _sched_controller(self):
        """The adaptive controller, built once a service (its curve and
        objective cannot change under a running service; the arm is read
        each sweep): ``pipeline.sched.build_controller`` over sched_amort,
        amort_points, slo_p95_s, sched_target_fill and worker_tier."""
        if self._sched_ctl is None:
            from .sched import build_controller

            self._sched_ctl = build_controller(self.sched_amort, self.amort_points, self.slo_p95_s,
                                               self.sched_target_fill, self.worker_tier)
        return self._sched_ctl

    # -------------------------------------------------------- observability
    #
    # Every request's terminal transition is recorded: one JSON line (the
    # request id, its state, claim -> terminal ms, run_id / pid, the
    # policy) in a rotating sink beside the spool.

    def _sink(self, spool: str) -> JsonlSink:
        with self._sinks_lock:
            path = self.sink_path or (spool.rstrip("/") + ".metrics.jsonl")
            s = self._sinks.get(path)
            if s is None:
                s = self._sinks[path] = JsonlSink(path)
            return s

    def _emit_record(self, spool: str, req: Request, state: str, batch_index: Optional[int] = None,
                     batch_n: Optional[int] = None, **extra) -> None:
        try:
            fault_point("sink")
            rec = {
                "type": "request",
                "ts": round(time.time(), 3),
                "run_id": run_id(),
                "pid": os.getpid(),
                "request_id": req.rid,
                "state": state,
                "ms": round((time.time() - req.t_claim) * 1e3, 3) if req.t_claim else None,
                "knobs": self.knobs,
                # which code paths this process has run: two records are
                # comparable only when their digests match
                "execution_digest": execution_digest(),
            }
            # which worker of which fleet: pids recycle across restarts,
            # worker ids do not
            rec.update((k, v) for k, v in self.identity().items() if v)
            # the slot of the batch this request rode: one service/prove
            # span covers a batch's records
            if batch_index is not None:
                rec["batch_index"] = batch_index
            if batch_n is not None:
                rec["batch_n"] = batch_n
            if req.batch_target is not None:
                rec["batch_size_target"] = req.batch_target
            # the waterfall: arrival and claim times, the queue wait they
            # bound (from the request file's mtime, so across deferrals it
            # is the whole wait) and this sweep's spans
            if req.t_submit:
                rec["t_submit"] = round(req.t_submit, 6)
            if req.t_claim:
                rec["t_claim"] = round(req.t_claim, 6)
                if req.t_submit:
                    rec["queue_wait_s"] = round(max(0.0, req.t_claim - req.t_submit), 6)
            if req.spans:
                rec["spans"] = req.spans
            if extra:
                rec.update(extra)
            if req.error:
                rec["error"] = req.error[:500]
            # device memory at terminal time; the peak is the allocator's
            # since its last reset (absent on the CPU)
            mem = sample_device_memory("service/request")
            if mem is not None:
                rec["hbm_peak_bytes"] = mem["peak_bytes_in_use"]
                rec["hbm_bytes_in_use"] = mem["bytes_in_use"]
            self._sink(spool).write(rec)
        except Exception:  # noqa: BLE001 — a record must never fail a prove
            pass
        if state in TERMINAL_STATES:
            REGISTRY.counter("zkp2p_service_requests_total", {"state": state}).inc()
            # the whole life, spool arrival -> terminal (claim time for a
            # torn upload with no arrival mtime); only `done` is good
            anchor = req.t_submit or req.t_claim
            if anchor:
                default_tracker().observe(time.time() - anchor, ok=(state == "done"))
            # the perf sentry: this request's spans against the stage budgets
            try:
                self._perf_check(req)
            except Exception:  # noqa: BLE001 — observation never fails a request
                pass
        else:
            REGISTRY.counter("zkp2p_service_deferred_total").inc()

    def _perf_check(self, req: Request) -> None:
        """Check one terminal request's spans against the ledger's stage
        budgets (the book loaded once, then dict lookups).  A span over its
        budget counts in zkp2p_stage_budget_overruns_total{stage} and, with
        `flame` on, triggers a capture that names the budget's ledger head;
        every span also pools into the exit stamp.  The counts ride the
        heartbeat's `perf` block."""
        book = self._perf_book
        if book is None:
            path = perfledger.ledger_path(self.cache_dir, self.device) if self.perf_ledger else None
            book = self._perf_book = perfledger.BudgetBook.load(self.circuit, path, window=self.perf_window,
                                                     tolerance=self.perf_tolerance, perf_ledger=self.perf_ledger,
                                                     device=self.device)
            REGISTRY.gauge("zkp2p_perf_budget_stages").set(float(len(book)))
        if not req.spans:
            return
        overruns = checked = 0
        with self._perf_lock:
            for sp in req.spans:
                name, ms = sp.get("name"), sp.get("ms")
                if not name or ms is None:
                    continue
                self._perf_agg.setdefault(name, []).append(float(ms))
                verdict = book.over(name, ms)
                if verdict is None:
                    continue  # no budget for this stage: never counts
                checked += 1
                if verdict:
                    overruns += 1
                    REGISTRY.counter("zkp2p_stage_budget_overruns_total", {"stage": name}).inc()
                    if self.flame:
                        flameprof.controller().trigger(
                            self.circuit, name, self.cache_dir, entry_digest=book.head_digest(name),
                            budget_ms=book.budget_ms(name), over_ms=float(ms), hz=self.flame_hz,
                            capture_n=self.flame_capture_n, cooldown_s=self.flame_cooldown_s)
            if self._perf_hb is None:
                self._perf_hb = {"overruns": 0, "checked": 0, "budgets": len(book)}
            self._perf_hb["overruns"] += overruns
            self._perf_hb["checked"] += checked

    def _perf_stamp(self) -> Optional[str]:
        """The exit stamp: one source="service" ledger entry of this run's
        terminal-request span costs (p50 / p95 a stage), when the ledger is
        on; returns its path."""
        with self._perf_lock:
            agg, self._perf_agg = self._perf_agg, {}
        stages = {name: st for name, samples in agg.items()
                  for st in [perfledger.stage_stats(samples)] if st is not None}
        return perfledger.record("service", self.circuit, stages, run_id=run_id(), perf_ledger=self.perf_ledger,
                      cache_dir=self.cache_dir, device=self.device)

    def _record_deferred(self, spool: str, req: Request, reason: object, batch_index: Optional[int] = None,
                         batch_n: Optional[int] = None) -> None:
        """Record a non-terminal outcome: the claim was released for a
        later sweep.  One `state="deferred"` line an attempt, with that
        attempt's spans, so the request's history survives."""
        self._emit_record(spool, req, "deferred", batch_index=batch_index, batch_n=batch_n,
                          deferred_reason=str(reason)[:200])

    # ------------------------------------------------------------- claims
    #
    # A worker that dies mid-prove leaves a .claim file and no terminal
    # output; any later sweep (the same worker restarted, or a peer) takes
    # the request over once the claim is stale.  Terminal outputs always
    # win over claims, so a finished request is never processed again.

    def _try_claim(self, base_path: str) -> bool:
        # terminal outputs are checked again at claim time: a peer may have
        # finished this request between our scan and now
        if os.path.exists(base_path + ".proof.json") or os.path.exists(base_path + ".error.json"):
            return False
        claim = base_path + ".claim"
        try:
            fault_point("claim")
            fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(claim)
            except OSError:
                return False  # vanished: its owner just finished
            if age < self.stale_claim_s:
                return False
            # a stale claim is stolen by renaming it aside: rename is
            # atomic, so exactly one taker wins (the others get ENOENT);
            # the winner then creates the claim anew with its own pid
            stale_aside = f"{claim}.stale.{os.getpid()}"
            try:
                # refreshed or rewritten since our stat: not ours to steal
                if time.time() - os.path.getmtime(claim) < self.stale_claim_s:
                    return False
                os.rename(claim, stale_aside)
            except OSError:
                REGISTRY.counter("zkp2p_service_takeovers_total", {"result": "lost"}).inc()
                return False
            REGISTRY.counter("zkp2p_service_takeovers_total", {"result": "won"}).inc()
            try:
                os.unlink(stale_aside)
            except OSError:
                pass
            try:
                fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except OSError:
                return False  # another claimer took the freed slot first
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(json.dumps({"pid": os.getpid(), "ts": time.time(), "takeover": True}))
            except OSError:
                pass  # ownership is existence + mtime; the identity is for people
            # the old owner may have finished inside the steal window:
            # terminal outputs win, so back off
            if os.path.exists(base_path + ".proof.json") or os.path.exists(base_path + ".error.json"):
                self._release_claim(base_path)
                return False
            return True
        except (OSError, FaultInjected):
            # a claim that cannot be written (a full disk, an injected
            # fault) is simply not ours this sweep
            return False
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps({"pid": os.getpid(), "ts": time.time()}))
        except OSError:
            pass
        # a peer may have emitted and released between the check above and
        # our O_EXCL create
        if os.path.exists(base_path + ".proof.json") or os.path.exists(base_path + ".error.json"):
            self._release_claim(base_path)
            return False
        return True

    @staticmethod
    def _release_claim(base_path: str) -> None:
        try:
            os.unlink(base_path + ".claim")
        except OSError:
            pass

    # ---------------------------------------------------------- deadlines

    def _deadline_of(self, req: Request) -> Optional[float]:
        """The request's absolute deadline, or None: the payload's
        `deadline_s`, else the service's, in seconds after the request
        file's mtime.  A malformed payload deadline falls back to the
        service's."""
        d = None
        if isinstance(req.payload, dict):
            d = req.payload.get("deadline_s")
        try:
            d = float(d) if d is not None else None
        except (TypeError, ValueError):
            d = None
        if d is None:
            d = self.deadline_s
        if not d or d <= 0 or not req.t_submit:
            return None
        return req.t_submit + d

    # ------------------------------------------------------ terminal emit

    def _terminal_error(self, spool: str, req: Request, state: str, exc: BaseException, stats: Dict[str, int],
                        batch_index: Optional[int] = None, batch_n: Optional[int] = None) -> bool:
        """End a request in an error state: the .error.json artifact
        (atomic), the claim released, the record, the count.  Returns
        False when the artifact cannot be written (a full disk): the
        request is then left open, its claim released, for a later sweep."""
        req.error = f"{state}: {exc}"
        try:
            self._emit_error(req, state, exc)
        except Exception:  # noqa: BLE001 — the error artifact could not be written
            self._release_claim(req.path)
            req.deferred = True
            self._record_deferred(spool, req, f"error-artifact write failed for {state}", batch_index=batch_index,
                                  batch_n=batch_n)
            return False
        self._emit_record(spool, req, state, batch_index=batch_index, batch_n=batch_n)
        req.done = state
        stats[state] += 1
        return True

    # ------------------------------------------------- resilient proving
    #
    # The retry -> bisect -> degrade ladder.  All of it runs on the
    # consumer thread, under the sweep's claim heartbeat.

    def _prove(self, wits: list, rung: Optional[str] = None) -> list:
        if self.prover_fn is None:
            return prove_gpu_batch(self.dpk, wits, device=self.device)
        if rung is None:
            return self.prover_fn(self.dpk, wits)
        return self.prover_fn(self.dpk, wits, rung=rung)

    def _prove_verified(self, batch: List[Request], attempt: int = 0, rung: Optional[str] = None) -> list:
        """One prover call over `batch` and the sample verify.  Raises on
        any failure, a prover that returns the wrong number of proofs
        among them.  `attempt` / `rung` label the call's span."""
        span_attrs: Dict = {"n": len(batch)}
        if attempt:
            span_attrs["attempt"] = attempt
        if rung:
            span_attrs["rung"] = rung
        with _lifespan(batch, "prove", **span_attrs):
            fault_point("prove")
            with trace("service/prove", n=len(batch), request_ids=[r.rid for r in batch]):
                proofs = self._prove([r.witness for r in batch], rung)
        proofs = list(proofs) if proofs is not None else []
        if len(proofs) != len(batch):
            raise RuntimeError(f"prover returned {len(proofs)} proofs for a batch of {len(batch)}")
        with _lifespan(batch, "verify"):
            fault_point("verify")
            with trace("service/verify"):
                if not verify(self.vk, proofs[0], self.public_fn(batch[0].witness)):
                    raise RuntimeError("sample proof failed verification")
        return proofs

    def _prove_with_retries(self, batch: List[Request]) -> list:
        """Bounded transient-failure retries with exponential backoff;
        permanent failures raise at once."""
        attempt = 0
        while True:
            try:
                return self._prove_verified(batch, attempt=attempt)
            except Exception as e:  # noqa: BLE001 — classified below
                if attempt >= self.retries or not _is_transient(e):
                    raise
                attempt += 1
                REGISTRY.counter("zkp2p_service_retries_total").inc()
                delay = min(self.retry_backoff_s * (2 ** (attempt - 1)), 30.0)
                if delay > 0:
                    with _lifespan(batch, "retry_backoff", attempt=attempt):
                        time.sleep(delay)

    def _degraded_prove(self, batch: List[Request], cause: BaseException):
        """The last resort before error-failed-to-prove: one attempt a
        rung.  Returns (proofs, rung) on the first success and raises the
        last rung's failure.  Only a prover marked `reads_msm_knobs` gets
        the ladder: for any other every rung would run the same prove
        again (the default prover is such a one)."""
        if self.prover_fn is None or not getattr(self.prover_fn, "reads_msm_knobs", False):
            raise cause
        last: BaseException = cause
        for rung in DEGRADATION_RUNGS:
            try:
                proofs = self._prove_verified(batch, rung=rung)
                REGISTRY.counter("zkp2p_service_degraded_total", {"rung": rung}).inc()
                return proofs, rung
            except Exception as e:  # noqa: BLE001 — try the next rung
                last = e
        raise last

    def _prove_isolating(self, spool: str, batch: List[Request], stats: Dict[str, int], batch_n: int) -> None:
        """Prove `batch`, ending every member exactly once: on a failure
        the batch is halved and each half proved again; a single walks
        the ladder before error-failed-to-prove."""
        try:
            proofs = self._prove_with_retries(batch)
        except Exception as e:  # noqa: BLE001 — isolate below
            if len(batch) == 1:
                req = batch[0]
                try:
                    proofs, rung = self._degraded_prove(batch, e)
                    req.degraded_rung = rung
                except Exception as e2:  # noqa: BLE001 — truly failed
                    self._terminal_error(spool, req, "error-failed-to-prove", e2, stats,
                                         batch_index=req.batch_index, batch_n=batch_n)
                    return
            else:
                del e
                REGISTRY.counter("zkp2p_service_bisections_total").inc()
                mid = (len(batch) + 1) // 2
                self._prove_isolating(spool, batch[:mid], stats, batch_n)
                self._prove_isolating(spool, batch[mid:], stats, batch_n)
                return
        self._emit_done_batch(spool, batch, proofs, stats, batch_n)

    def _emit_done_batch(self, spool: str, batch: List[Request], proofs: list, stats: Dict[str, int],
                         batch_n: int) -> None:
        for req, proof in zip(batch, proofs):
            set_context(request_id=req.rid)
            try:
                try:
                    with _lifespan(req, "emit"):
                        fault_point("emit")
                        with trace("service/emit"):
                            # public first, proof last: .proof.json marks
                            # done, so a crash between the two writes
                            # leaves a request to retry, never a proof
                            # without its public signals
                            dump(public_to_json(self.public_fn(req.witness)), req.path + ".public.json")
                            dump(proof_to_json(proof), req.path + ".proof.json")
                except Exception as e:  # noqa: BLE001 — an emit failure is the request's own
                    REGISTRY.counter("zkp2p_service_emit_failures_total").inc()
                    if _is_transient(e):
                        # a full disk: the proof is valid but unrecorded,
                        # and an .error.json would fail the same way, so
                        # the request stays open for a later sweep
                        req.deferred = True
                        self._release_claim(req.path)
                        self._record_deferred(spool, req, f"transient emit failure: {e}",
                                              batch_index=req.batch_index, batch_n=batch_n)
                    else:
                        # a deterministic failure (public_fn raised):
                        # deferring would re-prove it forever
                        self._terminal_error(spool, req, "error-failed-to-prove", e, stats,
                                             batch_index=req.batch_index, batch_n=batch_n)
                    continue
            finally:
                set_context(request_id=None)
            self._release_claim(req.path)
            extra = {"degraded_rung": req.degraded_rung} if req.degraded_rung else {}
            self._emit_record(spool, req, "done", batch_index=req.batch_index, batch_n=batch_n, **extra)
            req.done = "done"
            stats["done"] += 1

    # ---------------------------------------------------------- scheduler

    def _sched_sweep(self, spool: str, pending: List[Request], stats: Dict[str, int]) -> List[List[Request]]:
        """The adaptive arm's plan of a sweep (``pipeline.sched``): the
        arrival EWMA, the shed verdicts (claimed and ended error-shed, each
        counted), the lane-sorted batches; and its telemetry: the
        zkp2p_sched_batch_size gauge, zkp2p_sched_decisions_total{kind},
        one {"type": "sched"} line in the sink, the heartbeat's block."""
        from .sched import SchedRequest

        ctl = self._sched_controller()
        now = time.time()
        by_rid: Dict[str, Request] = {r.rid: r for r in pending}
        sreqs = [SchedRequest(rid=r.rid, t_submit=r.t_submit, deadline=self._deadline_of(r),
                              interactive=(r.priority == "interactive"))
                 for r in pending]
        peers = self._live_peers()
        peer_tiers = self._live_peer_tiers()
        # never shed while draining; the peers share the queue; the peers'
        # tiers route the lanes (a deferred request stays unclaimed)
        plan = ctl.plan(now, sreqs, cap=max(1, self.batch_size), spool_cap=self.spool_cap or 0,
                        allow_shed=not self._drain.is_set(), parallelism=peers, peer_tiers=peer_tiers)
        backlog = len(pending)
        for sr, reason in plan.shed:
            r = by_rid[sr.rid]
            if not self._try_claim(r.path):
                continue  # a peer is on it: not ours to shed
            r.t_claim = time.time()
            # counted only when the terminal lands (a failed artifact write
            # defers the request, as on the static arm)
            if self._terminal_error(spool, r, "error-shed", RuntimeError(f"sched: {reason} (backlog {backlog})"),
                                    stats):
                REGISTRY.counter("zkp2p_service_shed_total").inc()
                REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": "shed"}).inc()
        REGISTRY.gauge("zkp2p_sched_batch_size").set(plan.batch_target)
        if plan.batches:
            REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": "batch"}).inc(len(plan.batches))
        if plan.lanes.get("interactive"):
            REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": "lane"}).inc()
        if plan.deferred:
            # a decision a sweep and lane, not a count of requests
            REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": "defer"}).inc(len(plan.deferred))
        if plan.tier_fallback:
            REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": "tier_fallback"}).inc()
        if self._sampler is not None:
            self._sampler.batch_target_last = plan.batch_target
        self._sched_hb = {
            "mode": "adaptive", "batch_target": plan.batch_target, "interactive_target": plan.interactive_target,
            "lane_interactive": plan.lanes.get("interactive", 0), "lane_bulk": plan.lanes.get("bulk", 0),
            "rate_hz": plan.rate_hz, "peers": peers, "tier": plan.tier,
        }
        if plan.deferred:
            self._sched_hb["deferred"] = dict(plan.deferred)
        if pending:
            # one decision line a sweep with work, beside the records it shaped
            try:
                rec: Dict = {
                    "type": "sched", "ts": round(now, 3), "run_id": run_id(), "pid": os.getpid(),
                    "backlog": backlog, "rate_hz": plan.rate_hz, "oldest_wait_s": plan.oldest_wait_s,
                    "batch_target": plan.batch_target, "batch_reason": plan.batch_reason,
                    "interactive_target": plan.interactive_target, "lanes": plan.lanes,
                    "batches": len(plan.batches), "shed": len(plan.shed), "peers": peers, "tier": plan.tier,
                }
                if peer_tiers:
                    rec["peer_tiers"] = peer_tiers
                if plan.deferred:
                    rec["deferred"] = dict(plan.deferred)
                if plan.tier_fallback:
                    rec["tier_fallback"] = True
                rec.update((k, v) for k, v in self.identity().items() if v)
                self._sink(spool).write(rec)
            except Exception:  # noqa: BLE001 — a record must never stop a sweep
                pass
        return [[by_rid[sr.rid] for sr in b] for b in plan.batches]

    # ------------------------------------------------------------ one pass

    def process_dir(self, spool: str) -> Dict[str, int]:
        """One sweep of `spool`; returns the count of each terminal state
        reached."""
        stats = {s: 0 for s in TERMINAL_STATES}
        # draining before the sweep starts: claim nothing, scan nothing
        if self._drain.is_set():
            return stats
        from ..utils.audit import gate_arms
        from .sched import normalize_sched, sched_arm

        # the arm, read each sweep (one service can run both) and recorded
        # when it differs from the process's: the digest follows it, and an
        # idle service's counters stay still (the fleet plane's parity)
        arm = normalize_sched(self.sched)
        if gate_arms().get("service_sched") != arm:
            sched_arm(arm)
        adaptive = arm == "adaptive"
        pending: List[Request] = []
        for fn in sorted(os.listdir(spool)):
            if ".claim.stale." in fn:
                # a taker killed between its rename and its unlink leaves
                # this behind, and nothing else matches the name
                p = os.path.join(spool, fn)
                try:
                    if time.time() - os.path.getmtime(p) > self.stale_claim_s:
                        os.unlink(p)
                except OSError:
                    pass
                continue
            if not fn.endswith(".req.json"):
                continue
            base = fn[: -len(".req.json")]
            if os.path.exists(os.path.join(spool, base + ".proof.json")) or os.path.exists(
                os.path.join(spool, base + ".error.json")
            ):
                self._release_claim(os.path.join(spool, base))
                continue
            # a fresh claim is a peer at work: not claimable, and not
            # backlog either (the cap would shed viable requests off it)
            try:
                if time.time() - os.path.getmtime(os.path.join(spool, base + ".claim")) < self.stale_claim_s:
                    continue
            except OSError:
                pass  # no claim: free for the taking
            fpath = os.path.join(spool, fn)
            try:
                with open(fpath) as f:
                    payload = json.load(f)
            except ValueError as e:
                # a torn or malformed .req.json ends error-bad-input and
                # the sweep goes on; a young one may still be being
                # written, and waits for the next sweep
                try:
                    if time.time() - os.path.getmtime(fpath) < TORN_REQ_GRACE_S:
                        continue
                except OSError:
                    continue  # vanished: nothing to judge
                req = Request(path=os.path.join(spool, base), payload={}, rid=base)
                if self._try_claim(req.path):
                    req.t_claim = time.time()
                    self._terminal_error(spool, req, "error-bad-input", e, stats)
                continue
            except OSError:
                continue  # vanished or unreadable this sweep: the next one retries
            try:
                t_submit = os.path.getmtime(fpath)
            except OSError:
                t_submit = time.time()
            # the lane: the payload's priority, anything else the default (a
            # mistyped priority must not make a third lane)
            prio = payload.get("priority") if isinstance(payload, dict) else None
            if prio not in ("interactive", "bulk"):
                prio = self._priority_default
            pending.append(Request(path=os.path.join(spool, base), payload=payload, rid=base, t_submit=t_submit,
                                   priority=prio))

        # Admission control.  Adaptive: the controller plans the sweep (the
        # shed by predicted miss, the lanes, the sizes).  Static: a backlog
        # beyond the cap is shed newest first (the oldest are nearest their
        # deadlines), each with a visible error-shed.  Never while
        # draining: a peer may still serve them.
        batch_plan: Optional[List[List[Request]]] = None
        if adaptive:
            batch_plan = self._sched_sweep(spool, pending, stats)
        elif self.spool_cap and len(pending) > self.spool_cap and not self._drain.is_set():
            backlog = len(pending)
            pending.sort(key=lambda r: (r.t_submit, r.rid))
            keep, shed = pending[: self.spool_cap], pending[self.spool_cap:]
            for r in shed:
                if not self._try_claim(r.path):
                    continue  # a peer is on it
                r.t_claim = time.time()
                # counted only when the terminal lands: a failed artifact
                # write defers the request, and the next sweep sheds it again
                if self._terminal_error(
                    spool, r, "error-shed",
                    RuntimeError(f"spool backlog {backlog} over admission cap {self.spool_cap}"), stats,
                ):
                    REGISTRY.counter("zkp2p_service_shed_total").inc()
            pending = sorted(keep, key=lambda r: r.rid)
        if not adaptive:
            # the static arm's target is the cap (fill below it is low load)
            if self._sampler is not None:
                self._sampler.batch_target_last = self.batch_size
            self._sched_hb = {"mode": "off", "batch_target": self.batch_size}

        # Witness || prove: a producer thread builds the next batches'
        # witnesses on the host while this thread proves on the card.  The
        # queue holds at most `prefetch` ready batches, so up to
        # prefetch + 1 batches of witnesses are alive at once.
        ready_q: "queue.Queue[Optional[List[Request]]]" = queue.Queue(maxsize=self.prefetch)
        producer_error: List[BaseException] = []

        # The sweep's claim heartbeat refreshes every claim the sweep holds,
        # queued batches' too, so that no claim ages toward a peer's
        # takeover while a slow rescue runs.  Ended and deferred requests
        # drop out: their claims are released already.
        hb_reqs: List[Request] = []
        hb_lock = threading.Lock()
        stop_hb = threading.Event()

        def _sweep_heartbeat():
            while True:
                with hb_lock:
                    reqs = [r for r in hb_reqs if r.done is None and not r.deferred]
                for r in reqs:
                    try:
                        os.utime(r.path + ".claim", None)
                    except OSError:
                        pass
                if stop_hb.wait(max(self.stale_claim_s / 3.0, 0.05)):
                    return

        def scalar_witness(req: Request) -> bool:
            set_context(request_id=req.rid)
            try:
                with trace("service/witness"), _lifespan(req, "witness"):
                    fault_point("witness")
                    req.witness = self.witness_fn(req.payload)
                    self.cs.check_witness(req.witness)
                return True
            except Exception as e:  # noqa: BLE001 — recorded, not silenced
                if _is_transient(e):
                    # not the payload's fault: release the claim for a
                    # later sweep rather than fail a good request
                    REGISTRY.counter("zkp2p_service_retries_total").inc()
                    self._release_claim(req.path)
                    req.deferred = True
                    self._record_deferred(spool, req, f"transient witness failure: {e}")
                    return False
                self._terminal_error(spool, req, "error-bad-input", e, stats)
                return False
            finally:
                set_context(request_id=None)

        def batched_witness(cand: List[Request]) -> List[Request]:
            """Each request's inputs (an error stays the request's), one
            ``witness_batch`` over the batch, each witness checked; a
            failure of the batch falls back to the scalar path."""
            batch: List[Request] = []
            inputs = []
            for req in cand:
                try:
                    set_context(request_id=req.rid)
                    with trace("service/inputs"), _lifespan(req, "inputs"):
                        fault_point("witness")
                        inputs.append(self.inputs_fn(req.payload))
                    batch.append(req)
                except Exception as e:  # noqa: BLE001
                    if _is_transient(e):
                        REGISTRY.counter("zkp2p_service_retries_total").inc()
                        self._release_claim(req.path)
                        req.deferred = True
                        self._record_deferred(spool, req, f"transient inputs failure: {e}")
                    else:
                        self._terminal_error(spool, req, "error-bad-input", e, stats)
                finally:
                    set_context(request_id=None)
            if not batch:
                return []
            try:
                with trace("service/witness_batch", n=len(batch)), _lifespan(batch, "witness_batch", n=len(batch)):
                    ws = self.cs.witness_batch(inputs)
                # every witness gets the Az*Bz = Cz check, as on the scalar
                # path: the consumer verifies only the batch's first proof
                for req, w in zip(batch, ws):
                    self.cs.check_witness(w)
                    req.witness = w
                return batch
            except Exception:  # noqa: BLE001 — the batch path is an optimisation
                return [r for r in batch if scalar_witness(r)]

        def produce():
            try:
                # adaptive: the plan's lane-sorted batches; static: fixed
                # batch_size slices of the scan order
                if batch_plan is not None:
                    slices = batch_plan
                else:
                    slices = [pending[i : i + self.batch_size] for i in range(0, len(pending), self.batch_size)]
                for chunk in slices:
                    # once draining, claim nothing more: the claimed
                    # batches finish under the heartbeat, the rest stays
                    # free for peers
                    if self._drain.is_set():
                        break
                    # the size intended for this batch: the planned chunk's,
                    # or the static cap
                    target = len(chunk) if batch_plan is not None else self.batch_size
                    # claim at dequeue, not at scan: scan-time claims would
                    # age while earlier batches prove
                    cand = []
                    for r in chunk:
                        if not self._try_claim(r.path):
                            continue
                        r.t_claim = time.time()
                        r.batch_target = target
                        with hb_lock:
                            hb_reqs.append(r)  # heartbeat from claim to terminal
                        # deadline gate 1, at claim: before any witness work
                        dl = self._deadline_of(r)
                        if dl is not None and r.t_claim > dl:
                            if self._terminal_error(
                                spool, r, "error-deadline-exceeded",
                                RuntimeError(f"deadline exceeded at claim ({r.t_claim - r.t_submit:.3f}s since submit)"),
                                stats,
                            ):
                                REGISTRY.counter("zkp2p_service_deadline_total").inc()
                            continue
                        cand.append(r)
                    if self.inputs_fn is not None:
                        batch = batched_witness(cand)
                    else:
                        batch = [r for r in cand if scalar_witness(r)]
                    if batch:
                        ready_q.put(batch)
            except BaseException as e:  # noqa: BLE001 — raised again by the consumer
                producer_error.append(e)
            finally:
                # the sentinel goes out even if this thread dies, or the
                # consumer would wait on the queue forever
                ready_q.put(None)

        hb = threading.Thread(target=_sweep_heartbeat, daemon=True)
        hb.start()
        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            self._consume(spool, ready_q, stats)
        finally:
            stop_hb.set()
            hb.join()
        producer.join()
        if producer_error:
            # requests after the failure got no witness and no record this
            # sweep: their claims let a later sweep pick them up
            raise producer_error[0]
        # the flame sweep boundary: a triggered capture spans the next
        # flame_capture_n sweeps; the finished one's pointer rides the
        # heartbeat's perf block
        if flameprof.controller().sweep_tick() is not None:
            ptr = flameprof.controller().pointer()
            with self._perf_lock:
                if self._perf_hb is None:
                    self._perf_hb = {"overruns": 0, "checked": 0, "budgets": 0}
                self._perf_hb["capture"] = ptr
        return stats

    def _consume(self, spool, ready_q, stats) -> None:
        """Take ready batches: the deadline gate, then the prove with the
        whole rescue ladder, ending every request exactly once."""
        while True:
            batch = ready_q.get()
            if batch is None:
                break
            # deadline gate 2, at batch assembly: the wait behind a slow
            # batch may have spent the budget
            live: List[Request] = []
            for req in batch:
                dl = self._deadline_of(req)
                if dl is not None and time.time() > dl:
                    if self._terminal_error(
                        spool, req, "error-deadline-exceeded",
                        RuntimeError(
                            f"deadline exceeded at batch assembly ({time.time() - req.t_submit:.3f}s since submit)"
                        ),
                        stats,
                    ):
                        REGISTRY.counter("zkp2p_service_deadline_total").inc()
                else:
                    live.append(req)
            if not live:
                continue
            for bi, req in enumerate(live):
                req.batch_index = bi
            REGISTRY.histogram("zkp2p_service_batch_fill", buckets=BATCH_FILL_BUCKETS).observe(len(live))
            if self._sampler is not None:
                self._sampler.batch_fill_last = len(live)
            t_batch0 = time.perf_counter()
            try:
                self._prove_isolating(spool, live, stats, batch_n=len(live))
                # the adaptive arm's calibration: the batch's wall seconds
                # against the model's
                if self._sched_ctl is not None:
                    self._sched_ctl.observe_batch(len(live), time.perf_counter() - t_batch0)
            except Exception as e:  # noqa: BLE001 — the safety net
                # _prove_isolating ends every request itself; an exception
                # out of it is a fault in the rescue path, and the requests
                # still open get an honest terminal state
                for req in live:
                    if req.done is None and not req.deferred:
                        self._terminal_error(spool, req, "error-failed-to-prove", e, stats,
                                             batch_index=req.batch_index, batch_n=len(live))

    @classmethod
    def _emit_error(cls, req: Request, state: str, exc: BaseException) -> None:
        # atomic like every terminal artifact; format_exception, because
        # shed and deadline terminals pass an exception never raised
        trace_s = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__, limit=3))
        dump({"state": state, "error": str(exc), "trace": trace_s, "ts": time.time()}, req.path + ".error.json")
        cls._release_claim(req.path)

    # ------------------------------------------------------------- daemon

    @classmethod
    def for_venmo(cls, cs, lay, params, dpk, vk, keys=None, **kw) -> "ProvingService":
        """The service of the flagship circuit: a payload is either
        {"eml_path": ...} (a DKIM-signed email, its key from the known
        keys or `keys`) or the synthetic demo's {"raw_id", "amount",
        "order_id", "claim_id"}."""
        from ..inputs.email import email_from_eml, generate_inputs, make_test_key, make_venmo_email

        demo_key = make_test_key(1)

        def inputs_fn(payload: Dict) -> tuple:
            order_id = int(payload.get("order_id", 1))
            claim_id = int(payload.get("claim_id", 0))
            if "eml_path" in payload:
                with open(payload["eml_path"], "rb") as f:
                    email = email_from_eml(f.read(), keys)  # an unknown key raises
                modulus = email.modulus
            else:
                email = make_venmo_email(demo_key, raw_id=str(payload["raw_id"]), amount=str(payload["amount"]))
                modulus = demo_key.n
            inputs = generate_inputs(email, modulus, order_id, claim_id, params, lay)
            return inputs.public_signals, inputs.seed

        def witness_fn(payload: Dict) -> list:
            pubs, seed = inputs_fn(payload)
            return cs.witness(pubs, seed)

        def public_fn(witness: list) -> list:
            return list(witness[1 : cs.num_public + 1])

        kw.setdefault("inputs_fn", inputs_fn)
        return cls(cs, dpk, vk, witness_fn, public_fn, **kw)

    def _build_kernels(self) -> None:
        """On the card: build and load every kernel before anything is
        claimed, so that a kernel that cannot build fails the service, not
        each request."""
        if self.device.type != "cuda":
            return
        from ..ops import cuda_build

        for stem in cuda_build.build_all():
            cuda_build.library(stem)

    def run(self, spool: str, poll_s: float = 1.0, max_sweeps: Optional[int] = None,
            max_seconds: Optional[float] = None, exit_when_spool_terminal: bool = False) -> str:
        """Sweep `spool` until drained or done; returns why the loop ended:
        "drained" (request_drain or SIGTERM: the work in flight finished,
        every claim released, the sink flushed), "terminal"
        (exit_when_spool_terminal and every request has a terminal
        artifact), "sweeps" (max_sweeps) or "timeout" (max_seconds).

        The endpoint starts before the preflight (its /status answers 503
        until then).  Every gate is recorded before the preflight, the
        fleet's among them, so the digest it logs is the one /status
        reports.  A fleet worker writes its first heartbeat before the
        first sweep, beats from a thread between sweeps (a sweep may take
        minutes), ticks after every sweep and, at exit, with the reason."""
        from .fleet import fleet_member_arm, start_heartbeat_thread, worker_tick
        from .sched import sched_arm, worker_tier_arm

        self._build_kernels()
        maybe_start_metrics_server(self.metrics_port, self.metrics_addr, identity=self.identity())
        faults_arm()
        slo_arm(self.slo_p95_s)
        timeseries_arm(self.ts_sample_s)
        fleet_member_arm(self._worker_id)
        sched_arm(self.sched)
        worker_tier_arm(self.worker_tier)
        perfledger.perf_arm(self.perf_ledger)
        flameprof.flame_arm(self.flame, self.flame_hz)
        tag = f"[service {self._worker_id}]" if self._worker_id else "[service]"
        # the preflight: every gate's arm and the digest, logged before the
        # first claim (its warnings too)
        try:
            rep = preflight(workload=False, log=lambda m: print(f"{tag} {m}", file=sys.stderr, flush=True))
            print(f"{tag} preflight: backend={rep['backend']} execution_digest={rep['execution_digest']}", flush=True)
        except Exception:  # noqa: BLE001 — observation never stops the service
            pass
        default_tracker(self.slo_p95_s)
        self._sampler = TimeseriesSampler(self.ts_sample_s, self.stale_claim_s, self.identity())

        def _tick(state: Optional[str] = None) -> None:
            if not self.fleet_dir:
                return
            try:
                worker_tick(self, self.fleet_dir, state=state)
            except Exception:  # noqa: BLE001 — fleet plumbing never stops a sweep
                pass

        def _flush():
            rid, pid = run_id(), os.getpid()
            spans = [{"type": "stage", "run_id": rid, "pid": pid, **r} for r in drain_trace()]
            try:
                self._sink(spool).write_many(spans)
            except Exception:  # noqa: BLE001 — observation only
                pass

        _tick()
        hb_stop = start_heartbeat_thread(self, self.fleet_dir) if self.fleet_dir else None
        deadline = (time.time() + max_seconds) if max_seconds else None
        sweeps = 0
        why = "sweeps"
        while max_sweeps is None or sweeps < max_sweeps:
            if deadline is not None and time.time() > deadline:
                why = "timeout"
                break
            stats = self.process_dir(spool)
            if any(stats.values()):
                print(f"{tag} {stats}", flush=True)
                # the sweep's stage spans go to the sink, which also keeps
                # the trace ring from growing
                _flush()
            # idle sweeps sample too: a quiet queue is a recorded fact
            self._sampler.maybe_sample(spool, self._sink(spool))
            # the heartbeat out, the supervisor's control file in
            _tick()
            if self._drain.is_set():
                why = "drained"
                break
            if exit_when_spool_terminal and spool_terminal(spool):
                why = "terminal"
                break
            sweeps += 1
            # a SIGTERM mid-poll ends the wait at once
            if self._drain.wait(poll_s):
                why = "drained"
                break
        _flush()
        # the run's span costs: one ledger entry, which later runs' budgets
        # are derived from
        try:
            self._perf_stamp()
        except Exception:  # noqa: BLE001 — observation only
            pass
        if hb_stop is not None:
            hb_stop.set()
        # the last heartbeat says why: a deliberate exit, not a hang
        _tick(why)
        print(f"{tag} exiting ({why})", flush=True)
        return why
