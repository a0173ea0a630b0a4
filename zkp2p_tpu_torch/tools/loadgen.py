"""The proving service's load generator and capacity model (port of the
reference's ``tools/loadgen.py``).

A benchmark's proofs/s is not what a deployment buys: it buys the highest
arrival rate this host holds under a latency objective.  This tool
measures it with an open-loop Poisson arrival process (arrivals do not
wait for completions: a closed loop throttles itself and hides
saturation) that writes spool requests at a target rate, step by step or
along a piecewise trace, and scores each step against the p95 objective
with the service's own SLO arithmetic (``utils.slo``).  Out comes a
capacity JSON: each step's offered, done, served-under-SLO, p50 / p95 and
attainment, and the highest rate that held.

    python -m zkp2p_tpu_torch.tools.loadgen --spool /tmp/lg --rates 0.5,1,2 --step-s 20 \\
        --objective-s 30 --circuit toy --out capacity.json
    python -m zkp2p_tpu_torch.tools.loadgen --spool /tmp/lg --circuit toy --fleet 1 --fleet-min 1 \\
        --fleet-max 2 --sched adaptive --trace 0.3x10,4x6,0.3x12 --prove-s 0.3 --batch-overhead-s 0.6

  --circuit toy    the chaos harness's 2-constraint circuit (out =
                   (x*y)^2), set up on --device; --prove-s and
                   --batch-overhead-s add service time to each prove (a
                   request's share times the batch's fill, and a batch's
                   fixed cost), so saturation is reachable at toy size.
  --circuit venmo  the port's registry venmo at --max-header / --max-body
                   (1024 / 6400: the flagship), set up on the card; one
                   synthetic signed email's witness is built once and
                   replayed for every request (the witness is not what
                   this tool measures), every prove is real.

By default the service runs in this process (a thread sweeping the spool
with ``prove_gpu_batch`` on --device, the preflight armed, its endpoint
on --metrics-port when given, the time-series sampler ticking).  --fleet
N serves the spool with N toy chaos workers under ``python -m
zkp2p_tpu_torch fleet`` (its plane on a port the OS chooses, which is the
readiness gate: the ramp starts once the fleet's /status answers 200);
--fleet-min / --fleet-max turn on its autoscaling (--scale-up-s,
--scale-down-s, --fleet-scrape-s), and the capacity JSON then carries the
fleet's `sched` block with every scale event.  --no-service only writes
requests for a service running elsewhere.

A request's latency is its terminal artifact's mtime less its request
file's mtime: the spool's arrival clock, which the service's deadlines
and queue_wait_s use too.  A request without a terminal artifact when the
drain window closes is a miss at the cutoff.

Where the port differs: every knob is a flag (the reference reads its
objective, target, scheduler arm, metrics port, sampler interval and the
fleet's windows from its environment); the toy world proves on the card,
or with the kernels' plain versions under --device cpu; the venmo world
is built and set up here (the port has no bench.py key cache); the
fleet's workers are ``zkp2p_tpu_torch.tools.chaos --worker``.  It raises
without CUDA, before it writes or spawns anything, unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import random
import signal
import subprocess
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TERMINAL_SUFFIXES = (".proof.json", ".error.json")


# ------------------------------------------------------------ worlds


def _toy_payload(rng) -> Dict:
    return {"x": rng.randrange(2, 50), "y": rng.randrange(2, 50)}


def toy_world(device):
    """The chaos harness's toy circuit set up on `device` (one source of
    truth, ``chaos._build_world``): (cs, dpk, vk, witness_fn, public_fn,
    payload_fn, "toy")."""
    from .chaos import _build_world

    cs, dpk, vk, witness_fn = _build_world(device)
    return cs, dpk, vk, witness_fn, (lambda w: [w[1]]), _toy_payload, "toy"


def venmo_world(cs, dpk, vk, witness):
    """One venmo witness replayed for every request, on a key the caller
    holds: (cs, dpk, vk, witness_fn, public_fn, payload_fn, "venmo").
    Every prove is real; the capacity number measures the proving
    service, not the email parser."""

    def witness_fn(_payload):
        return witness

    def public_fn(wit):
        return list(wit[1 : cs.num_public + 1])

    def payload_fn(rng):
        return {"i": rng.randrange(1 << 30)}

    return cs, dpk, vk, witness_fn, public_fn, payload_fn, "venmo"


def build_venmo(max_header: int, max_body: int, device, seed: str = "zkp2p-tpu-dev"):
    """The registry's venmo circuit at (max_header, max_body), set up on
    `device`, and one synthetic signed email's witness: venmo_world's
    arguments."""
    from ..inputs.email import generate_inputs, make_test_key, make_venmo_email
    from ..models.venmo import VenmoParams, build_venmo_circuit
    from ..prover.setup_device import setup_device

    params = VenmoParams(max_header_bytes=max_header, max_body_bytes=max_body)
    cs, lay = build_venmo_circuit(params)
    dpk, vk = setup_device(cs, seed=seed, device=device)
    key = make_test_key(1)
    inputs = generate_inputs(make_venmo_email(key), key.n, 1, 0, params, lay)
    return cs, dpk, vk, cs.witness(inputs.public_signals, inputs.seed)


# ------------------------------------------------------------ capacity


def _write_request(spool: str, rid: str, payload: Dict) -> str:
    """An atomic request (a temporary file renamed): the service's grace
    for torn uploads is for careless uploaders, not for this tool."""
    path = os.path.join(spool, rid + ".req.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def host_facts(device=None) -> Dict:
    """What the capacity number was measured on: the host's cores and
    platform, and the device (the card's name where this process has
    initialised CUDA: a fleet's parent does not)."""
    import torch

    facts = {"cpu_count": os.cpu_count() or 1, "platform": platform.platform(),
             "python": platform.python_version(), "torch": torch.__version__, "device": str(device or "cpu")}
    if facts["device"].startswith("cuda") and torch.cuda.is_initialized():
        facts["device_name"] = torch.cuda.get_device_name(0)
    return facts


def parse_trace(spec: str) -> List[Tuple[float, float]]:
    """A piecewise arrival trace, "RATExSECONDS,...": "0.2x30,4x20,0.2x30"
    is 0.2 QPS for 30 s, a 4 QPS spike for 20 s, 0.2 QPS for 30 s (the
    scheduler's A/B instrument: a flat ramp never moves the batch size).
    A malformed spec raises ValueError before any ramp."""
    segments: List[Tuple[float, float]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            rate_s, dur_s = part.lower().split("x")
            rate, dur = float(rate_s), float(dur_s)
        except ValueError:
            raise ValueError(f"bad --trace segment {part!r} (want 'RATExSECONDS,...')") from None
        if rate <= 0 or dur <= 0:
            raise ValueError(f"bad --trace segment {part!r}: rate and duration must be > 0")
        segments.append((rate, dur))
    if not segments:
        raise ValueError(f"--trace {spec!r} has no segments")
    return segments


def run_capacity(
    svc,
    spool: str,
    rates: List[float],
    step_s: float,
    objective_s: float,
    target: float = 0.95,
    payload_fn: Optional[Callable] = None,
    seed: int = 7,
    drain_s: Optional[float] = None,
    poll_s: float = 0.05,
    run_service: bool = True,
    circuit: str = "?",
    prove_sleep_s: float = 0.0,
    batch_overhead_s: float = 0.0,
    fleet_workers: int = 0,
    segments: Optional[List[Tuple[float, float]]] = None,
    sched: Optional[str] = None,
    device=None,
    log: Callable[[str], None] = lambda m: print(m, file=sys.stderr, flush=True),
) -> Dict:
    """Drive the ramp and score it; returns the capacity report.

    svc: a ProvingService swept in a thread of this process when
    run_service (None with run_service False: load for a service
    elsewhere).  Its objective becomes the run's while the ramp runs (its
    controller's, its tracker's and the ``service_slo`` arm), as does its
    service time: prove_sleep_s a request times the batch's fill plus
    batch_overhead_s a batch (``fleet.slowed_prover``, the model the
    fleet's toy workers apply).  segments: (rate, seconds) pairs (a
    --trace); None: one step_s segment a rate.  sched: the arm the report
    names (None: svc's, else "off"); device: the serving side's (None:
    svc's)."""
    from ..pipeline.sched import normalize_sched
    from ..pipeline.service import TimeseriesSampler
    from ..utils.audit import execution_digest
    from ..utils.metrics import REGISTRY, run_id
    from ..utils.slo import SloTracker, default_tracker, slo_arm

    if not 0.0 < target < 1.0:
        raise ValueError(f"SLO target must be in (0,1), got {target}")
    os.makedirs(spool, exist_ok=True)
    # a run's own rid prefix: a reused spool holds earlier runs' artifacts,
    # and a colliding rid would score an old proof as an instant
    # completion; this run's rids alone are scored
    run_tok = f"{os.getpid() & 0xFFFF:04x}{int(time.time() * 1000) & 0xFFFF:04x}"
    stale = [f for f in os.listdir(spool) if f.endswith(".req.json")]
    if stale:
        log(f"[loadgen] note: spool holds {len(stale)} pre-existing request(s); "
            f"this run's rids carry prefix lg{run_tok} and are scored alone")
    if sched is None:
        sched = svc.sched if svc is not None else "off"
    saved = None
    if run_service:
        tracker = default_tracker()
        saved = (svc.slo_p95_s, tracker.objective_s, tracker.target)
        svc.slo_p95_s = objective_s
        tracker.objective_s, tracker.target = max(0.0, objective_s), target
        slo_arm(objective_s, target)
    try:
        rng = random.Random(seed)
        if payload_fn is None:
            payload_fn = _toy_payload
        if (prove_sleep_s > 0 or batch_overhead_s > 0) and svc is not None and svc.prover_fn is not None:
            from ..pipeline.fleet import slowed_prover

            svc.prover_fn = slowed_prover(svc.prover_fn, prove_sleep_s, batch_overhead_s)

        stop = threading.Event()
        worker_errors: List[str] = []

        def worker():
            sampler = TimeseriesSampler(svc.ts_sample_s, svc.stale_claim_s, svc.identity())
            svc._sampler = sampler
            while not stop.is_set():
                try:
                    svc.process_dir(spool)
                    sampler.maybe_sample(spool, svc._sink(spool))
                except Exception:  # noqa: BLE001 — the ramp must finish and report
                    worker_errors.append(traceback.format_exc())
                stop.wait(poll_s)

        th = None
        if run_service:
            th = threading.Thread(target=worker, daemon=True, name="loadgen-service")
            th.start()

        # the ramp: open-loop Poisson arrivals a segment
        if segments is None:
            segments = [(r, step_s) for r in rates]
        steps_reqs: List[List[str]] = []
        t_ramp0 = time.time()
        for si, (rate, seg_s) in enumerate(segments):
            reqs: List[str] = []
            t_end = time.time() + seg_s
            t_next = time.time()
            while t_next < t_end:
                delay = t_next - time.time()
                if delay > 0:
                    time.sleep(delay)
                rid = f"lg{run_tok}s{si:02d}r{len(reqs):05d}"
                _write_request(spool, rid, payload_fn(rng))
                reqs.append(rid)
                t_next += rng.expovariate(rate)
            steps_reqs.append(reqs)
            log(f"[loadgen] step {si}: target {rate:g} QPS -> {len(reqs)} requests in {seg_s:g}s")

        # the drain: a bounded window for the work in flight to end
        if drain_s is None:
            drain_s = max(2 * max(s for _r, s in segments), 10.0)
        t_cutoff = time.time() + drain_s
        while time.time() < t_cutoff:
            open_reqs = [rid for reqs in steps_reqs for rid in reqs
                         if not any(os.path.exists(os.path.join(spool, rid + s)) for s in TERMINAL_SUFFIXES)]
            if not open_reqs:
                break
            time.sleep(min(0.2, poll_s * 4))
        if run_service:
            stop.set()
            th.join(timeout=30.0)

        # each step scored with the /status arithmetic, over the step alone
        now = time.time()
        steps_out: List[Dict] = []
        for si, ((rate, seg_s), reqs) in enumerate(zip(segments, steps_reqs)):
            tracker = SloTracker(objective_s=objective_s, target=target, window_s=0.0)
            done = errors = unfinished = 0
            for rid in reqs:
                base = os.path.join(spool, rid)
                try:
                    t_sub = os.path.getmtime(base + ".req.json")
                except OSError:
                    t_sub = now
                if os.path.exists(base + ".proof.json"):
                    done += 1
                    tracker.observe(os.path.getmtime(base + ".proof.json") - t_sub, ok=True)
                elif os.path.exists(base + ".error.json"):
                    errors += 1
                    tracker.observe(os.path.getmtime(base + ".error.json") - t_sub, ok=False)
                else:
                    # never finished: a miss at the cutoff
                    unfinished += 1
                    tracker.observe(max(0.0, now - t_sub), ok=False)
            snap = tracker.snapshot()
            ok = bool(reqs) and snap["attainment"] >= target
            steps_out.append({
                "qps_target": rate, "offered": len(reqs), "done": done, "errors": errors,
                "unfinished": unfinished,
                # done inside the objective: the scheduler A/B's count
                "served_under_slo": snap["good"],
                "duration_s": round(seg_s, 3),
                "completed_qps": round(done / seg_s, 4) if seg_s > 0 else 0.0,
                "p50_s": snap["p50_s"], "p95_s": snap["p95_s"], "max_s": snap["max_s"],
                "attainment": snap["attainment"], "burn_rate": snap["burn_rate"], "ok": ok,
            })
            log(f"[loadgen] step {si}: {rate:g} QPS offered={len(reqs)} done={done} under_slo={snap['good']} "
                f"p95={snap['p95_s']:.2f}s attainment={snap['attainment']:.3f} {'OK' if ok else 'MISS'}")

        passing = [s["qps_target"] for s in steps_out if s["ok"]]
        report = {
            "type": "capacity",
            "ts": round(t_ramp0, 3),
            "run_id": run_id(),
            "pid": os.getpid(),
            "host": host_facts(device if device is not None else (svc.device if svc is not None else None)),
            "execution_digest": execution_digest(),
            "circuit": circuit,
            "arrivals": "open-loop poisson",
            "seed": seed,
            "objective_p95_s": objective_s,
            "target": target,
            "step_s": step_s,
            "trace": ",".join(f"{r:g}x{s:g}" for r, s in segments),
            # the arm that served the run: capacities at different arms
            # compare only with it
            "sched": normalize_sched(sched),
            "drain_s": round(drain_s, 3),
            "steps": steps_out,
            # the highest offered rate whose step held the objective (0.0:
            # none held it), never extrapolated
            "max_sustainable_qps": max(passing) if passing else 0.0,
            "served_under_slo": sum(s["served_under_slo"] for s in steps_out),
        }
        if fleet_workers:
            report["fleet_workers"] = fleet_workers
        if worker_errors:
            report["worker_errors"] = worker_errors[:3]
        fills = [m for m in REGISTRY.snapshot() if m["name"] == "zkp2p_service_batch_fill" and m["kind"] == "histogram"]
        if fills and fills[0]["count"]:
            report["mean_batch_fill"] = round(fills[0]["sum"] / fills[0]["count"], 3)
        return report
    finally:
        if saved is not None:
            tracker = default_tracker()
            svc.slo_p95_s, tracker.objective_s, tracker.target = saved
            slo_arm(saved[1], saved[2])


# ------------------------------------------------------------ fleet


def _fleet_argv(args, fleet_dir: str) -> List[str]:
    """`python -m zkp2p_tpu_torch fleet` over N toy chaos workers, its
    plane on a port the OS chooses; the workers linger past a terminal
    spool (the ramp writes on) until the supervisor's SIGTERM."""
    worker = [sys.executable, "-m", "zkp2p_tpu_torch.tools.chaos", "--worker", "--linger", "--spool", args.spool,
              "--device", args.device, "--faults", "", "--batch", str(args.batch), "--prove-s", str(args.prove_s),
              "--batch-overhead-s", str(args.batch_overhead_s), "--max-seconds", "100000", "--poll-s", "0.05"]
    argv = [sys.executable, "-m", "zkp2p_tpu_torch", "fleet", "--spool", args.spool, "--workers", str(args.fleet),
            "--fleet-dir", fleet_dir, "--fleet-metrics-port", "auto", "--fleet-scrape-s", str(args.fleet_scrape_s),
            "--scale-up-s", str(args.scale_up_s), "--scale-down-s",
            str(args.scale_down_s), "--device", args.device, "--worker-cmd", json.dumps(worker)]
    if args.sched is not None:
        argv += ["--sched", args.sched]
    if args.fleet_min is not None:
        argv += ["--workers-min", str(args.fleet_min)]
    if args.fleet_max is not None:
        argv += ["--workers-max", str(args.fleet_max)]
    return argv


def _start_fleet(args):
    """The fleet subprocess and its status URL once its /status answers 200
    (every live worker up, scrapable and armed); (None, reason) when it
    never does within 120 s."""
    from ..pipeline.fleet_obs import discover_fleet_port, http_status_json

    os.makedirs(args.spool, exist_ok=True)
    # a fleet dir a run: a reused spool's old heartbeats must not pass the
    # readiness gate before the supervisor starts
    fleet_dir = os.path.join(args.spool, f".fleet-{os.getpid():x}{int(time.time()) & 0xFFFF:04x}")
    proc = subprocess.Popen(_fleet_argv(args, fleet_dir), cwd=REPO)
    deadline = time.time() + 120.0
    url = None
    reason = "status.json has no metrics_port yet"
    while time.time() < deadline:
        if proc.poll() is not None:
            return proc, None, f"the fleet supervisor exited rc={proc.returncode} before the ramp"
        if url is None:
            port = discover_fleet_port(fleet_dir)
            if port:
                url = f"http://127.0.0.1:{port}/status"
        if url is not None:
            st = http_status_json(url)
            if st and st.get("ok"):
                return proc, url, ""
            if st:
                reason = st.get("reason", "not ready")
        time.sleep(0.1)
    return proc, None, f"the fleet never became ready ({reason})"


def _stop_fleet(proc) -> None:
    """SIGTERM drains the fleet (the supervisor escalates stragglers)."""
    if proc is None or proc.poll() is not None:
        return
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


# ------------------------------------------------------------ CLI


def main(argv=None) -> int:
    from ..pipeline.cli import _metrics_port

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--spool", required=True, help="spool directory (made when absent)")
    ap.add_argument("--rates", default="0.5,1,2", help="the ramp's target QPS, a step each")
    ap.add_argument("--step-s", type=float, default=20.0, help="seconds a ramp step")
    ap.add_argument("--trace", default="",
                    help="a piecewise arrival trace 'RATExSECONDS,...' (e.g. '0.2x30,4x20,0.2x30', low -> spike "
                         "-> drain; replaces --rates / --step-s; scored a segment)")
    ap.add_argument("--objective-s", type=float, default=30.0, help="the p95 latency objective in s")
    ap.add_argument("--target", type=float, default=0.95, help="the attainment target, a fraction")
    ap.add_argument("--circuit", choices=["toy", "venmo"], default="toy")
    ap.add_argument("--max-header", type=int, default=1024, help="venmo: the header's bytes")
    ap.add_argument("--max-body", type=int, default=6400, help="venmo: the body's bytes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4, help="the service's batch size")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--prove-s", type=float, default=0.0,
                    help="service time added a request to each prove, times the batch's fill")
    ap.add_argument("--batch-overhead-s", type=float, default=0.0, help="service time added to each prove")
    ap.add_argument("--sched", choices=["off", "adaptive"], default=None,
                    help="the serving side's scheduler arm (default: off)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve the ramp with N toy workers under `python -m zkp2p_tpu_torch fleet` instead of "
                         "the service in this process (toy circuit only)")
    ap.add_argument("--fleet-min", type=int, default=None, help="with --fleet: the autoscaler's floor")
    ap.add_argument("--fleet-max", type=int, default=None, help="with --fleet: the autoscaler's ceiling (turns it on)")
    ap.add_argument("--scale-up-s", type=float, default=10.0, help="with --fleet: the fleet's scale-up window")
    ap.add_argument("--scale-down-s", type=float, default=30.0, help="with --fleet: the fleet's scale-down window")
    ap.add_argument("--fleet-scrape-s", type=float, default=2.0, help="with --fleet: the plane's scrape interval")
    ap.add_argument("--metrics-port", type=_metrics_port, default=None,
                    help="the in-process service's endpoint (auto or N; default off)")
    ap.add_argument("--ts-sample-s", type=float, default=10.0, help="the time-series sampler's interval (0 = off)")
    ap.add_argument("--drain-s", type=float, default=None,
                    help="the longest wait for the work in flight after the ramp (default 2 x the longest step)")
    ap.add_argument("--no-service", action="store_true", help="only write requests; a service elsewhere sweeps")
    ap.add_argument("--out", default="", help="also write the capacity JSON here")
    args = ap.parse_args(argv)

    from ..utils.device import check_device

    # before anything is written or spawned (a supervisor's check: CUDA is
    # not initialised here)
    check_device(args.device)
    segments = None
    if args.trace:
        try:
            segments = parse_trace(args.trace)
        except ValueError as e:
            print(f"[loadgen] {e}", file=sys.stderr)
            return 2
        rates = [r for r, _s in segments]
    else:
        try:
            rates = [float(r) for r in args.rates.split(",") if r.strip()]
        except ValueError:
            rates = []
    if not rates or any(r <= 0 for r in rates):
        print(f"[loadgen] bad --rates {args.rates!r}: need positive QPS values", file=sys.stderr)
        return 2
    if not 0.0 < args.target < 1.0:
        print(f"[loadgen] bad --target {args.target!r}: need a fraction in (0,1)", file=sys.stderr)
        return 2
    if args.fleet and args.circuit != "toy":
        print("[loadgen] --fleet serves the toy circuit only (each worker is a fresh process; venmo workers would "
              "each set up the flagship key)", file=sys.stderr)
        return 2

    svc = None
    payload_fn = None
    circuit = args.circuit
    fleet_proc = None
    fleet_url = None
    sched = args.sched or "off"
    if args.fleet:
        fleet_proc, fleet_url, why = _start_fleet(args)
        if fleet_url is None:
            print(f"[loadgen] {why}", file=sys.stderr)
            _stop_fleet(fleet_proc)
            return 2
        print(f"[loadgen] fleet ready: /status 200 ({args.fleet} armed workers)", file=sys.stderr, flush=True)
    elif not args.no_service:
        from ..pipeline.sched import sched_arm
        from ..pipeline.service import ProvingService
        from ..prover.groth16_gpu import prove_gpu_batch
        from ..utils.audit import preflight
        from ..utils.device import resolve_device
        from ..utils.metrics import maybe_start_metrics_server

        device = resolve_device(args.device)
        if args.circuit == "toy":
            world = toy_world(device)
        else:
            world = venmo_world(*build_venmo(args.max_header, args.max_body, device))
        cs, dpk, vk, witness_fn, public_fn, payload_fn, circuit = world
        svc = ProvingService(cs, dpk, vk, witness_fn, public_fn=public_fn, batch_size=args.batch,
                             prover_fn=lambda key, wits: prove_gpu_batch(key, wits, device=device), device=device,
                             slo_p95_s=args.objective_s, ts_sample_s=args.ts_sample_s, sched=sched,
                             # a load test neither reads budgets from nor adds to the card's perf ledger
                             cache_dir=None)
        svc._build_kernels()
        sched_arm(sched)
        # the gates armed (and /status answering 200), then the endpoint
        preflight(workload=False, log=lambda m: print(f"[loadgen] {m}", file=sys.stderr, flush=True))
        maybe_start_metrics_server(args.metrics_port)

    try:
        report = run_capacity(
            svc, args.spool, rates, args.step_s, args.objective_s, target=args.target, payload_fn=payload_fn,
            seed=args.seed, drain_s=args.drain_s, run_service=not args.no_service and not args.fleet,
            circuit=circuit, prove_sleep_s=args.prove_s, batch_overhead_s=args.batch_overhead_s,
            fleet_workers=args.fleet, segments=segments, sched=sched, device=args.device)
        if fleet_url:
            from ..pipeline.fleet_obs import http_status_json

            # the fleet's own read of the run, before the teardown: the
            # merged SLO, the autoscaler's block and events, every alert
            fs = http_status_json(fleet_url, timeout=5)
            if fs:
                report["fleet_slo"] = fs.get("slo")
                report["fleet_sched"] = fs.get("sched")
                report["fleet_alerts"] = {
                    "active": fs.get("alerts", []),
                    "fired": {rule: st.get("fired_count", 0)
                              for rule, st in (fs.get("alerts_state") or {}).items() if st.get("fired_count")},
                }
    finally:
        _stop_fleet(fleet_proc)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"[loadgen] max sustainable QPS at p95<={args.objective_s:g}s (target {args.target:g}): "
          f"{report['max_sustainable_qps']:g}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
