"""The proving service's chaos harness (port of the reference's
``tools/chaos.py``).

It spawns N workers sweeping one spool of requests, SIGKILLs some of them
while they provably prove (the victim's pid is read from a live `.claim`
file), injects faults at the service's sites, waits for the survivors to
finish the spool, then checks the invariant the service promises:

  1. every request reached exactly one terminal state (.proof.json or
     .error.json, never both, never neither);
  2. every proof verifies against its public signals, and those are the
     request's;
  3. no request has two terminal records in the metrics sink.

Exit 0 when it holds, 1 when not (the JSON report on stdout says why).
The circuit is the 2-constraint toy (out = (x*y)^2): chaos exercises the
serving layer's failure handling, not the prover's arithmetic.  The
workers prove with ``prove_gpu_batch`` on --device (CUDA by default; the
harness raises before it spawns anything when there is none; --device
cpu runs the kernels' plain versions).

    python -m zkp2p_tpu_torch.tools.chaos --workers 2 --kills 1 --requests 6 \\
        --faults "seed=7,witness:hang=0.2,prove:raise:p=0.2,emit:enospc:once,claim:raise:p=0.05"
    python -m zkp2p_tpu_torch.tools.chaos --fleet 2 --requests 12 --prove-s 0.6

--fleet N runs the workers under the fleet supervisor (``python -m
zkp2p_tpu_torch fleet``, its plane on an OS-chosen port): it SIGKILLs a
worker that holds a claim, SIGTERM-drains another, SIGKILLs the
supervisor and starts a replacement on the same spool, then checks the
invariant, that the drained worker's requests ended `done`, and the fleet
plane (``check_plane``): the plane's request counters equal the sum of
the workers' under faults, and a crash-looping worker is parked and fires
`restart_storm`.

A worker is this module with --worker: it builds the toy world, arms the
fault plan of its --faults (``utils.faults.arm``; the reference hands it
over in its environment), and sweeps, on the scheduler arm of its --sched
(off by default), until every request has ended or --max-seconds pass.  It logs its kernels' launch counts at exit.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_FAULTS = "seed=7,witness:hang=0.2,prove:raise:p=0.2,emit:enospc:once,claim:raise:p=0.05"


# ----------------------------------------------------------- toy world


def _build_world(device):
    """The 2-constraint circuit every worker and the checker rebuild alike;
    ``setup_device(cs, seed="chaos")`` gives the reference's key, so a
    proof any worker emits verifies under the checker's VK."""
    from ..field.bn254 import R
    from ..prover.setup_device import setup_device
    from ..snark.r1cs import LC, ConstraintSystem

    cs = ConstraintSystem("chaos")
    out = cs.new_public("out")
    x = cs.new_wire("x")
    y = cs.new_wire("y")
    z = cs.new_wire("z")
    cs.enforce(LC.of(x), LC.of(y), LC.of(z), "mul")
    cs.enforce(LC.of(z), LC.of(z), LC.of(out), "sq")
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    dpk, vk = setup_device(cs, seed="chaos", device=device)

    def witness_fn(payload):
        xv, yv = int(payload["x"]), int(payload["y"])
        return cs.witness([pow(xv * yv, 2, R)], {x: xv, y: yv})

    return cs, dpk, vk, witness_fn


# -------------------------------------------------------------- worker


def worker_main(args) -> int:
    from ..ops import cuda_build
    from ..pipeline.fleet import install_drain_handlers, slowed_prover
    from ..pipeline.service import ProvingService
    from ..prover.groth16_gpu import prove_gpu_batch
    from ..utils import faults
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    faults.arm(args.faults)
    cs, dpk, vk, witness_fn = _build_world(device)
    # service time added to each prove (fleet kill windows need batches
    # that hold their claims a while); fleet.slowed_prover is the model
    prover_fn = slowed_prover(lambda key, wits: prove_gpu_batch(key, wits, device=device), args.prove_s,
                              args.batch_overhead_s)
    svc = ProvingService(cs, dpk, vk, witness_fn, public_fn=lambda w: [w[1]], batch_size=args.batch,
                         prover_fn=prover_fn, stale_claim_s=args.stale_claim_s, retry_backoff_s=0.05, device=device,
                         metrics_port=args.metrics_port, worker_id=args.worker_id, fleet_id=args.fleet_id,
                         fleet_dir=args.fleet_dir, sched=args.sched,
                         # its proves carry the added service time and the
                         # fault plan: no span of them enters the card's ledger
                         cache_dir=None)
    install_drain_handlers(svc)
    print(f"[chaos-worker {os.getpid()}] up, sweeping {args.spool}", flush=True)
    # --linger keeps sweeping a spool whose requests have all ended
    why = svc.run(args.spool, poll_s=args.poll_s, max_seconds=args.max_seconds,
                  exit_when_spool_terminal=not args.linger)
    launches = json.dumps({k[3:]: v for k, v in cuda_build.LAUNCHES.items() if v})
    print(f"[chaos-worker {os.getpid()}] {args.worker_id or 'solo'} exiting ({why}): launches {launches}", flush=True)
    return 0 if why in ("drained", "terminal") else 2


# ----------------------------------------------------------- invariant


def check_invariants(spool: str, vk=None, device=None) -> dict:
    """The invariant over any spool a run left: a report whose
    `violations` is empty when it holds.  Without `vk`, the toy world is
    built on `device` for its VK."""
    from ..field.bn254 import R
    from ..formats.proof_json import load, proof_from_json
    from ..snark.groth16 import verify

    if vk is None:
        vk = _build_world(device)[2]
    violations = []
    states = {}
    verified = 0
    rids = []
    for fn in sorted(os.listdir(spool)):
        if not fn.endswith(".req.json"):
            continue
        rid = fn[: -len(".req.json")]
        rids.append(rid)
        base = os.path.join(spool, rid)
        has_proof = os.path.exists(base + ".proof.json")
        has_error = os.path.exists(base + ".error.json")
        if has_proof and has_error:
            violations.append(f"{rid}: BOTH proof and error artifacts")
        elif not has_proof and not has_error:
            violations.append(f"{rid}: NO terminal state")
        states[rid] = "done" if has_proof else ("error" if has_error else "open")
        if has_proof:
            try:
                proof = proof_from_json(load(base + ".proof.json"))
                pub = [int(v) for v in load(base + ".public.json")]
                with open(base + ".req.json") as f:
                    payload = json.load(f)
                want = [pow(int(payload["x"]) * int(payload["y"]), 2, R)]
                if pub != want:
                    violations.append(f"{rid}: public signals {pub} != payload-derived {want}")
                elif not verify(vk, proof, pub):
                    violations.append(f"{rid}: proof FAILED pairing verification")
                else:
                    verified += 1
            except Exception as e:  # noqa: BLE001 — a torn artifact is a violation
                violations.append(f"{rid}: unreadable proof artifacts ({e})")

    # at most one terminal record a request over every worker's writes
    # (the sink is shared, O_APPEND, whole lines).  A missing record is
    # legal (a sink fault, a SIGKILL between artifact and record); a
    # duplicate is not.  Deferred lines are a retried request's history.
    rec_counts: dict = {}
    sink = spool.rstrip("/") + ".metrics.jsonl"
    for path in [sink] + [f"{sink}.{i}" for i in range(1, 4)]:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    violations.append(f"{os.path.basename(path)}: torn sink line")
                    continue
                if rec.get("type") == "request" and rec.get("state") != "deferred":
                    rec_counts[rec["request_id"]] = rec_counts.get(rec["request_id"], 0) + 1
    for rid, n in sorted(rec_counts.items()):
        if n > 1:
            violations.append(f"{rid}: {n} terminal records (duplicate)")

    counts: dict = {}
    for s in states.values():
        counts[s] = counts.get(s, 0) + 1
    return {
        "requests": len(rids),
        "states": counts,
        "proofs_verified": verified,
        "terminal_records": sum(rec_counts.values()),
        "violations": violations,
    }


# -------------------------------------------------------------- parent


def _write_requests(spool: str, n: int, seed: int) -> None:
    import random

    os.makedirs(spool, exist_ok=True)
    rng = random.Random(seed)
    for i in range(n):
        with open(os.path.join(spool, f"q{i:03d}.req.json"), "w") as f:
            json.dump({"x": rng.randrange(2, 50), "y": rng.randrange(2, 50)}, f)


def _live_claims(spool: str) -> list:
    """[(rid, owner pid)] of every live .claim file."""
    out = []
    for fn in os.listdir(spool):
        if fn.endswith(".claim"):
            try:
                with open(os.path.join(spool, fn)) as f:
                    pid = json.load(f).get("pid")
                if pid:
                    out.append((fn[: -len(".claim")], int(pid)))
            except (OSError, ValueError):
                continue
    return out


def _worker_argv(args, spool: str, **over) -> list:
    """A worker's argv: this module with --worker, the run's options
    (`over` replaces some)."""
    opts = {"batch": args.batch, "stale_claim_s": args.stale_claim_s, "max_seconds": args.max_seconds,
            "poll_s": args.poll_s, "prove_s": args.prove_s, "batch_overhead_s": args.batch_overhead_s, **over}
    argv = [sys.executable, "-m", "zkp2p_tpu_torch.tools.chaos", "--worker", "--spool", spool, "--device",
            args.device, "--faults", args.faults]
    for k, v in opts.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    return argv


def run_chaos(args) -> dict:
    _write_requests(args.spool, args.requests, args.seed)
    cmd = _worker_argv(args, args.spool)
    workers = [subprocess.Popen(cmd, cwd=REPO) for _ in range(args.workers)]
    print(f"[chaos] {args.workers} workers up: {[w.pid for w in workers]}", flush=True)

    # the victim must provably be proving: its pid from a live .claim;
    # never the last worker standing (a survivor ends the spool)
    killed = []
    deadline = time.time() + args.max_seconds
    while len(killed) < args.kills and time.time() < deadline:
        alive = [w for w in workers if w.poll() is None and w.pid not in killed]
        if len(alive) <= 1:
            break
        candidates = [p for _, p in _live_claims(args.spool) if p in {w.pid for w in alive}]
        if candidates:
            os.kill(candidates[0], signal.SIGKILL)
            killed.append(candidates[0])
            print(f"[chaos] SIGKILL {candidates[0]} (owned a live claim)", flush=True)
        else:
            time.sleep(0.02)

    rc = {}
    for w in workers:
        if w.pid in killed:
            w.wait()
            continue
        try:
            rc[w.pid] = w.wait(timeout=max(1.0, deadline + 15.0 - time.time()))
        except subprocess.TimeoutExpired:
            w.kill()
            w.wait()
            rc[w.pid] = "timeout"

    report = check_invariants(args.spool, device=args.device)
    report.update({"workers": args.workers, "kills": len(killed), "killed_pids": killed, "worker_rc": rc,
                   "faults": args.faults})
    if args.kills and not killed:
        report["violations"].append(f"harness: no mid-prove SIGKILL landed (wanted {args.kills})")
    return report


# --------------------------------------------------------------- fleet


def _fleet_pids(fleet_dir: str) -> dict:
    """worker id -> pid from the supervisor's status.json (written each
    tick, so a pid shows at the spawn), the heartbeats as a fallback."""
    pids = {}
    try:
        with open(os.path.join(fleet_dir, "status.json")) as f:
            status = json.load(f)
        for wid, w in status.get("workers", {}).items():
            if w.get("pid"):
                pids[wid] = int(w["pid"])
    except (OSError, ValueError):
        pass
    try:
        names = os.listdir(fleet_dir)
    except OSError:
        return pids
    for fn in names:
        if not fn.endswith(".hb"):
            continue
        try:
            with open(os.path.join(fleet_dir, fn)) as f:
                hb = json.load(f)
            if hb.get("pid"):
                pids.setdefault(fn[:-3], int(hb["pid"]))
        except (OSError, ValueError):
            continue
    return pids


def _http_text(url: str, timeout: float = 3.0):
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read().decode()
    except (OSError, ValueError):
        return None


def _prom_counters(text: str, name: str) -> dict:
    """{label string: value} of one counter family of Prometheus text."""
    out = {}
    for line in (text or "").splitlines():
        if not line.startswith(name):
            continue
        rest = line[len(name):]
        if rest.startswith("{"):
            labels, _, val = rest[1:].partition("} ")
        elif rest.startswith(" "):
            labels, val = "", rest[1:]
        else:
            continue
        try:
            out[labels] = out.get(labels, 0.0) + float(val)
        except ValueError:
            pass
    return out


def _fleet_cmd(spool: str, workers: int, fleet_dir: str, max_seconds: float, worker_argv: list, *flags) -> list:
    return [sys.executable, "-m", "zkp2p_tpu_torch", "fleet", "--spool", spool, "--workers", str(workers),
            "--fleet-dir", fleet_dir, "--fleet-metrics-port", "auto", "--fleet-scrape-s", "0.5",
            "--max-seconds", str(max_seconds), *flags, "--worker-cmd", json.dumps(worker_argv)]


def check_plane(args) -> dict:
    """The fleet plane under faults, as two small fleets of their own:

      A. parity: a lingering 2-worker fleet ends a small spool (the faults
         armed); once it is quiet, the plane's /metrics
         `zkp2p_service_requests_total` equals the sum of the live workers'
         /snapshot counters, and its done count the proof artifacts;
      B. restart storm: a worker that always crashes, under a breaker of 2,
         is parked, and the plane's restart_storm fires (status.json's
         alert state)."""
    from ..pipeline.fleet_obs import discover_fleet_port, http_status_json
    from ..pipeline.service import spool_terminal

    report = {"violations": []}

    # ---- A: the counters' parity
    spool = args.spool.rstrip("/") + "_plane"
    os.makedirs(spool, exist_ok=True)
    for i in range(6):
        with open(os.path.join(spool, f"p{i:03d}.req.json"), "w") as f:
            json.dump({"x": 3 + i, "y": 5 + i}, f)
    fleet_dir = os.path.join(spool, ".fleet")
    limit_s = args.max_seconds + 30.0
    worker_argv = _worker_argv(args, spool, batch=2, poll_s=0.05, max_seconds=limit_s, prove_s=0.1,
                               batch_overhead_s=0.0) + ["--linger"]
    sup = subprocess.Popen(_fleet_cmd(spool, 2, fleet_dir, limit_s, worker_argv, "--restart-backoff-s", "0.2"),
                           cwd=REPO)
    try:
        deadline = time.time() + args.max_seconds
        port = None
        while time.time() < deadline and port is None:
            port = discover_fleet_port(fleet_dir)
            time.sleep(0.1)
        status = None
        while time.time() < deadline:
            status = http_status_json(f"http://127.0.0.1:{port}/status") if port else None
            if status and status.get("ok"):
                break
            time.sleep(0.2)
        if not (status and status.get("ok")):
            report["violations"].append("plane: fleet /status never reached 200")
            return report
        # a spool still moving is a harness problem, not a parity failure
        while time.time() < deadline and not spool_terminal(spool):
            time.sleep(0.2)
        if not spool_terminal(spool):
            report["violations"].append("plane: harness spool never quiesced inside the deadline "
                                        "(parity not comparable; not a federation failure)")
            return report
        time.sleep(2.0)  # at least 2 scrape intervals: the counters quiet and merged
        status = http_status_json(f"http://127.0.0.1:{port}/status")
        fleet_counts = _prom_counters(_http_text(f"http://127.0.0.1:{port}/metrics"), "zkp2p_service_requests_total")
        worker_sum: dict = {}
        scraped = 0
        for wid, w in (status.get("workers") or {}).items():
            if w.get("state") not in ("up", "starting", "draining") or not w.get("port"):
                continue
            snap = http_status_json(f"http://127.0.0.1:{w['port']}/snapshot")
            if snap is None:
                report["violations"].append(f"plane: worker {wid} /snapshot unreachable")
                continue
            scraped += 1
            for m in snap.get("metrics") or []:
                if m["name"] == "zkp2p_service_requests_total" and m["kind"] == "counter":
                    key = ",".join(f'{k}="{v}"' for k, v in sorted(m["labels"].items()))
                    worker_sum[key] = worker_sum.get(key, 0.0) + m["value"]
        report["parity"] = {"fleet": fleet_counts, "worker_sum": worker_sum, "workers_scraped": scraped}
        if scraped < 2:
            report["violations"].append(f"plane: only {scraped} worker snapshots scraped")
        if fleet_counts != worker_sum:
            report["violations"].append(f"plane: fleet /metrics request counters {fleet_counts} != "
                                        f"per-worker sums {worker_sum}")
        n_done = sum(v for k, v in worker_sum.items() if 'state="done"' in k)
        n_proofs = len([f for f in os.listdir(spool) if f.endswith(".proof.json")])
        if n_done != n_proofs:
            report["violations"].append(f"plane: summed done counter {n_done} != {n_proofs} proof artifacts")
    finally:
        if sup.poll() is None:
            sup.send_signal(signal.SIGTERM)
            try:
                sup.wait(timeout=60)
            except subprocess.TimeoutExpired:
                sup.kill()
                sup.wait()

    # ---- B: a breaker park fires restart_storm
    spool_b = args.spool.rstrip("/") + "_storm"
    os.makedirs(spool_b, exist_ok=True)
    fleet_dir_b = os.path.join(spool_b, ".fleet")
    sup_b = subprocess.run(_fleet_cmd(spool_b, 1, fleet_dir_b, 45, [sys.executable, "-c", "import sys; sys.exit(1)"],
                                      "--breaker-k", "2", "--breaker-window-s", "60", "--restart-backoff-s", "0.05"),
                           cwd=REPO, capture_output=True, text=True, timeout=120)
    storm = {"supervisor_rc": sup_b.returncode}
    try:
        with open(os.path.join(fleet_dir_b, "status.json")) as f:
            st = json.load(f)
        storm["alerts_state"] = st.get("alerts_state")
        fired = ((st.get("alerts_state") or {}).get("restart_storm") or {}).get("fired_count", 0)
        if sup_b.returncode != 4:
            report["violations"].append(f"plane: storm fleet exited rc={sup_b.returncode} (want 4 = all parked)")
        if not fired:
            report["violations"].append("plane: breaker parked the worker but restart_storm never fired")
    except (OSError, ValueError) as e:
        report["violations"].append(f"plane: storm status.json unreadable ({e})")
    report["restart_storm"] = storm
    return report


def run_fleet_chaos(args) -> dict:
    """Chaos under the fleet supervisor: N workers on one spool, the faults
    armed in each, then

      1. SIGKILL a worker that holds a claim (the supervisor restarts it
         after a backoff);
      2. SIGTERM another claim holder (its claims end `done`: a drain
         finishes what it holds; the supervisor counts the clean exit and
         does not restart it);
      3. SIGKILL the supervisor and start a replacement on the same spool
         (the supervisor holds no request state: the orphaned workers
         sweep on, the new ones join them, the claims arbitrate).

    Then the invariant, the drain's promise (everything the drained worker
    held at its SIGTERM has a .proof.json), and ``check_plane``."""
    _write_requests(args.spool, args.requests, args.seed)
    worker_argv = _worker_argv(args, args.spool)

    def sup_cmd(fleet_dir: str) -> list:
        return _fleet_cmd(args.spool, args.fleet, fleet_dir, args.max_seconds + 30.0, worker_argv,
                          "--drain-timeout-s", str(max(4 * args.prove_s, 15.0)), "--restart-backoff-s", "0.2",
                          "--liveness-s", "60")

    fleet_dir = os.path.join(args.spool, ".fleet1")
    sup = subprocess.Popen(sup_cmd(fleet_dir), cwd=REPO)
    print(f"[chaos] fleet supervisor up (pid {sup.pid}, {args.fleet} workers)", flush=True)
    deadline = time.time() + args.max_seconds

    def signal_claim_owner(sig, exclude: set) -> tuple:
        """Send `sig` to a fleet worker holding at least one live claim;
        (pid, the requests it held).  A pid gone by the time the signal
        would land (status.json and claims lag) is passed over."""
        excl = set(exclude)
        while time.time() < deadline:
            pids = set(_fleet_pids(fleet_dir).values()) - excl
            claims = _live_claims(args.spool)
            for _, pid in claims:
                if pid in pids:
                    held = sorted(r for r, p in claims if p == pid)
                    try:
                        os.kill(pid, sig)
                    except (ProcessLookupError, PermissionError):
                        excl.add(pid)
                        continue
                    return pid, held
            time.sleep(0.02)
        return None, []

    killed_pid, _ = signal_claim_owner(signal.SIGKILL, set())
    if killed_pid is not None:
        print(f"[chaos] SIGKILL worker {killed_pid} (owned a live claim)", flush=True)
    drained_pid, drained_claims = signal_claim_owner(signal.SIGTERM, {killed_pid} if killed_pid else set())
    if drained_pid is not None:
        print(f"[chaos] SIGTERM worker {drained_pid} (drains {len(drained_claims)} held claim(s): {drained_claims})",
              flush=True)

    supervisor_rcs = []
    if args.supervisor_kill and sup.poll() is None:
        sup.send_signal(signal.SIGKILL)
        supervisor_rcs.append(sup.wait())
        print("[chaos] SIGKILL supervisor; starting replacement", flush=True)
        sup = subprocess.Popen(sup_cmd(os.path.join(args.spool, ".fleet2")), cwd=REPO)
    try:
        supervisor_rcs.append(sup.wait(timeout=args.max_seconds + 60.0))
    except subprocess.TimeoutExpired:
        sup.kill()
        sup.wait()
        supervisor_rcs.append("timeout")

    report = check_invariants(args.spool, device=args.device)
    report.update({"fleet": args.fleet, "killed_worker": killed_pid, "drained_worker": drained_pid,
                   "drained_claims": drained_claims, "supervisor_rcs": supervisor_rcs, "faults": args.faults})
    if killed_pid is None:
        report["violations"].append("harness: no mid-prove worker SIGKILL landed")
    if drained_pid is None:
        report["violations"].append("harness: no claim-owning worker was SIGTERM-drained")
    for rid in drained_claims:
        if not os.path.exists(os.path.join(args.spool, rid + ".proof.json")):
            report["violations"].append(f"{rid}: held by the drained worker but did not terminal done")
    if supervisor_rcs and supervisor_rcs[-1] != 0:
        report["violations"].append(f"harness: final supervisor exited rc={supervisor_rcs[-1]} (want 0 = clean)")
    # the plane's checks as fleets of their own: the main run's workers
    # leave the moment the spool ends, too soon for a quiet comparison
    plane = check_plane(args)
    report["plane"] = {k: v for k, v in plane.items() if k != "violations"}
    report["violations"].extend(plane["violations"])
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--spool", default=os.path.join(REPO, ".chip_scratch", "chaos_spool"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--kills", type=int, default=1)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--stale-claim-s", type=float, default=3.0,
                    help="claim age for a takeover; a live worker's beats keep its claims fresh")
    ap.add_argument("--max-seconds", type=float, default=90.0)
    ap.add_argument("--poll-s", type=float, default=0.05)
    ap.add_argument("--prove-s", type=float, default=0.0,
                    help="service time added a request to each prove (fleet kill windows)")
    ap.add_argument("--batch-overhead-s", type=float, default=0.0, help="service time added to each prove")
    ap.add_argument("--linger", action="store_true", help="worker: sweep on after every request has ended")
    ap.add_argument("--fleet", type=int, default=0,
                    help="run N workers under the fleet supervisor (SIGKILL a worker, SIGTERM-drain one, kill "
                         "and replace the supervisor, check the plane) instead of bare workers")
    ap.add_argument("--supervisor-kill", action="store_true", default=None,
                    help="fleet mode: SIGKILL the supervisor mid-run and start a replacement (the default)")
    ap.add_argument("--no-supervisor-kill", dest="supervisor_kill", action="store_false")
    ap.add_argument("--faults", default=DEFAULT_FAULTS, help="the fault plan each worker arms (utils.faults)")
    ap.add_argument("--report", default="", help="also write the JSON report here (the workers share stdout)")
    # a fleet worker's identity, appended by the supervisor
    ap.add_argument("--worker-id", default="", help=argparse.SUPPRESS)
    ap.add_argument("--fleet-id", default="", help=argparse.SUPPRESS)
    ap.add_argument("--fleet-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--metrics-port", type=int, default=None, help=argparse.SUPPRESS)
    # a worker's scheduler arm (the supervisor appends it when given one)
    ap.add_argument("--sched", choices=["off", "adaptive"], default="off", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker_main(args)
    from ..utils.device import check_device

    check_device(args.device)  # before anything is written or spawned
    if args.supervisor_kill is None:
        args.supervisor_kill = bool(args.fleet)
    report = run_fleet_chaos(args) if args.fleet else run_chaos(args)
    print(json.dumps(report, indent=1, default=str))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    if report["violations"]:
        print(f"[chaos] INVARIANT VIOLATED: {report['violations']}", file=sys.stderr)
        return 1
    kills = report.get("kills", 1 if report.get("killed_worker") else 0)
    print(f"[chaos] invariant holds: {report['requests']} requests, {report['proofs_verified']} proofs verified, "
          f"{kills} kills", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
