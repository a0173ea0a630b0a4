"""A two-worker fleet of the port's own service on the CPU (the
counterpart of tests/test_fleet.py's fleet smoke and of
tests/test_fleet_obs.py's plane smoke): each worker is a script written
here that runs the port's ProvingService over test_torch_service.py's
2-constraint circuit with its pinned host prover, and takes its identity
and its endpoint's port 0 from the flags the supervisor appends.  The
fleet plane runs on a port the OS chooses: its /status answers 503 until
both workers have armed, then 200; /status answers 200 on both workers'
bound ports; once the first requests have ended, the plane's request
counters equal, label for label, the sum of the live workers' /snapshot
counters, its merged SLO window's n the sum of theirs, its gauges carry
the worker label, and `top --once` shows both workers up.  Then one
worker is SIGKILLed while it holds a claim (restarted; its claims taken
over once stale), the other is SIGTERM-drained; every request ends
exactly once, with the pinned proof, and the records carry worker and
fleet.  Then `python -m zkp2p_tpu_torch fleet --worker-cmd
--fleet-metrics-port auto` end to end, with its exit code and the plane's
status.json (a worker that always crashes is parked and fires
restart_storm)."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.snark.groth16 import prove_host
from zkp2p_tpu.snark.groth16 import setup as ref_setup
from zkp2p_tpu.snark.r1cs import LC as RefLC
from zkp2p_tpu.snark.r1cs import ConstraintSystem as RefCS
from zkp2p_tpu_torch.formats.proof_json import proof_to_json
from zkp2p_tpu_torch.pipeline import cli
from zkp2p_tpu_torch.pipeline.fleet import FleetSupervisor
from zkp2p_tpu_torch.pipeline.fleet_obs import http_status_json
from zkp2p_tpu_torch.pipeline.service import spool_terminal
from zkp2p_tpu_torch.snark.groth16 import Proof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RS = (123456789, 987654321)  # test_torch_service's pinned (r, s)
SEED = "fleet-smoke"
STALE_S = 3.0

WORKER = r'''
import argparse, sys
sys.path.insert(0, {root!r})
from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.snark.groth16 import prove_host, setup
from zkp2p_tpu.snark.r1cs import LC as RefLC, ConstraintSystem as RefCS
from zkp2p_tpu_torch.field.tower import Fq2
from zkp2p_tpu_torch.pipeline.fleet import install_drain_handlers, slowed_prover
from zkp2p_tpu_torch.pipeline.service import ProvingService
from zkp2p_tpu_torch.snark.groth16 import Proof, VerifyingKey
from zkp2p_tpu_torch.snark.r1cs import LC, ConstraintSystem

ap = argparse.ArgumentParser()
for flag in ("--spool", "--worker-id", "--fleet-id", "--fleet-dir"):
    ap.add_argument(flag, default="")
ap.add_argument("--metrics-port", type=int, default=None)
ap.add_argument("--linger", action="store_true")
args = ap.parse_args()


def build_cs(CS, L):  # test_torch_service.build_cs
    cs = CS("svc-faults")
    out = cs.new_public("out")
    x, y, z = cs.new_wire("x"), cs.new_wire("y"), cs.new_wire("z")
    cs.enforce(L.of(x), L.of(y), L.of(z), "mul")
    cs.enforce(L.of(z), L.of(z), L.of(out), "sq")
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    return cs, x, y


def g2(p):
    return tuple(Fq2(c.c0, c.c1) for c in p)


ref_cs, _, _ = build_cs(RefCS, RefLC)
pk, rvk = setup(ref_cs, seed={seed!r})
vk = VerifyingKey(n_public=rvk.n_public, alpha_1=rvk.alpha_1, beta_2=g2(rvk.beta_2), gamma_2=g2(rvk.gamma_2),
                  delta_2=g2(rvk.delta_2), ic=list(rvk.ic))
cs, x, y = build_cs(ConstraintSystem, LC)


def witness_fn(payload):
    xv, yv = int(payload["x"]), int(payload["y"])
    return cs.witness([pow(xv * yv, 2, R)], {{x: xv, y: yv}})


def prove(dpk, wits):
    proofs = [prove_host(pk, ref_cs, [int(v) for v in w], *{rs!r}) for w in wits]
    return [Proof(a=p.a, b=g2(p.b), c=p.c) for p in proofs]


svc = ProvingService(cs, pk, vk, witness_fn, lambda w: [w[1]], batch_size=2, prover_fn=slowed_prover(prove, 0.3),
                     stale_claim_s={stale!r}, retry_backoff_s=0.0, ts_sample_s=0.5, device="cpu",
                     metrics_port=args.metrics_port, worker_id=args.worker_id, fleet_id=args.fleet_id,
                     fleet_dir=args.fleet_dir, cache_dir=None)
install_drain_handlers(svc)
why = svc.run(args.spool, poll_s=0.05, max_seconds=120, exit_when_spool_terminal=not args.linger)
sys.exit(0 if why in ("drained", "terminal") else 2)
'''


def write_worker(tmp_path):
    path = tmp_path / "worker.py"
    path.write_text(WORKER.format(root=ROOT, seed=SEED, rs=RS, stale=STALE_S))
    return str(path)


def write_reqs(spool, n, start=0):
    os.makedirs(spool, exist_ok=True)
    rids = []
    for i in range(start, start + n):
        rids.append(f"q{i:03d}")
        with open(os.path.join(spool, rids[-1] + ".req.json"), "w") as f:
            json.dump({"x": 3 + i, "y": 5 + i}, f)
    return rids


def expected_proofs(n):
    """The pinned proof of each request, as the worker's emit writes it."""
    cs = RefCS("svc-faults")
    out = cs.new_public("out")
    x, y, z = cs.new_wire("x"), cs.new_wire("y"), cs.new_wire("z")
    cs.enforce(RefLC.of(x), RefLC.of(y), RefLC.of(z), "mul")
    cs.enforce(RefLC.of(z), RefLC.of(z), RefLC.of(out), "sq")
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    pk, _ = ref_setup(cs, seed=SEED)
    from zkp2p_tpu_torch.field.tower import Fq2

    want = {}
    for i in range(n):
        xv, yv = 3 + i, 5 + i
        p = prove_host(pk, cs, cs.witness([pow(xv * yv, 2, R)], {x: xv, y: yv}), *RS)
        proof = Proof(a=p.a, b=tuple(Fq2(c.c0, c.c1) for c in p.b), c=p.c)
        want[f"q{i:03d}"] = json.loads(json.dumps(proof_to_json(proof)))
    return want


def check_spool(spool, rids, want, fleet_id):
    """Every request ended exactly once: one artifact, the pinned proof,
    no claim left, at most one terminal record (a SIGKILL may fall between
    the artifact and its record), each record naming its worker and the
    fleet."""
    for rid in rids:
        base = os.path.join(spool, rid)
        assert os.path.exists(base + ".proof.json") and not os.path.exists(base + ".error.json"), rid
        with open(base + ".proof.json") as f:
            assert json.load(f) == want[rid], rid
        assert not os.path.exists(base + ".claim"), rid
    with open(spool.rstrip("/") + ".metrics.jsonl") as f:
        recs = [r for r in map(json.loads, f) if r.get("type") == "request" and r["state"] != "deferred"]
    assert all(r["state"] == "done" for r in recs)
    assert all(sum(r["request_id"] == rid for r in recs) <= 1 for rid in rids)
    assert recs and all(r["fleet"] == fleet_id and r["worker"] in ("w0", "w1") for r in recs)
    return recs


def claim_owner(sup, spool, exclude, deadline):
    """The pid of a live worker other than `exclude` that holds a claim."""
    while time.time() < deadline:
        pids = {s.proc.pid for s in sup.slots.values() if s.proc is not None and s.proc.poll() is None} - exclude
        for fn in os.listdir(spool):
            if fn.endswith(".claim"):
                try:
                    with open(os.path.join(spool, fn)) as f:
                        pid = json.load(f).get("pid")
                except (OSError, ValueError):
                    continue
                if pid in pids:
                    return pid
        time.sleep(0.02)
    return None


def plane_parity(port, status):
    """The plane's /metrics against the live workers' /snapshot: the
    request counters label for label, the merged window's n, the gauges'
    worker labels.  Returns the workers' summed counters."""
    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
    fleet = {m.group(1): float(m.group(2)) for m in
             re.finditer(r'^zkp2p_service_requests_total\{(.*)\} (\S+)$', text, re.M)}
    summed, slo_n, live = {}, 0, []
    for wid, w in status["workers"].items():
        if w["state"] != "up":
            continue
        live.append(wid)
        snap = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{w['port']}/snapshot", timeout=5).read())
        assert snap["armed"] is True and snap["worker"] == wid
        for m in snap["metrics"]:
            if m["name"] == "zkp2p_service_requests_total":
                key = ",".join(f'{k}="{v}"' for k, v in sorted(m["labels"].items()))
                summed[key] = summed.get(key, 0.0) + m["value"]
        slo_n += snap["slo_window"]["n"]
    assert fleet == summed and status["slo"]["n"] == slo_n, (fleet, summed, status["slo"], slo_n)
    for wid in live:
        assert re.search(rf'zkp2p_slo_attainment\{{worker="{wid}"\}}', text), wid
    assert "zkp2p_fleet_merge_refusals_total" not in text and "zkp2p_fleet_slo_attainment 1" in text
    return summed


def test_fleet_smoke_kill_drain_exactly_once_and_status(tmp_path, capsys):
    spool = str(tmp_path / "spool")
    rids = write_reqs(spool, 4)
    worker = write_worker(tmp_path)
    sup = FleetSupervisor(spool, lambda wid: [sys.executable, worker, "--spool", spool, "--linger"], workers=2,
                          fleet_dir=str(tmp_path / "fleet"), restart_backoff_s=0.1, drain_timeout_s=20.0,
                          fleet_metrics_port=0, scrape_s=0.3, log=lambda m: print(f"[sup] {m}", flush=True))
    out = {}
    t = threading.Thread(target=lambda: out.update(rc=sup.run(poll_s=0.05, max_seconds=120, install_signals=False)))
    t.start()
    deadline = time.time() + 60
    try:
        while time.time() < deadline and (sup.plane is None or sup.plane.bound_port is None):
            time.sleep(0.02)
        plane = sup.plane.bound_port
        # the plane fails closed until both workers have armed their gates
        codes, ports = set(), {}
        while time.time() < deadline and len(ports) < 2:
            body = http_status_json(f"http://127.0.0.1:{plane}/status")
            codes.add(body["ok"])
            assert body["ok"] or body["reason"]
            for wid in ("w0", "w1"):
                hb = sup._hb(sup.slots[wid])
                if hb and hb.get("port"):
                    ports[wid] = hb["port"]
            time.sleep(0.05)
        assert len(ports) == 2, f"workers never published ports: {ports}"
        assert False in codes, "the plane's /status never failed closed before the workers armed"
        for wid, port in ports.items():
            body = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=5).read())
            assert body["ok"] is True and body["worker"] == wid and body["fleet"] == sup.fleet_id, body
        while time.time() < deadline and not spool_terminal(spool):
            time.sleep(0.05)
        time.sleep(1.0)  # 3 scrape cycles: the counters quiet and merged
        with urllib.request.urlopen(f"http://127.0.0.1:{plane}/status", timeout=5) as r:
            status = json.loads(r.read())
        assert status["ok"] is True and status["metrics_port"] == plane and status["alerts"] == []
        assert {w: v["port"] for w, v in status["workers"].items()} == ports
        assert plane_parity(plane, status) == {'state="done"': 4.0}
        assert json.loads(urllib.request.urlopen(f"http://127.0.0.1:{plane}/healthz", timeout=5).read())["ok"]
        capsys.readouterr()
        cli.main(["top", "--fleet-dir", sup.fleet_dir, "--once"])
        frame = capsys.readouterr().out
        assert f"fleet {sup.fleet_id}  READY" in frame and re.search(r"^w0 +up ", frame, re.M) \
            and re.search(r"^w1 +up ", frame, re.M), frame

        rids += write_reqs(spool, 10, start=4)
        victim = claim_owner(sup, spool, set(), deadline)
        assert victim is not None, "no worker ever held a claim"
        os.kill(victim, signal.SIGKILL)
        drained = claim_owner(sup, spool, {victim}, deadline)
        assert drained is not None, "no second claim owner to drain"
        os.kill(drained, signal.SIGTERM)
        while time.time() < deadline + 30 and not spool_terminal(spool):
            time.sleep(0.05)
    finally:
        sup.stop()
        t.join(timeout=120)
    assert not t.is_alive() and out.get("rc") == 0, out
    # the SIGKILLed worker was restarted, not parked; the drained one left
    assert sum(s.restarts for s in sup.slots.values()) == 1
    assert all(s.state == "done" for s in sup.slots.values())
    # among them the claims the SIGKILL stranded (taken over once stale)
    # and those the drained worker held (finished before it left)
    check_spool(spool, rids, expected_proofs(len(rids)), sup.fleet_id)
    with open(os.path.join(sup.fleet_dir, "status.json")) as f:
        final = json.load(f)
    assert final["metrics_port"] == plane and final["alerts_state"]["restart_storm"]["fired_count"] == 0


@pytest.mark.parametrize("case", ["service", "crash"])
def test_fleet_command_with_a_worker_cmd(tmp_path, case):
    """`fleet --worker-cmd` end to end: two service workers end every
    request and leave (exit 0); a worker that always crashes is parked
    by a breaker of 1 (exit 4)."""
    spool = str(tmp_path / "spool")
    if case == "service":
        rids = write_reqs(spool, 4)
        cmd = [sys.executable, write_worker(tmp_path), "--spool", "{spool}"]
        want_rc = 0
    else:
        cmd = [sys.executable, "-c", "import sys; sys.exit(3)"]
        want_rc = 4
    fleet_dir = str(tmp_path / "fleet")
    out = subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch", "fleet", "--spool", spool, "--workers", "2",
                          "--fleet-dir", fleet_dir, "--breaker-k", "1", "--max-seconds", "100",
                          "--fleet-metrics-port", "auto", "--fleet-scrape-s", "0.2",
                          "--worker-cmd", json.dumps(cmd)],
                         cwd=ROOT, capture_output=True, text=True, timeout=150)
    assert out.returncode == want_rc, out.stderr[-3000:]
    with open(os.path.join(fleet_dir, "status.json")) as f:
        status = json.load(f)
    assert set(status["workers"]) == {"w0", "w1"} and status["escalations"] == 0
    # the plane's view: its port, its scrapes, and a park fires restart_storm
    assert status["metrics_port"] and status["scrape"]["cycles"] >= 1
    storm = status["alerts_state"]["restart_storm"]["fired_count"]
    assert storm == (case == "crash"), status["alerts_state"]
    if case == "service":
        recs = check_spool(spool, rids, expected_proofs(len(rids)), status["fleet_id"])
        assert {s["state"] for s in status["workers"].values()} == {"done"} and len(recs) == len(rids)
    else:
        assert {s["state"] for s in status["workers"].values()} == {"parked"}
