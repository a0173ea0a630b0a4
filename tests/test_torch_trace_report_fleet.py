"""The reference's standalone tools/trace_report.py on a port fleet's
records (its fleet views, as tests/test_fleet_obs.py checks them on the
reference's): two port service workers under the port's FleetSupervisor
on the CPU, over test_torch_service.py's 2-constraint circuit with the
reference's host prover.  w0 sweeps once with `emit:enospc:once` armed,
so its first request's emit fails and the request is deferred (a record
from w0's pid, its claim released); w0 then exits, and w1, started late,
takes the request over and ends it done.  On the spool's sink:

  * --fleet-dir finds every sink the fleet left (the shared
    <spool>.metrics.jsonl and its rotations);
  * --chrome-trace stitches the taken-over request's two attempts with one
    flow-event pair from w0's pid to w1's, and none for a request of one
    attempt;
  * --request RID renders its timeline: two attempts, the takeover, both
    workers, the deferral's reason, then done."""

import glob
import json
import os
import subprocess
import sys

from zkp2p_tpu_torch.pipeline.fleet import FleetSupervisor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "trace_report.py")

WORKER = r'''
import argparse, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from test_torch_service import RefCS, RefLC, Side, build_cs, ref_setup
from zkp2p_tpu_torch.utils import faults

ap = argparse.ArgumentParser()
for flag in ("--spool", "--worker-id", "--fleet-id", "--fleet-dir", "--faults"):
    ap.add_argument(flag, default="")
ap.add_argument("--metrics-port", type=int, default=None)
ap.add_argument("--max-sweeps", type=int, default=None)
ap.add_argument("--delay", type=float, default=0.0)
args = ap.parse_args()
cs, _, _ = build_cs(RefCS, RefLC)
pk, vk = ref_setup(cs, seed="svc-faults")
svc = Side("port", {{"cs": cs, "pk": pk, "vk": vk}}).service(
    worker_id=args.worker_id, fleet_id=args.fleet_id, fleet_dir=args.fleet_dir, cache_dir=None, ts_sample_s=0.0)
if args.faults:
    faults.arm(args.faults)
time.sleep(args.delay)
svc.run(args.spool, poll_s=0.05, max_sweeps=args.max_sweeps, max_seconds=90, exit_when_spool_terminal=True)
'''


def report(*args):
    p = subprocess.run([sys.executable, TOOL, *args], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    return p.stdout


def test_trace_report_fleet_views_on_a_port_fleet(tmp_path):
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    for i, (xv, yv) in enumerate([(3, 5), (2, 7)]):
        with open(os.path.join(spool, f"r{i}.req.json"), "w") as f:
            json.dump({"x": xv, "y": yv}, f)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(root=ROOT, tests=os.path.join(ROOT, "tests")))
    per_worker = {"w0": ["--faults", "emit:enospc:once", "--max-sweeps", "1"], "w1": ["--delay", "3"]}
    sup = FleetSupervisor(spool, lambda wid: [sys.executable, str(worker), "--spool", spool, *per_worker[wid]],
                          workers=2, fleet_dir=str(tmp_path / "fleet"), restart_backoff_s=0.1, log=lambda m: None)
    assert sup.run(poll_s=0.05, max_seconds=120, install_signals=False) == 0
    assert sorted(f for f in os.listdir(spool) if f.endswith((".proof.json", ".error.json"))) == [
        "r0.proof.json", "r1.proof.json"]
    with open(spool + ".metrics.jsonl") as f:
        recs = [r for r in map(json.loads, f) if r.get("type") == "request"]
    attempts = [(r["request_id"], r["state"], r["worker"]) for r in recs]
    assert sorted(attempts) == [("r0", "deferred", "w0"), ("r0", "done", "w1"), ("r1", "done", "w0")], attempts
    pids = {r["worker"]: r["pid"] for r in recs}
    assert pids["w0"] != pids["w1"]

    # --fleet-dir finds every sink
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import trace_report as tool
    finally:
        sys.path.pop(0)
    # the sink and its rotations (the .lock beside them is the rotation's lock)
    sinks = sorted(p for p in glob.glob(spool + ".metrics.jsonl*") if not p.endswith(".lock"))
    assert sinks and sorted(tool.fleet_sinks(sup.fleet_dir)) == sinks

    # --chrome-trace: one flow pair across the two workers' pids, for r0 only
    out = str(tmp_path / "trace.json")
    report("--fleet-dir", sup.fleet_dir, "--chrome-trace", out)
    with open(out) as f:
        ev = json.load(f)["traceEvents"]
    flows = [e for e in ev if e.get("ph") in ("s", "f")]
    assert len(flows) == 2, flows
    s, f_ = sorted(flows, key=lambda e: e["ph"], reverse=True)
    assert (s["pid"], f_["pid"]) == (pids["w0"], pids["w1"]) and s["id"] == f_["id"] and f_["ts"] > s["ts"]
    assert "takeover" in s["name"] and "r0" in s["name"] + str(s.get("args", ""))
    names = {e["args"]["name"] for e in ev if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert any("w0" in n for n in names) and any("w1" in n for n in names)

    # --request: the timeline with the takeover
    text = report("--fleet-dir", sup.fleet_dir, "--request", "r0")
    assert "request r0 — 2 attempt(s)" in text and "TAKEOVER" in text
    assert f"w0 (pid {pids['w0']})" in text and f"w1 (pid {pids['w1']})" in text
    assert "-> deferred (" in text and "-> done" in text
    assert "1 attempt(s)" in report("--fleet-dir", sup.fleet_dir, "--request", "r1")
