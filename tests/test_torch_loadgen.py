"""The port's load generator (zkp2p_tpu_torch.tools.loadgen) against the
reference's tools/loadgen.py and tests/test_loadgen.py:

  * parse_trace: the reference's segments for the same specs, the same
    ValueError for the malformed ones;
  * a toy run_capacity of about 20 s (the reference's burst, 1.5 QPS then
    an overload, 1.2 s a step, 0.3 s of service time a request) through the port's
    ProvingService on the CPU: the capacity JSON's schema and the
    reference's expectations (every offered request accounted for,
    attainment not rising past saturation, the max sustainable rate one
    that held), its sched field, and the reference's
    tools/trace_report.py rendering the port's sink as a waterfall and
    its time-series lines;
  * one seeded spike trace through the off and the adaptive arm: the
    same offered load, and each arm's served-under-SLO recorded (a
    record, not a claim that either arm wins);
  * main() on --device cpu, in process: the capacity JSON of an adaptive
    run written to --out.

The toy circuit's proofs come from the reference's host prover on the
same key (the port's side gets them as the port's points), so the
service times are the tool's own (--prove-s) and the sample verify's."""

import json
import os
import random
import subprocess
import sys

import pytest

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.snark.groth16 import prove_host
from zkp2p_tpu.snark.groth16 import setup as ref_setup
from zkp2p_tpu.snark.r1cs import LC as RefLC
from zkp2p_tpu.snark.r1cs import ConstraintSystem as RefCS

from test_torch_setup import port_g2, port_vk
from zkp2p_tpu_torch.pipeline.service import ProvingService
from zkp2p_tpu_torch.snark.groth16 import Proof
from zkp2p_tpu_torch.snark.r1cs import LC, ConstraintSystem
from zkp2p_tpu_torch.tools import loadgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_KEYS = {
    "qps_target", "offered", "done", "errors", "unfinished", "served_under_slo",
    "duration_s", "completed_qps", "p50_s", "p95_s", "max_s", "attainment",
    "burn_rate", "ok",
}


def ref_loadgen():
    import importlib.util

    spec = importlib.util.spec_from_file_location("zkp2p_ref_loadgen", os.path.join(ROOT, "tools", "loadgen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _circuit(CS, L):
    cs = CS("chaos")
    out = cs.new_public("out")
    x, y, z = cs.new_wire("x"), cs.new_wire("y"), cs.new_wire("z")
    cs.enforce(L.of(x), L.of(y), L.of(z), "mul")
    cs.enforce(L.of(z), L.of(z), L.of(out), "sq")
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    return cs, x, y


@pytest.fixture(scope="module")
def world():
    """The toy world as loadgen.toy_world returns it, proving with the
    reference's host prover on the chaos key (seeded draws)."""
    ref_cs, _, _ = _circuit(RefCS, RefLC)
    pk, vk = ref_setup(ref_cs, seed="chaos")
    cs, x, y = _circuit(ConstraintSystem, LC)
    draws = random.Random(19)

    def witness_fn(payload):
        xv, yv = int(payload["x"]), int(payload["y"])
        return cs.witness([pow(xv * yv, 2, R)], {x: xv, y: yv})

    def prove(_dpk, wits):
        out = []
        for w in wits:
            p = prove_host(pk, ref_cs, [int(v) for v in w], draws.randrange(1, R), draws.randrange(1, R))
            out.append(Proof(a=p.a, b=port_g2(p.b), c=p.c))
        return out

    return cs, port_vk(vk), witness_fn, prove


def _service(world, **kw):
    cs, vk, witness_fn, prove = world
    kw.setdefault("batch_size", 4)
    kw.setdefault("cache_dir", None)
    return ProvingService(cs, None, vk, witness_fn, public_fn=lambda w: [w[1]], prover_fn=prove, device="cpu", **kw)


def test_parse_trace_segments_equal():
    ref = ref_loadgen()
    for spec in ("0.2x30,4x20,0.2x30", "1X5", " 2x1 , ,3x0.5", "0.3x10,4x6,0.3x12"):
        assert loadgen.parse_trace(spec) == ref.parse_trace(spec)
    assert loadgen.parse_trace("0.2x30,4x20,0.2x30") == [(0.2, 30.0), (4.0, 20.0), (0.2, 30.0)]
    for bad in ("", "junk", "0x5", "1x-3", "1:5", "1x2x3", ",,"):
        with pytest.raises(ValueError):
            loadgen.parse_trace(bad)
        with pytest.raises(ValueError):
            ref.parse_trace(bad)


def test_run_capacity_burst_schema_and_waterfall(world, tmp_path):
    spool = str(tmp_path / "spool")
    svc = _service(world, ts_sample_s=1.0)
    cap = loadgen.run_capacity(svc, spool, [1.5, 10.0], 1.2, 8.0, prove_sleep_s=0.3, drain_s=30.0, circuit="toy",
                               log=lambda m: None)
    assert cap["type"] == "capacity" and cap["arrivals"] == "open-loop poisson" and cap["sched"] == "off"
    for key in ("run_id", "host", "execution_digest", "objective_p95_s", "target", "steps", "max_sustainable_qps",
                "served_under_slo", "trace"):
        assert key in cap, key
    assert cap["host"]["cpu_count"] >= 1 and cap["host"]["device"] == "cpu" and cap["trace"] == "1.5x1.2,10x1.2"
    assert len(cap["steps"]) == 2 and "worker_errors" not in cap, cap.get("worker_errors")
    for s in cap["steps"]:
        assert STEP_KEYS <= set(s), s
        assert s["offered"] == s["done"] + s["errors"] + s["unfinished"]
        assert 0.0 <= s["attainment"] <= 1.0
    assert sum(s["done"] for s in cap["steps"]) == sum(s["offered"] for s in cap["steps"])
    assert cap["steps"][0]["attainment"] >= cap["steps"][1]["attainment"]
    passing = [s["qps_target"] for s in cap["steps"] if s["ok"]]
    assert cap["max_sustainable_qps"] == (max(passing) if passing else 0.0)
    assert cap["served_under_slo"] == sum(s["served_under_slo"] for s in cap["steps"])
    assert cap["mean_batch_fill"] > 1
    # the run's objective was the service's and is handed back
    assert svc.slo_p95_s == 0.0
    # the reference's trace_report renders the port's sink
    sink = spool + ".metrics.jsonl"
    trace_out = str(tmp_path / "trace.json")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_report.py"), sink, "--chrome-trace",
                        trace_out], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    with open(trace_out) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in xs} >= {"queue_wait", "prove"}
    p = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_report.py"), sink, "--json"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    rep = json.loads(p.stdout)
    assert rep["timeseries"].get("n", 0) >= 1 and "done" in rep["requests"]


def test_off_against_adaptive_on_one_spike(world, tmp_path, record_property):
    """One seeded spike through each arm: the same offered load; each
    arm's served-under-SLO a segment recorded (not asserted as a win)."""
    served = {}
    for arm in ("off", "adaptive"):
        svc = _service(world, sched=arm)
        cap = loadgen.run_capacity(svc, str(tmp_path / arm), [], 0.0, 3.0, prove_sleep_s=0.1, batch_overhead_s=0.4,
                                   drain_s=30.0, circuit="toy", segments=loadgen.parse_trace("0.5x1,6x1,0.5x1"),
                                   log=lambda m: None)
        assert cap["sched"] == arm and "worker_errors" not in cap
        assert [s["offered"] for s in cap["steps"]] == [1, 6, 1]  # seed 7's arrivals
        assert all(s["offered"] == s["done"] for s in cap["steps"])
        served[arm] = [s["served_under_slo"] for s in cap["steps"]]
        assert (svc._sched_ctl is not None) == (arm == "adaptive")
    record_property("served_under_slo", json.dumps(served))
    print(f"served under the 3 s objective, a segment: {served}")


def test_main_on_cpu_writes_the_capacity_json(world, tmp_path, monkeypatch):
    """main() with --device cpu: the toy world (here the fast one) served in
    process on the adaptive arm, the capacity JSON written to --out."""
    cs, vk, witness_fn, prove = world
    monkeypatch.setattr(loadgen, "toy_world",
                        lambda device: (cs, None, vk, witness_fn, lambda w: [w[1]], loadgen._toy_payload, "toy"))
    from zkp2p_tpu_torch.prover import groth16_gpu

    monkeypatch.setattr(groth16_gpu, "prove_gpu_batch", lambda dpk, wits, device=None, chunk=4: prove(dpk, wits))
    out = tmp_path / "cap.json"
    rc = loadgen.main(["--spool", str(tmp_path / "spool"), "--device", "cpu", "--rates", "3", "--step-s", "1",
                       "--objective-s", "6", "--drain-s", "30", "--sched", "adaptive", "--out", str(out)])
    assert rc == 0
    cap = json.loads(out.read_text())
    assert cap["sched"] == "adaptive" and cap["circuit"] == "toy" and cap["objective_p95_s"] == 6.0
    assert cap["steps"][0]["offered"] == cap["steps"][0]["done"] >= 1
    assert loadgen.main(["--spool", str(tmp_path / "x"), "--device", "cpu", "--trace", "junk"]) == 2
    assert loadgen.main(["--spool", str(tmp_path / "x"), "--device", "cpu", "--fleet", "1", "--circuit",
                         "venmo"]) == 2
    assert not (tmp_path / "x").exists()
