"""The port's chaos harness (zkp2p_tpu_torch.tools.chaos) on the CPU
(`--device cpu`: the workers prove with prove_gpu_batch's plain
versions), against the reference's tools/chaos.py:

  * the acceptance run of tests/test_chaos.py: 2 workers on one spool, 1
    SIGKILL landed on a worker holding a claim, faults at 4 sites; every
    request ends in exactly one terminal state, every proof verifies, no
    duplicate record; the reference's check_invariants gives the same
    report on the spool the port's workers left;
  * the invariant checker catching each planted violation, the port's
    and the reference's check_invariants agreeing on the same spool;
  * the toy world's VK equal to the reference's;
  * (slow, as the reference's fleet acceptance is) the fleet run: a
    worker SIGKILLed, one SIGTERM-drained, the supervisor SIGKILLed and
    replaced, and the plane's checks (counter parity under faults, the
    restart storm parked and fired)."""

import json
import os
import subprocess
import sys

import pytest

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.formats import proof_json as ref_json
from zkp2p_tpu.snark.groth16 import prove_host
from zkp2p_tpu.snark.groth16 import setup as ref_setup
from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem
from zkp2p_tpu_torch.tools import chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOUR_SITES = "seed=7,witness:hang=0.2,prove:raise:p=0.2,emit:enospc:once,claim:raise:p=0.05"
INVARIANT_KEYS = ("requests", "states", "proofs_verified", "terminal_records", "violations")
# the test runner runs one process per core: the workers' torch threads
# would oversubscribe them (the plain versions' tensors are small)
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")


def ref_chaos():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import chaos as ref
    finally:
        sys.path.pop(0)
    return ref


def ref_world():
    """The reference's toy world (tools/chaos.py:_build_world, its host
    setup): (cs, pk, vk, x, y)."""
    cs = ConstraintSystem("chaos")
    out = cs.new_public("out")
    x, y, z = cs.new_wire("x"), cs.new_wire("y"), cs.new_wire("z")
    cs.enforce(LC.of(x), LC.of(y), LC.of(z), "mul")
    cs.enforce(LC.of(z), LC.of(z), LC.of(out), "sq")
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    pk, vk = ref_setup(cs, seed="chaos")
    return cs, pk, vk, x, y


@pytest.fixture(scope="module")
def worlds():
    return chaos._build_world("cpu"), ref_world()


def test_chaos_invariant_under_sigkill_and_faults(tmp_path):
    spool = str(tmp_path / "spool")
    report_path = str(tmp_path / "report.json")
    proc = subprocess.run(
        [sys.executable, "-m", "zkp2p_tpu_torch.tools.chaos", "--device", "cpu", "--spool", spool, "--workers", "2",
         "--kills", "1", "--requests", "6", "--batch", "2", "--stale-claim-s", "3", "--max-seconds", "240",
         "--report", report_path, "--faults", FOUR_SITES],
        cwd=ROOT, capture_output=True, text=True, timeout=420, env=ONE_THREAD)
    assert proc.returncode == 0, f"chaos run failed:\n{proc.stdout[-5000:]}\n{proc.stderr[-5000:]}"
    with open(report_path) as f:
        report = json.load(f)
    assert report["violations"] == [] and report["requests"] == 6 and report["kills"] == 1
    assert report["states"].get("open", 0) == 0
    assert report["proofs_verified"] == report["states"]["done"] >= 1
    # the reference's checker on the spool the port's workers left
    _, _, vk, _, _ = ref_world()
    ref_report = ref_chaos().check_invariants(spool, vk=vk)
    assert {k: ref_report[k] for k in INVARIANT_KEYS} == {k: report[k] for k in INVARIANT_KEYS}


def plant(spool, cs, pk, x, y):
    """A spool with every kind of violation the checker looks for, and one
    request that is right."""
    def req(rid, xv, yv):
        with open(os.path.join(spool, rid + ".req.json"), "w") as f:
            json.dump({"x": xv, "y": yv}, f)

    def proof(rid, xv, yv, public=None, tamper=False):
        p = prove_host(pk, cs, cs.witness([pow(xv * yv, 2, R)], {x: xv, y: yv}), 11, 13)
        d = ref_json.proof_to_json(p)
        if tamper:
            d["pi_a"], d["pi_c"] = d["pi_c"], d["pi_a"]
        ref_json.dump(d, os.path.join(spool, rid + ".proof.json"))
        ref_json.dump(ref_json.public_to_json(public or [pow(xv * yv, 2, R)]),
                      os.path.join(spool, rid + ".public.json"))

    req("open", 2, 3)  # no terminal artifact
    req("both", 2, 3)  # both artifacts
    for suffix in (".proof.json", ".error.json"):
        with open(os.path.join(spool, "both" + suffix), "w") as f:
            f.write("{}")
    req("good", 4, 5)
    proof("good", 4, 5)
    req("wrongpub", 4, 6)
    proof("wrongpub", 4, 6, public=[7])
    req("tampered", 3, 7)
    proof("tampered", 3, 7, tamper=True)
    req("torn", 2, 9)
    with open(os.path.join(spool, "torn.proof.json"), "w") as f:
        f.write('{"pi_a": [')
    req("failed", 5, 5)
    with open(os.path.join(spool, "failed.error.json"), "w") as f:
        json.dump({"state": "error-failed-to-prove"}, f)
    with open(spool.rstrip("/") + ".metrics.jsonl", "w") as f:
        for rid, state in (("both", "done"), ("both", "done"), ("good", "deferred"), ("good", "done"),
                           ("failed", "error-failed-to-prove")):
            f.write(json.dumps({"type": "request", "request_id": rid, "state": state}) + "\n")
        f.write('{"type": "request", "request_id": "to')


def test_invariant_checker_catches_violations(tmp_path, worlds):
    """A checker that cannot fail proves nothing: each violation is
    planted, and the two checkers give the same report."""
    (_, _, port_vk, _), (cs, pk, vk, x, y) = worlds
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    plant(spool, cs, pk, x, y)
    report = chaos.check_invariants(spool, vk=port_vk)
    assert report == ref_chaos().check_invariants(spool, vk=vk)
    v = "\n".join(report["violations"])
    assert "open: NO terminal state" in v and "both: BOTH proof and error artifacts" in v
    assert "both: 2 terminal records (duplicate)" in v and "torn sink line" in v
    assert "wrongpub: public signals [7] != payload-derived" in v
    assert "tampered: proof FAILED pairing verification" in v and "torn: unreadable proof artifacts" in v
    assert not any(line.startswith(("good:", "failed:")) for line in report["violations"])
    assert report["proofs_verified"] == 1 and report["requests"] == 7
    assert report["states"] == {"open": 1, "done": 5, "error": 1}


def test_toy_world_vk_matches_reference(worlds):
    (_, _, vk, _), (_, _, rvk, _, _) = worlds

    def g2(p):
        return tuple((c.c0, c.c1) for c in p)

    assert (vk.n_public, vk.alpha_1, list(vk.ic)) == (rvk.n_public, rvk.alpha_1, list(rvk.ic))
    for k in ("beta_2", "gamma_2", "delta_2"):
        assert g2(getattr(vk, k)) == g2(getattr(rvk, k)), k


@pytest.mark.slow
def test_fleet_chaos_acceptance(tmp_path):
    """tests/test_fleet.py's fleet acceptance with 2 workers on the CPU:
    a worker SIGKILLed while it proves, one SIGTERM-drained, the
    supervisor SIGKILLed and replaced; the invariant, the drained
    worker's requests done, the plane's parity and its restart storm."""
    spool = str(tmp_path / "spool")
    report_path = str(tmp_path / "report.json")
    proc = subprocess.run(
        [sys.executable, "-m", "zkp2p_tpu_torch.tools.chaos", "--device", "cpu", "--fleet", "2", "--spool", spool,
         "--requests", "12", "--batch", "2", "--prove-s", "0.6", "--stale-claim-s", "3", "--max-seconds", "600",
         "--report", report_path],
        cwd=ROOT, capture_output=True, text=True, timeout=1800, env=ONE_THREAD)
    assert proc.returncode == 0, f"{proc.stdout[-5000:]}\n{proc.stderr[-5000:]}"
    with open(report_path) as f:
        report = json.load(f)
    assert report["violations"] == [] and report["states"].get("open", 0) == 0
    assert report["killed_worker"] and report["drained_worker"] and report["drained_claims"]
    assert report["supervisor_rcs"][0] == -9 and report["supervisor_rcs"][-1] == 0
    parity = report["plane"]["parity"]
    assert parity["fleet"] == parity["worker_sum"] and parity["workers_scraped"] == 2
    assert report["plane"]["restart_storm"]["alerts_state"]["restart_storm"]["fired_count"] >= 1
