"""The port's adaptive scheduler (zkp2p_tpu_torch.pipeline.sched, the
service's adaptive arm, the fleet's autoscaling) against the reference's
(zkp2p_tpu.pipeline.sched, tests/test_sched.py):

  * AmortModel: seeded curves' values inside, below and past their
    points, the throughput argmin, and from_spec's accepted and rejected
    specs (the same exception types) equal in both packages;
  * BatchController: 200 seeded queues, each fed to both controllers
    with the same clock, cap, spool_cap, allow_shed, parallelism and peer
    tiers (several plans a controller, so the arrival EWMA and the
    tier-loss edge carry over), the plans equal field for field; seeded
    observe_batch / seed_calibration sequences equal; the reference's
    fleet-parallelism and warm-up-guard sequences equal;
  * AutoscalePolicy: seeded signal sequences (flapping, sustained,
    missing signals) give equal decisions;
  * the service: tests/test_sched.py's scenarios (the adaptive sweep that
    sheds, runs the lanes and stamps targets; the static arm's cap
    target; the adaptive cap shed by least slack; the time-series target;
    fleet parallelism from heartbeats) through both services on the toy
    circuit (the port's with device="cpu"), each side on a spool of its
    own written just before its sweep; compared: the sweep's stats, the
    order and sizes of the prover's batches, each request record's
    state, batch_n, batch_index, batch_size_target and error, the sched
    lines less ts, pid and run_id (oldest_wait_s to within a second),
    the heartbeat block.  Both sides prove with the reference's native
    batch prover (the port's side gets the proofs as the port's points),
    so no plain CPU prove runs and no deadline rides on one;
  * the gates: service_sched and worker_tier change the execution digest;
  * the 1 -> 2 -> 1 autoscale demo: the port's FleetSupervisor over the
    port's chaos workers (--device cpu, --sched adaptive) grows on a
    backlog spike and retires the new worker after it; no request lost
    or duplicated, every proof verifying, the events in status.json's
    sched block and the decision counters, `top`'s sched: and autoscale:
    lines from that status;
  * the CLI: `service --sched adaptive ...` and `fleet --workers-min
    --workers-max --sched` reach the service's and the supervisor's
    keywords, and the supervisor appends --sched to each worker's argv.
"""

import importlib.util
import json
import os
import random
import sys
import time

import pytest

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.pipeline import sched as ref_sched
from zkp2p_tpu.pipeline.service import ProvingService as RefService
from zkp2p_tpu.pipeline.service import TimeseriesSampler as RefSampler
from zkp2p_tpu.utils.metrics import REGISTRY as REF_REGISTRY

from test_torch_native_guard import native  # noqa: F401  (the fixture)
from test_torch_setup import port_g2, port_vk
from zkp2p_tpu_torch.pipeline import cli
from zkp2p_tpu_torch.pipeline import fleet as port_fleet
from zkp2p_tpu_torch.pipeline import sched as port_sched
from zkp2p_tpu_torch.pipeline.fleet_obs import render_top
from zkp2p_tpu_torch.pipeline.service import ProvingService as PortService
from zkp2p_tpu_torch.pipeline.service import TimeseriesSampler as PortSampler
from zkp2p_tpu_torch.pipeline.service import spool_terminal
from zkp2p_tpu_torch.snark.groth16 import Proof as PortProof
from zkp2p_tpu_torch.snark.r1cs import LC as PortLC
from zkp2p_tpu_torch.snark.r1cs import ConstraintSystem as PortCS
from zkp2p_tpu_torch.tools import chaos as port_chaos
from zkp2p_tpu_torch.utils import audit
from zkp2p_tpu_torch.utils.metrics import REGISTRY as PORT_REGISTRY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"reference": ref_sched, "port": port_sched}
PLAN_CASES = 200
SHED_ENV = ("ZKP2P_SCHED", "ZKP2P_SCHED_AMORT", "ZKP2P_SLO_P95_S", "ZKP2P_DEADLINE_S", "ZKP2P_SPOOL_CAP",
            "ZKP2P_SCHED_PRIORITY_DEFAULT", "ZKP2P_SCHED_TARGET_FILL", "ZKP2P_WORKER_TIER", "ZKP2P_WORKER_ID",
            "ZKP2P_FLEET_ID", "ZKP2P_FLEET_DIR", "ZKP2P_FAULTS", "ZKP2P_METRICS_SINK")


# ------------------------------------------------------------ AmortModel


def _curve(rng):
    n = rng.randint(1, 4)
    sizes = sorted(rng.sample(range(1, 17), n))
    t, pts = 0.0, {}
    for s in sizes:
        t += rng.uniform(0.01, 3.0)
        pts[s] = round(t, 4)
    return pts


def test_amort_model_values_equal():
    rng = random.Random(1901)
    for _ in range(60):
        pts = _curve(rng)
        ref, port = ref_sched.AmortModel(pts), port_sched.AmortModel(pts)
        assert port.points == ref.points
        for s in range(0, 40):
            assert port.batch_s(s) == ref.batch_s(s), (pts, s)
            assert port.per_proof_s(s) == ref.per_proof_s(s)
        for cap in (0, 1, 3, 8, 32):
            assert port.best_throughput_size(cap) == ref.best_throughput_size(cap)
    # the reference's own expectations (tests/test_sched.py)
    m = port_sched.AmortModel({1: 0.9, 4: 1.8, 8: 3.0})
    assert m.batch_s(2) == pytest.approx(0.9 + (1.8 - 0.9) / 3)
    assert m.batch_s(12) == pytest.approx(3.0 + 4 * (3.0 - 1.8) / 4)
    assert port_sched.AmortModel({4: 2.0}).batch_s(8) == pytest.approx(4.0)
    assert port_sched.AmortModel({1: 1.0, 2: 2.0}).best_throughput_size(8) == 1


@pytest.mark.parametrize("spec", ["", "  ", "1:0.5, 4:1.1", "1:0.05,8:0.1", "4:2", ",1:1,,", "2:1,1:0.5",
                                  "junk", "1:2,1:3", "1:2,4:1", "0:1", "1:0", "1:-1", "a:1", "1:b", "1:2:3", "1"])
def test_amort_spec_parsing_equal(spec):
    def parse(mod):
        try:
            return "ok", mod.AmortModel.from_spec(spec).points
        except Exception as e:  # noqa: BLE001 — the type is compared
            return "raised", type(e)

    assert parse(port_sched) == parse(ref_sched)
    for pts in ({}, {1: 2.0, 4: 1.0}, {2: 1.0, 1: 1.0}):
        with pytest.raises(ValueError):
            port_sched.AmortModel(pts)
        with pytest.raises(ValueError):
            ref_sched.AmortModel(pts)


# ------------------------------------------------------- BatchController


def plan_view(plan):
    return {
        "batches": [[r.rid for r in b] for b in plan.batches],
        "shed": [(r.rid, why) for r, why in plan.shed],
        "batch_target": plan.batch_target, "interactive_target": plan.interactive_target,
        "batch_reason": plan.batch_reason, "rate_hz": plan.rate_hz, "oldest_wait_s": plan.oldest_wait_s,
        "lanes": plan.lanes, "tier": plan.tier, "deferred": plan.deferred, "tier_fallback": plan.tier_fallback,
    }


def _queue(rng, now, mod):
    reqs = []
    for i in range(rng.randint(0, 20)):
        t_submit = now - rng.choice((0.0, rng.uniform(0, 3), rng.uniform(0, 40)))
        deadline = None
        if rng.random() < 0.7:
            deadline = t_submit + rng.choice((rng.uniform(0.2, 6), rng.uniform(0.2, 40)))
        reqs.append(mod.SchedRequest(rid=f"q{rng.randrange(10 ** 6):06d}{i}", t_submit=t_submit, deadline=deadline,
                                     interactive=rng.random() < 0.3))
    return reqs


def test_plan_equal_on_seeded_queues():
    rng = random.Random(19)
    cases = 0
    while cases < PLAN_CASES:
        pts = _curve(rng)
        ctl_kw = dict(objective_s=rng.choice((0.0, rng.uniform(0.5, 20))), target_fill=rng.uniform(0.0, 1.3),
                      ewma_tau_s=rng.choice((10.0, rng.uniform(0.05, 30))),
                      tier=rng.choice(("native", "sharded", "", "junk")))
        ctls = {k: mod.BatchController(mod.AmortModel(pts), **ctl_kw) for k, mod in SIDES.items()}
        warm = rng.choice(("none", "seed", "observe"))
        obs = (rng.randint(1, 8), rng.uniform(0.001, 20))
        for ctl in ctls.values():
            if warm == "seed":
                ctl.seed_calibration()
            elif warm == "observe":
                ctl.observe_batch(*obs)
        now = rng.uniform(1e3, 1e9)
        for _ in range(rng.randint(1, 4)):
            now += rng.choice((0.0, rng.uniform(0.01, 5)))
            state = rng.getstate()
            queues = {}
            for k, mod in SIDES.items():
                rng.setstate(state)
                queues[k] = _queue(rng, now, mod)
            kw = dict(cap=rng.randint(1, 9), spool_cap=rng.choice((0, 0, rng.randint(1, 12))),
                      allow_shed=rng.random() < 0.85, parallelism=rng.choice((1, 1, 2, 4, 0)),
                      peer_tiers=rng.choice((None, [], ["native"], ["sharded"], ["native", "sharded"], ["x"])))
            views = {k: plan_view(ctls[k].plan(now, queues[k], **kw)) for k in SIDES}
            assert views["port"] == views["reference"], (pts, ctl_kw, warm, kw)
            cases += 1
            if rng.random() < 0.5:
                fill, secs = rng.randint(0, 9), rng.uniform(-1, 30)
                assert ctls["port"].observe_batch(fill, secs) == ctls["reference"].observe_batch(fill, secs)
            assert (ctls["port"].model_scale, ctls["port"].calibrated, ctls["port"].rate_hz) == (
                ctls["reference"].model_scale, ctls["reference"].calibrated, ctls["reference"].rate_hz)


def test_observe_batch_and_seed_calibration_sequences_equal():
    rng = random.Random(7)
    for _ in range(40):
        pts = _curve(rng)
        ctls = {k: mod.BatchController(mod.AmortModel(pts)) for k, mod in SIDES.items()}
        for _ in range(12):
            if rng.random() < 0.15:
                for c in ctls.values():
                    c.seed_calibration()
            fill, secs = rng.randint(-1, 12), rng.choice((0.0, -1.0, rng.uniform(1e-4, 1e3)))
            got = {k: c.observe_batch(fill, secs) for k, c in ctls.items()}
            assert got["port"] == got["reference"]
            assert ctls["port"].calibrated == ctls["reference"].calibrated
        for t0 in (0.0, 50.0):
            subs = [t0 - rng.uniform(0, 30) for _ in range(rng.randint(0, 30))]
            assert ctls["port"].observe_arrivals(t0, subs) == ctls["reference"].observe_arrivals(t0, subs)


AMORT = "1:0.9,2:1.2,4:1.8,8:3.0"  # tests/test_sched.py's curve


def _reqs(mod, now, n, wait=0.5, deadline_s=8.0, interactive=False, prefix="r"):
    return [mod.SchedRequest(rid=f"{prefix}{i:03d}", t_submit=now - wait - i * 1e-3,
                             deadline=(now - wait - i * 1e-3 + deadline_s) if deadline_s else None,
                             interactive=interactive)
            for i in range(n)]


def _both(fn):
    """fn(mod) for each package; the two results equal."""
    got = {k: fn(mod) for k, mod in SIDES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def test_fleet_parallelism_and_warmup_guard_sequences_equal():
    """tests/test_sched.py's fleet-parallelism and warm-up-guard sequences
    through both controllers."""

    def parallelism(mod):
        out = []
        now = 100.0
        for par in (1, 4):
            c = mod.BatchController(mod.AmortModel.from_spec(AMORT), objective_s=8.0)
            c.observe_batch(1, 0.9)
            c.observe_batch(1, 0.9)
            out.append(plan_view(c.plan(now + (par > 1) * 0.001, _reqs(mod, now, 20, wait=0.2), cap=8,
                                        parallelism=par)))
            c = mod.BatchController(mod.AmortModel.from_spec(AMORT), objective_s=8.0)
            c.observe_batch(1, 0.9)
            out.append(plan_view(c.plan(now, _reqs(mod, now, 16, wait=5.0), cap=8, parallelism=par)))
        return out

    views = _both(parallelism)
    assert len(views[0]["shed"]) >= 1 and views[2]["shed"] == []  # solo sheds the tail, four peers none
    assert views[3]["batch_target"] >= views[1]["batch_target"]

    def warmup(mod):
        c = mod.BatchController(mod.AmortModel.from_spec(AMORT), objective_s=8.0)
        now = 100.0
        fresh = _reqs(mod, now, 20, wait=0.2)
        out = [plan_view(c.plan(now, fresh, cap=8))]
        out.append(plan_view(c.plan(now + 0.001, _reqs(mod, now, 2, wait=30.0, prefix="old") + fresh, cap=8)))
        out.append(c.observe_batch(4, 0.18))
        out.append(plan_view(c.plan(now + 0.002, fresh, cap=8)))
        out.append(c.observe_batch(4, 3.6))
        c2 = mod.BatchController(mod.AmortModel.from_spec(AMORT), objective_s=8.0)
        out.append(c2.observe_batch(1, 9999.0))
        c3 = mod.BatchController(mod.AmortModel.from_spec(AMORT), objective_s=8.0)
        out.append(plan_view(c3.plan(now + 1.0, _reqs(mod, now + 1.0, 12, wait=0.1), cap=8)))
        return out

    w = _both(warmup)
    assert w[0]["shed"] == [] and len(w[1]["shed"]) == 2 and w[2] == pytest.approx(0.1) and w[3]["shed"] == []
    assert 0.1 < w[4] < 2.0 and w[5] <= 50.0
    assert (w[6]["batch_target"], w[6]["batch_reason"]) == (8, "warmup")


# ------------------------------------------------------- AutoscalePolicy


def _signals(rng, mode, tick):
    if mode == "missing" and rng.random() < 0.4:
        return {}
    if mode == "flap":
        # the condition flips every tick: it never holds a whole window
        on = bool(tick % 2)
        return {"backlog_growing": on, "backlog": 5 if on else 0}
    sig = {}
    if rng.random() < 0.8:
        sig["backlog_growing"] = rng.choice((True, True, False, None)) if mode == "sustained" else rng.choice(
            (True, False, None))
    if rng.random() < 0.8:
        sig["backlog"] = rng.choice((0, 0, rng.randint(1, 20), None, "x"))
    if rng.random() < 0.5:
        sig.update(burn_fast=rng.uniform(0, 5), burn_slow=rng.uniform(0, 5), slo_n=rng.choice((0, 10)))
    return sig


@pytest.mark.parametrize("mode", ["random", "flap", "sustained", "missing"])
def test_autoscale_policy_decisions_equal(mode):
    rng = random.Random(hash(mode) % 1000)
    for _ in range(30):
        windows = (1.0, 2.5) if mode == "flap" else (0.0, 1.0, 2.5)
        kw = dict(scale_up_s=rng.choice(windows), scale_down_s=rng.choice(windows + (4.0,)),
                  burn_threshold=rng.choice((1.0, 2.0)))
        lo, hi = rng.randint(0, 3), rng.randint(0, 5)
        pols = {k: mod.AutoscalePolicy(lo, hi, **kw) for k, mod in SIDES.items()}
        live = rng.randint(1, 5)
        t = 0.0
        decisions = {k: [] for k in SIDES}
        for tick in range(80):
            t += rng.choice((0.5, 1.0, 0.25))
            sig = _signals(rng, mode, tick)
            for k, p in pols.items():
                decisions[k].append(p.update(t, live, dict(sig)))
            d = decisions["port"][-1]
            if d:
                live += 1 if d["direction"] == "up" else -1
        assert decisions["port"] == decisions["reference"]
        if mode == "flap":
            assert not any(decisions["port"])


def test_autoscale_reference_expectations():
    """tests/test_sched.py's hysteresis cases on the port's policy."""
    p = port_sched.AutoscalePolicy(1, 3, scale_up_s=5.0, scale_down_s=10.0)
    growing = {"backlog_growing": True, "backlog": 9}
    assert p.update(0.0, 1, growing) is None and p.update(4.9, 1, growing) is None
    assert p.update(5.0, 1, growing) == {"direction": "up", "reason": "backlog_growth"}
    assert p.update(5.1, 2, growing) is None and p.update(10.2, 2, growing)["direction"] == "up"
    assert p.update(20.0, 3, growing) is None
    p = port_sched.AutoscalePolicy(1, 3, scale_up_s=2.0, scale_down_s=4.0)
    idle = {"backlog_growing": False, "backlog": 0}
    assert p.update(0.0, 2, idle) is None and p.update(4.0, 2, idle) == {"direction": "down", "reason": "idle"}
    p = port_sched.AutoscalePolicy(1, 3, scale_up_s=2.0, scale_down_s=10.0, burn_threshold=2.0)
    burn = {"burn_fast": 3.0, "burn_slow": 2.5, "slo_n": 40, "backlog": 3}
    assert p.update(0.0, 1, burn) is None and p.update(2.0, 1, burn) == {"direction": "up", "reason": "slo_burn"}
    p = port_sched.AutoscalePolicy(1, 3, scale_up_s=4.0, scale_down_s=10.0)
    grow = {"backlog_growing": True, "backlog": 5}
    assert p.update(0.0, 1, grow) is None and p.update(2.0, 1, {}) is None
    assert p.update(4.0, 1, grow)["direction"] == "up"


# ------------------------------------------------------------ the gates


def test_sched_and_tier_gates_change_the_digest():
    for a in ("junk", "", "OFF"):
        assert port_sched.normalize_sched(a) == ref_sched.normalize_sched(a) == "off"
        assert port_sched.normalize_tier(a) == ref_sched.normalize_tier(a) == "native"
    port_sched.sched_arm("off")
    port_sched.worker_tier_arm("")
    d_off = audit.execution_digest()
    assert port_sched.sched_arm("adaptive") == "adaptive" and audit.execution_digest() != d_off
    port_sched.sched_arm("junk")
    assert audit.gate_arms()["service_sched"] == "off" and audit.execution_digest() == d_off
    assert port_sched.worker_tier_arm("sharded") == "sharded" and audit.execution_digest() != d_off
    port_sched.worker_tier_arm("native")
    assert audit.execution_digest() == d_off
    # build_controller's order: spec (uncalibrated), points (seeded), the tier's built-in curve
    c = port_sched.build_controller("1:0.5,4:1.1", {1: 9.0}, 8.0, 0.5, "")
    assert c.amort.points == [(1, 0.5), (4, 1.1)] and not c.calibrated and (c.objective_s, c.target_fill) == (8.0, 0.5)
    c = port_sched.build_controller("", {1: 2.0, 4: 3.0})
    assert c.amort.points == [(1, 2.0), (4, 3.0)] and c.calibrated and c.model_scale == 1.0
    assert port_sched.build_controller(tier="sharded").amort.points == sorted(
        ref_sched.DEFAULT_SHARDED_AMORT_POINTS.items())
    assert port_sched.build_controller().amort.points == sorted(ref_sched.DEFAULT_AMORT_POINTS.items())
    assert audit.gate_arms()["worker_tier"] == "native"


# ------------------------------------------------------------ the service


def _ref_chaos():
    spec = importlib.util.spec_from_file_location("zkp2p_ref_chaos_for_sched", os.path.join(ROOT, "tools", "chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def toy(native):  # noqa: F811 (the fixture)
    """The toy world on each side: the reference's (tools/chaos.py, its
    native batch prover) and the port's circuit with the same VK."""
    from zkp2p_tpu.prover.native_prove import prove_native_batch

    cs, dpk, vk, witness_fn = _ref_chaos()._build_world()
    pcs = PortCS("chaos")
    out = pcs.new_public("out")
    x, y, z = pcs.new_wire("x"), pcs.new_wire("y"), pcs.new_wire("z")
    pcs.enforce(PortLC.of(x), PortLC.of(y), PortLC.of(z), "mul")
    pcs.enforce(PortLC.of(z), PortLC.of(z), PortLC.of(out), "sq")
    pcs.compute(z, lambda a, b: a * b % R, [x, y])

    def port_witness(payload):
        xv, yv = int(payload["x"]), int(payload["y"])
        return pcs.witness([pow(xv * yv, 2, R)], {x: xv, y: yv})

    def ref_prove(key, wits):
        return prove_native_batch(key, wits)

    def port_prove(_key, wits):
        return [PortProof(a=p.a, b=port_g2(p.b), c=p.c) for p in prove_native_batch(dpk, [list(w) for w in wits])]

    return {"reference": (cs, dpk, vk, witness_fn, ref_prove), "port": (pcs, None, port_vk(vk), port_witness, port_prove)}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in SHED_ENV:
        monkeypatch.delenv(var, raising=False)
    yield


def _service(side, toy, calls, **kw):
    cs, dpk, vk, witness_fn, prove = toy[side]

    def prover(key, wits):
        calls.append(len(wits))
        return prove(key, wits)

    kw.setdefault("batch_size", 8)
    if side == "port":
        return PortService(cs, dpk, vk, witness_fn, public_fn=lambda w: [w[1]], prover_fn=prover, device="cpu", **kw)
    return RefService(cs, dpk, vk, witness_fn, public_fn=lambda w: [w[1]], prover_fn=prover, **kw)


def _drop(spool, rid, payload, age_s=0.0):
    os.makedirs(spool, exist_ok=True)
    p = os.path.join(spool, rid + ".req.json")
    with open(p, "w") as f:
        json.dump(payload, f)
    if age_s:
        t = time.time() - age_s
        os.utime(p, (t, t))


def _records(spool, kind):
    with open(spool + ".metrics.jsonl") as f:
        return [r for r in map(json.loads, f) if r.get("type") == kind]


REC_KEYS = ("request_id", "state", "batch_n", "batch_index", "batch_size_target", "error")


def run_both(tmp_path, monkeypatch, toy, requests, ref_env, port_kw, svc_kw=None, fleet_dir=None):
    """Each side on its own spool, written just before its sweep (the ages
    are relative to the write); returns {side: outcome}."""
    out = {}
    for side in ("reference", "port"):
        spool = str(tmp_path / side / "spool")
        for rid, payload, age in requests:
            _drop(spool, rid, payload, age)
        calls = []
        kw = dict(svc_kw or {})
        if side == "reference":
            for k, v in ref_env.items():
                monkeypatch.setenv(k, v)
            if fleet_dir:
                monkeypatch.setenv("ZKP2P_FLEET_DIR", fleet_dir)
                monkeypatch.setenv("ZKP2P_WORKER_ID", "w0")
        else:
            kw.update(port_kw)
            if fleet_dir:
                kw.update(fleet_dir=fleet_dir, worker_id="w0")
        reg = REF_REGISTRY if side == "reference" else PORT_REGISTRY
        before = {k: reg.counter("zkp2p_sched_decisions_total", {"kind": k}).value for k in ("shed", "batch", "lane")}
        svc = _service(side, toy, calls, **kw)
        svc._sampler = (RefSampler if side == "reference" else PortSampler)(1000.0)
        stats = svc.process_dir(spool)
        sample = (svc._sampler.maybe_sample(spool, svc._sink(spool), force=True) if side == "reference"
                  else svc._sampler.maybe_sample(spool, svc._sink(spool)))
        recs = {r["request_id"]: {k: r.get(k) for k in REC_KEYS} for r in _records(spool, "request")}
        lines = [{k: v for k, v in r.items() if k not in ("ts", "pid", "run_id")} for r in _records(spool, "sched")]
        decisions = {k: reg.counter("zkp2p_sched_decisions_total", {"kind": k}).value - v for k, v in before.items()}
        out[side] = {"stats": stats, "calls": calls, "records": recs, "sched": lines, "hb": svc._sched_hb,
                     "ts_target": sample["batch_size_target"], "decisions": decisions, "svc": svc}
        for var in ref_env:
            monkeypatch.delenv(var, raising=False)
    ref, port = out["reference"], out["port"]
    for k in ("stats", "calls", "records", "hb", "ts_target", "decisions"):
        assert port[k] == ref[k], k
    assert len(port["sched"]) == len(ref["sched"])
    for p, r in zip(port["sched"], ref["sched"]):
        assert p.pop("oldest_wait_s") == pytest.approx(r.pop("oldest_wait_s"), abs=1.0)
        assert p == r
    return out


def test_adaptive_sweep_sheds_runs_lanes_and_stamps_targets(tmp_path, monkeypatch, toy):
    """tests/test_sched.py's heart: the expired request shed before any
    witness, the interactive request alone in the first batch, the bulk
    six behind it, targets stamped, one decision line."""
    reqs = [(f"b{i}", {"x": 3 + i, "y": 4}, 0.0) for i in range(6)]
    reqs += [("int0", {"x": 5, "y": 6, "priority": "interactive"}, 0.0), ("old0", {"x": 7, "y": 8}, 100.0),
             ("typo0", {"x": 2, "y": 9, "priority": "urgent"}, 0.0)]
    out = run_both(tmp_path, monkeypatch, toy, reqs,
                   {"ZKP2P_SCHED": "adaptive", "ZKP2P_SCHED_AMORT": "1:0.05,8:0.1", "ZKP2P_SLO_P95_S": "10",
                    "ZKP2P_DEADLINE_S": "10"},
                   dict(sched="adaptive", sched_amort="1:0.05,8:0.1", slo_p95_s=10.0, deadline_s=10.0))
    port = out["port"]
    assert port["stats"]["done"] == 8 and port["stats"]["error-shed"] == 1
    assert port["calls"] == [1, 7]  # the interactive batch reaches the prover first
    recs = port["records"]
    assert recs["old0"]["state"] == "error-shed" and "sched" in recs["old0"]["error"]
    assert (recs["int0"]["batch_n"], recs["int0"]["batch_size_target"]) == (1, 1)
    assert (recs["b0"]["batch_n"], recs["typo0"]["batch_size_target"]) == (7, 7)  # a mistyped priority is bulk
    line = port["sched"][0]
    assert line["backlog"] == 9 and line["shed"] == 1 and line["lanes"] == {"interactive": 1, "bulk": 7}
    assert port["hb"]["mode"] == "adaptive" and port["hb"]["lane_interactive"] == 1
    assert port["decisions"] == {"shed": 1, "batch": 2, "lane": 1}
    assert port["svc"]._sched_ctl.calibrated  # both batches observed


def test_off_arm_keeps_static_slicing_and_records_the_cap(tmp_path, monkeypatch, toy):
    reqs = [(f"b{i}", {"x": 3 + i, "y": 4}, 0.0) for i in range(5)]
    reqs += [("zint", {"x": 5, "y": 6, "priority": "interactive"}, 0.0)]
    out = run_both(tmp_path, monkeypatch, toy, reqs, {"ZKP2P_SCHED": "off"}, {}, svc_kw={"batch_size": 4})
    port = out["port"]
    assert port["calls"] == [4, 2] and port["sched"] == [] and port["svc"]._sched_ctl is None
    assert all(r["batch_size_target"] == 4 for r in port["records"].values())
    assert port["hb"] == {"mode": "off", "batch_target": 4}
    # the arm is recorded when it changes, not each sweep or heartbeat: an
    # idle worker's counters stay still (the fleet plane's parity check)
    svc, spool = port["svc"], str(tmp_path / "port" / "spool")
    assert audit.gate_arms()["service_sched"] == "off"

    def counters():
        return [(m["name"], m["labels"], m["value"]) for m in PORT_REGISTRY.snapshot() if m["kind"] == "counter"]

    before = counters()
    for _ in range(2):
        svc.process_dir(spool)
        port_fleet.worker_tick(svc, str(tmp_path / "fleet"))
    assert counters() == before
    svc.sched = "adaptive"
    svc.process_dir(spool)
    assert audit.gate_arms()["service_sched"] == "adaptive"


def test_adaptive_cap_sheds_by_least_slack(tmp_path, monkeypatch, toy):
    """Under the admission cap the adaptive arm sheds the aged pair first
    (least slack) and one fresh request after them, where the static arm
    would shed the newest.  The aged pair keeps 2 s of its 6 s deadline,
    so that no decision rides on the sweep's timing."""
    reqs = [(f"fresh{i}", {"x": 3 + i, "y": 4}, 0.0) for i in range(4)]
    reqs += [(f"aged{i}", {"x": 9, "y": 4 + i}, 4.0) for i in range(2)]
    out = run_both(tmp_path, monkeypatch, toy, reqs,
                   {"ZKP2P_SCHED": "adaptive", "ZKP2P_SCHED_AMORT": "1:1.0,8:2.0", "ZKP2P_DEADLINE_S": "6"},
                   dict(sched="adaptive", sched_amort="1:1.0,8:2.0", deadline_s=6.0),
                   svc_kw={"batch_size": 4, "spool_cap": 3})
    shed = {rid for rid, r in out["port"]["records"].items() if r["state"] == "error-shed"}
    assert {"aged0", "aged1"} <= shed and len(shed) == 3 and out["port"]["stats"]["done"] == 3
    assert all("admission cap 3" in out["port"]["records"][rid]["error"] for rid in shed)


@pytest.mark.parametrize("case", ["timeseries", "fleet_peers"])
def test_timeseries_target_and_fleet_parallelism(tmp_path, monkeypatch, toy, case):
    """The time-series line carries the planned target; with a fleet dir
    of fresh heartbeats the sweep plans for the live peers (the sched
    line's peers and peer_tiers, both sides reading one dir)."""
    reqs = [(f"b{i}", {"x": 3 + i, "y": 4}, 0.0) for i in range(3)]
    fleet_dir = None
    if case == "fleet_peers":
        fleet_dir = str(tmp_path / "fleet")
        os.makedirs(fleet_dir)
        for wid, tier in (("w0", "native"), ("w1", "native"), ("w2", None), ("w3", "native")):
            with open(os.path.join(fleet_dir, wid + ".hb"), "w") as f:
                json.dump({"worker": wid, **({"tier": tier} if tier else {})}, f)
        old = os.path.join(fleet_dir, "w9.hb")
        with open(old, "w") as f:
            json.dump({"worker": "w9", "tier": "sharded"}, f)
        os.utime(old, (time.time() - 60, time.time() - 60))  # stale: no peer
    out = run_both(tmp_path, monkeypatch, toy, reqs,
                   {"ZKP2P_SCHED": "adaptive", "ZKP2P_SCHED_AMORT": "1:0.05,8:0.1", "ZKP2P_DEADLINE_S": "30"},
                   dict(sched="adaptive", sched_amort="1:0.05,8:0.1", deadline_s=30.0), fleet_dir=fleet_dir)
    port = out["port"]
    assert port["ts_target"] == 3
    if case == "fleet_peers":
        svc, ref = port["svc"], out["reference"]["svc"]
        assert svc._live_peers() == ref._live_peers() == 4
        assert svc._live_peer_tiers() == ref._live_peer_tiers() and sorted(svc._live_peer_tiers()) == ["native"] * 2
        assert port["sched"][0]["peers"] == 4 and port["sched"][0]["peer_tiers"] == ["native"] * 2


# ---------------------------------------------------- the autoscale demo


def test_fleet_autoscales_one_two_one_with_chaos_workers(tmp_path, monkeypatch):
    """The port's supervisor over the port's chaos workers (--device cpu,
    --sched adaptive): a backlog spike grows the fleet to two, the idle
    after it retires the newest; no request lost or duplicated, every
    proof verifying, the events in status.json, the counters, and `top`'s
    sched: and autoscale: lines."""
    from zkp2p_tpu.snark.groth16 import setup as ref_setup
    from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem

    spool, fleet_dir = str(tmp_path / "spool"), str(tmp_path / "fleet")
    os.makedirs(spool)
    # the test runner runs a process a core: one thread a worker
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = [sys.executable, "-m", "zkp2p_tpu_torch.tools.chaos", "--worker", "--linger", "--spool", spool,
            "--device", "cpu", "--faults", "", "--batch", "2", "--max-seconds", "150",
            "--poll-s", "0.05"]
    before = {k: PORT_REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": k}).value
              for k in ("scale_up", "scale_down")}
    sup = port_fleet.FleetSupervisor(spool, lambda wid: list(argv), workers=1, fleet_dir=fleet_dir, workers_min=1,
                                     workers_max=2, scale_up_s=0.5, scale_down_s=1.5, drain_timeout_s=60.0,
                                     scrape_s=0.3, sched="adaptive", log=lambda m: None)
    assert sup.autoscale and sup.fleet_metrics_port == 0  # autoscaling turns the plane on
    n = 4
    try:
        sup.start()
        t_end = time.time() + 60
        while time.time() < t_end and (sup._hb(sup.slots["w0"]) or {}).get("state") != "up":
            sup.tick()
            time.sleep(0.1)
        assert (sup._hb(sup.slots["w0"]) or {}).get("tier") == "native"
        i = 0
        while time.time() < t_end and len(sup.slots) == 1:
            if i < n:
                with open(os.path.join(spool, f"s{i:03d}.req.json"), "w") as f:
                    json.dump({"x": 3 + i, "y": 5}, f)
                i += 1
            sup.tick()
            time.sleep(0.1)
        assert len(sup.slots) == 2, "the fleet never grew under a growing backlog"
        while i < n:
            with open(os.path.join(spool, f"s{i:03d}.req.json"), "w") as f:
                json.dump({"x": 3 + i, "y": 5}, f)
            i += 1
        t_end = time.time() + 120
        while time.time() < t_end:
            sup.tick()
            if any(e["direction"] == "down" for e in sup._scale_events) and len(sup._live_workers()) == 1:
                break
            time.sleep(0.1)
        events = [(e["direction"], e["worker"], e["workers"]) for e in sup._scale_events]
        assert events == [("up", "w1", 2), ("down", "w1", 1)], events
        assert sup._scale_events[0]["reason"] in ("backlog_growth", "slo_burn")
        t_end = time.time() + 30
        while time.time() < t_end and sup.slots["w1"].state != "done":
            sup.tick()
            time.sleep(0.1)
        assert sup.slots["w1"].state == "done" and sup.slots["w0"].state == "up"
        with open(os.path.join(fleet_dir, "status.json")) as f:
            status = json.load(f)
        sched = status["sched"]
        assert sched["autoscale"] is True and (sched["workers_min"], sched["workers_max"]) == (1, 2)
        assert sched["scale_events"] == 2 and sched["last_scale"]["direction"] == "down"
        assert [e["direction"] for e in sched["events"]] == ["up", "down"] and sched["workers_live"] == 1
        assert status["workers"]["w0"]["sched"]["mode"] == "adaptive"
        frame = render_top(status)
        assert "sched: w0[adaptive] tgt=" in frame and "autoscale: 1 live in [1..2]  events 2" in frame
        assert "last down (idle) -> 1" in frame
        got = {k: PORT_REGISTRY.counter("zkp2p_sched_decisions_total", {"kind": k}).value - v
               for k, v in before.items()}
        assert got == {"scale_up": 1, "scale_down": 1}
        assert PORT_REGISTRY.gauge("zkp2p_fleet_workers_target").value == 1
        t_end = time.time() + 60
        while time.time() < t_end and not spool_terminal(spool):
            sup.tick()
            time.sleep(0.2)
    finally:
        sup.drain()
        if sup.plane is not None:
            sup.plane.stop()
    assert sup.escalations == 0 and all(s.failures == [] for s in sup.slots.values())
    cs = ConstraintSystem("chaos")
    out = cs.new_public("out")
    x, y, z = cs.new_wire("x"), cs.new_wire("y"), cs.new_wire("z")
    cs.enforce(LC.of(x), LC.of(y), LC.of(z), "mul")
    cs.enforce(LC.of(z), LC.of(z), LC.of(out), "sq")
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    report = port_chaos.check_invariants(spool, vk=port_vk(ref_setup(cs, seed="chaos")[1]))
    assert report["violations"] == [] and report["states"] == {"done": n} and report["proofs_verified"] == n


# ------------------------------------------------------------ the CLI


def test_cli_service_and_fleet_take_the_scheduler_flags(monkeypatch, tmp_path):
    """`service --sched adaptive ...` reaches the service's keywords and
    `fleet --workers-min --workers-max --sched` the supervisor's; the
    supervisor appends --sched to each worker's argv."""
    from zkp2p_tpu_torch.pipeline import service as port_service

    got = {}

    def fake_for_venmo(cs, lay, params, dpk, vk, **kw):
        got["svc"] = kw
        raise SystemExit(0)

    monkeypatch.setattr(cli, "_circuit", lambda args: (None, (None, None)))
    monkeypatch.setattr(cli, "_load_zkey", lambda args: None)
    monkeypatch.setattr(cli, "_check_zkey_matches", lambda zk, cs: None)
    monkeypatch.setattr(cli, "_key", lambda args, zk, dev: None)
    monkeypatch.setattr(cli, "vkey_from_json", lambda obj: None)
    monkeypatch.setattr(cli, "load", lambda path: None)
    monkeypatch.setattr(port_service.ProvingService, "for_venmo", staticmethod(fake_for_venmo))
    with pytest.raises(SystemExit):
        cli.main(["--circuit", "venmo", "service", "--spool", str(tmp_path / "s"), "--device", "cpu", "--sched",
                  "adaptive", "--sched-amort", "1:3,4:9", "--sched-target-fill", "0.6", "--priority-default",
                  "interactive", "--worker-tier", "sharded"])
    kw = got["svc"]
    assert (kw["sched"], kw["sched_amort"], kw["sched_target_fill"], kw["sched_priority_default"],
            kw["worker_tier"]) == ("adaptive", "1:3,4:9", 0.6, "interactive", "sharded")
    with pytest.raises(SystemExit):
        cli.main(["--circuit", "venmo", "service", "--spool", str(tmp_path / "s"), "--device", "cpu"])
    assert (got["svc"]["sched"], got["svc"]["sched_priority_default"]) == ("off", "bulk")

    def fake_run(self, **kw):
        got["sup"] = self
        return 0

    monkeypatch.setattr(port_fleet.FleetSupervisor, "run", fake_run)
    with pytest.raises(SystemExit) as rc:
        cli.main(["fleet", "--spool", str(tmp_path / "f"), "--workers", "3", "--workers-min", "1", "--workers-max",
                  "2", "--scale-up-s", "1.5", "--scale-down-s", "4", "--sched", "adaptive", "--worker-cmd",
                  json.dumps(["prog"])])
    assert rc.value.code == 0
    sup = got["sup"]
    assert (sup.n, sup.workers_min, sup.workers_max, sup.scale_up_s, sup.scale_down_s) == (2, 1, 2, 1.5, 4.0)
    assert sup.autoscale and sup.fleet_metrics_port == 0 and list(sup.slots) == ["w0", "w1"]
    assert sup._argv("w0")[-2:] == ["--sched", "adaptive"] and sup._argv("w0")[:3] == ["prog", "--worker-id", "w0"]
    with pytest.raises(SystemExit):
        cli.main(["fleet", "--spool", str(tmp_path / "g"), "--worker-cmd", json.dumps(["prog"])])
    assert not got["sup"].autoscale and "--sched" not in got["sup"]._argv("w0")
    assert got["sup"].status()["sched"] == {"autoscale": False}
