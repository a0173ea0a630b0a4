"""The port's proving service (zkp2p_tpu_torch.pipeline.service) against
the reference's (zkp2p_tpu.pipeline.service), scenario by scenario: the
scenarios of tests/test_service_faults.py, and the batched witness path.

Each case builds the same 2-constraint circuit in both packages, writes
the same spool twice and sweeps one copy with each service.  Both prove
with the reference's host prover at a pinned (r, s) (the port has no host
prover; its side gets the proofs as the port's points), so no JAX compile
runs; the reference arms faults through ZKP2P_FAULTS, the port through
faults.arm.  Compared, with equality everywhere: each sweep's stats, each
request's terminal state, each .error.json's state, the .proof.json and
.public.json bytes, the service counters' deltas, and in the request
records the request id, state, batch_index, batch_n, batch_size_target,
degraded_rung and span names (timing, run_id, pid, knobs, digest and
memory fields are not compared).
"""

import json
import os
import time

import pytest

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.pipeline.service import ProvingService as RefService
from zkp2p_tpu.snark.groth16 import Proof as RefProof
from zkp2p_tpu.snark.groth16 import prove_host
from zkp2p_tpu.snark.groth16 import setup as ref_setup
from zkp2p_tpu.snark.r1cs import LC as RefLC
from zkp2p_tpu.snark.r1cs import ConstraintSystem as RefCS
from zkp2p_tpu.utils import faults as ref_faults
from zkp2p_tpu.utils.metrics import REGISTRY as REF_REGISTRY

from test_torch_setup import port_g2, port_vk
from zkp2p_tpu_torch.pipeline import service as port_service
from zkp2p_tpu_torch.pipeline.service import ProvingService as PortService
from zkp2p_tpu_torch.snark.groth16 import Proof as PortProof
from zkp2p_tpu_torch.snark.r1cs import LC as PortLC
from zkp2p_tpu_torch.snark.r1cs import ConstraintSystem as PortCS
from zkp2p_tpu_torch.utils import faults as port_faults
from zkp2p_tpu_torch.utils.metrics import REGISTRY as PORT_REGISTRY

RS = (123456789, 987654321)
COUNTERS = ("retries", "bisections", "shed", "deadline", "emit_failures", "deferred")
RUNGS = port_service.DEGRADATION_RUNGS
RECORD_KEYS = ("request_id", "state", "batch_index", "batch_n", "batch_size_target", "degraded_rung")


def build_cs(CS, LC):
    """out = (x*y)^2 over two private wires (test_service_faults' circuit)."""
    cs = CS("svc-faults")
    out = cs.new_public("out")
    x, y, z = cs.new_wire("x"), cs.new_wire("y"), cs.new_wire("z")
    cs.enforce(LC.of(x), LC.of(y), LC.of(z), "mul")
    cs.enforce(LC.of(z), LC.of(z), LC.of(out), "sq")
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    return cs, x, y


class Side:
    """One package's service and its hooks on the shared circuit."""

    def __init__(self, name, world):
        self.name = name
        self.port = name == "port"
        CS, LC = (PortCS, PortLC) if self.port else (RefCS, RefLC)
        self.cs, self.x, self.y = build_cs(CS, LC)
        self.ref_cs, self.pk = world["cs"], world["pk"]
        self.vk = port_vk(world["vk"]) if self.port else world["vk"]
        self.registry = PORT_REGISTRY if self.port else REF_REGISTRY

    def witness_fn(self, payload):
        xv, yv = int(payload["x"]), int(payload["y"])
        return self.cs.witness([pow(xv * yv, 2, R)], {self.x: xv, self.y: yv})

    def inputs_fn(self, payload):
        xv, yv = int(payload["x"]), int(payload["y"])
        return [pow(xv * yv, 2, R)], {self.x: xv, self.y: yv}

    def proof(self, w):
        p = prove_host(self.pk, self.ref_cs, [int(v) for v in w], *RS)
        return PortProof(a=p.a, b=port_g2(p.b), c=p.c) if self.port else RefProof(a=p.a, b=p.b, c=p.c)

    def prove(self, dpk, wits):
        return [self.proof(w) for w in wits]

    def service(self, **kw):
        kw.setdefault("prover_fn", self.prove)
        kw.setdefault("batch_size", 2)
        kw.setdefault("retry_backoff_s", 0.0)  # tests must not sleep
        witness_fn = kw.pop("witness_fn", self.witness_fn)
        if self.port:
            kw["device"] = "cpu"
            # the card's ledger in the repo stays out of the tests' budgets
            kw.setdefault("cache_dir", None)
        return (PortService if self.port else RefService)(self.cs, self.pk, self.vk, witness_fn,
                                                          public_fn=lambda w: [w[1]], **kw)

    def arm(self, spec, monkeypatch):
        if self.port:
            port_faults.arm(spec)
        else:
            monkeypatch.setenv("ZKP2P_FAULTS", spec)
            ref_faults.reset()

    def counters(self):
        c = {k: self.registry.counter(f"zkp2p_service_{k}_total").value for k in COUNTERS}
        c.update({f"degraded_{r}": self.registry.counter("zkp2p_service_degraded_total", {"rung": r}).value
                  for r in RUNGS})
        return c


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cs, _, _ = build_cs(RefCS, RefLC)
    pk, vk = ref_setup(cs, seed="svc-faults")
    w = {"cs": cs, "pk": pk, "vk": vk}
    # a sweep of an empty spool on each side first: the reference's first
    # sweep imports its scheduler and builds its manifest, which would eat
    # into a deadline scenario's budget
    for name in ("reference", "port"):
        Side(name, w).service().process_dir(str(tmp_path_factory.mktemp(f"warm-{name}")))
    return w


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for var in ("ZKP2P_FAULTS", "ZKP2P_METRICS_SINK", "ZKP2P_DEADLINE_S", "ZKP2P_SPOOL_CAP", "ZKP2P_PROVE_RETRIES",
                "ZKP2P_RETRY_BACKOFF_S", "ZKP2P_SCHED", "ZKP2P_WORKER_ID", "ZKP2P_FLEET_ID", "ZKP2P_FLEET_DIR"):
        monkeypatch.delenv(var, raising=False)
    ref_faults.reset()
    port_faults.reset()
    yield
    ref_faults.reset()
    port_faults.reset()


def write_reqs(spool, pairs, prefix="r", **extra):
    for i, (xv, yv) in enumerate(pairs):
        with open(os.path.join(spool, f"{prefix}{i}.req.json"), "w") as f:
            json.dump({"x": xv, "y": yv, **extra}, f)


def age(path, seconds):
    past = time.time() - seconds
    os.utime(path, (past, past))


def write_torn(spool, name, aged):
    path = os.path.join(spool, f"{name}.req.json")
    with open(path, "w") as f:
        f.write('{"x": 3, "y"')  # a half-written upload
    if aged:
        age(path, 60)  # past the grace window: really torn


# ------------------------------------------------------------- scenarios
#
# Each takes (side, spool root, monkeypatch) and returns its own
# observations beside what `observe` collects: the stats of each sweep,
# and anything the scenario counts.


def sc_torn(side, root, mp):
    write_reqs(root, [(3, 5), (2, 7)])
    write_torn(root, "aatorn", aged=True)
    svc = side.service()
    return {"sweeps": [svc.process_dir(root), side.service().process_dir(root)]}


def sc_young_torn(side, root, mp):
    write_torn(root, "r0", aged=False)
    svc = side.service()
    first = svc.process_dir(root)
    present = os.path.exists(os.path.join(root, "r0.error.json"))
    write_reqs(root, [(3, 5)])  # the upload completes
    return {"sweeps": [first, svc.process_dir(root)], "error_after_first": present}


def sc_permanent_oserror(side, root, mp):
    def witness_fn(payload):
        with open(payload["eml_path"]) as f:  # ENOENT
            f.read()

    write_reqs(root, [(3, 5)], eml_path=os.path.join(root, "no-such.eml"))
    svc = side.service(witness_fn=witness_fn)
    return {"sweeps": [svc.process_dir(root), svc.process_dir(root)]}


def sc_short_prover(side, root, mp):
    calls = []

    def short(dpk, wits):
        calls.append(len(wits))
        proofs = side.prove(dpk, wits)
        return proofs[:-1] if len(wits) > 1 else proofs

    write_reqs(root, [(3, 5), (2, 7)])
    return {"sweeps": [side.service(prover_fn=short).process_dir(root)], "calls": calls}


POISON = pow(4 * 4, 2, R)  # r2's public value


def sc_poisoned(side, root, mp):
    calls = []

    def poisoned(dpk, wits):
        calls.append(len(wits))
        if any(w[1] == POISON for w in wits):
            raise ValueError("poisoned witness")  # permanent: no retry
        return side.prove(dpk, wits)

    write_reqs(root, [(3, 5), (2, 7), (4, 4), (9, 2)])
    return {"sweeps": [side.service(batch_size=4, prover_fn=poisoned).process_dir(root)], "calls": calls}


def sc_poisoned_odd(side, root, mp):
    """A batch of 3 halves into 2 and 1 (the reference's split)."""
    calls = []

    def poisoned(dpk, wits):
        calls.append(len(wits))
        if any(w[1] == POISON for w in wits):
            raise ValueError("poisoned witness")
        return side.prove(dpk, wits)

    write_reqs(root, [(3, 5), (4, 4), (9, 2)])
    return {"sweeps": [side.service(batch_size=3, prover_fn=poisoned).process_dir(root)], "calls": calls}


def sc_all_poisoned(side, root, mp):
    def broken(dpk, wits):
        raise ValueError("poisoned witness")

    write_reqs(root, [(3, 5), (2, 7)])
    return {"sweeps": [side.service(prover_fn=broken).process_dir(root)]}


def sc_transient_retries(side, root, mp):
    write_reqs(root, [(3, 5), (2, 7)])
    side.arm("prove:raise:n=2", mp)
    return {"sweeps": [side.service(retries=2).process_dir(root)]}


def sc_retries_exhausted(side, root, mp):
    write_reqs(root, [(3, 5), (2, 7)])
    side.arm("prove:raise", mp)
    return {"sweeps": [side.service(retries=1).process_dir(root)]}


def sc_ladder_skip(side, root, mp):
    calls = []

    def always_broken(dpk, wits):
        calls.append(len(wits))
        raise ValueError("deterministic breakage")  # permanent, knob-blind

    write_reqs(root, [(3, 5)])
    return {"sweeps": [side.service(prover_fn=always_broken, batch_size=1).process_dir(root)], "calls": calls}


def sc_ladder_rescue(side, root, mp):
    """Works only with the multi-column path off: the reference's rungs
    from no-multi on set ZKP2P_MSM_MULTI=0 for their attempt; the port
    names the rung."""
    calls = []

    if side.port:
        def broken(dpk, wits, rung=None):
            calls.append(len(wits))
            if rung not in ("no-multi", "no-batch-affine", "sequential"):
                raise ValueError("multi-column path broken")
            return side.prove(dpk, wits)
    else:
        def broken(dpk, wits):
            calls.append(len(wits))
            if os.environ.get("ZKP2P_MSM_MULTI") != "0":
                raise ValueError("multi-column path broken")
            return side.prove(dpk, wits)

    broken.reads_msm_knobs = True
    write_reqs(root, [(3, 5)])
    stats = side.service(prover_fn=broken, batch_size=1).process_dir(root)
    return {"sweeps": [stats], "calls": calls, "env_restored": os.environ.get("ZKP2P_MSM_MULTI") is None}


def sc_deadline_claim(side, root, mp):
    write_reqs(root, [(3, 5)], prefix="old", deadline_s=5)
    write_reqs(root, [(2, 7)], prefix="fresh", deadline_s=3600)
    age(os.path.join(root, "old0.req.json"), 60)
    return {"sweeps": [side.service().process_dir(root)]}


def sc_deadline_assembly(side, root, mp):
    calls = []

    def counting(dpk, wits):
        calls.append(len(wits))
        return side.prove(dpk, wits)

    write_reqs(root, [(3, 5)], deadline_s=0.6)
    side.arm("witness:hang=1.2", mp)
    return {"sweeps": [side.service(prover_fn=counting).process_dir(root)], "calls": calls}


def sc_deadline_default(side, root, mp):
    write_reqs(root, [(3, 5)])
    age(os.path.join(root, "r0.req.json"), 60)
    first = side.service(deadline_s=5.0).process_dir(root)
    other = os.path.join(root, "nodeadline")
    os.makedirs(other)
    write_reqs(other, [(3, 5)])
    age(os.path.join(other, "r0.req.json"), 60)
    return {"sweeps": [first, side.service(deadline_s=0.0).process_dir(other)]}


def sc_spool_cap(side, root, mp):
    write_reqs(root, [(3, 5), (2, 7), (4, 4), (9, 2)])
    for i in range(4):
        age(os.path.join(root, f"r{i}.req.json"), 40 - 10 * i)  # r0 oldest, r3 newest
    return {"sweeps": [side.service(spool_cap=2).process_dir(root)]}


def sc_spool_cap_peer_claim(side, root, mp):
    write_reqs(root, [(3, 5), (2, 7), (4, 3)])
    with open(os.path.join(root, "r0.claim"), "w") as f:  # a peer holds r0 now
        json.dump({"pid": 99999999, "ts": time.time()}, f)
    stats = side.service(spool_cap=2).process_dir(root)
    os.unlink(os.path.join(root, "r0.claim"))
    return {"sweeps": [stats]}


def sc_enospc_emit(side, root, mp):
    write_reqs(root, [(3, 5)])
    side.arm("emit:enospc:once", mp)
    svc = side.service()
    first = svc.process_dir(root)
    left = sorted(os.listdir(root))
    return {"sweeps": [first, svc.process_dir(root)], "after_first": left}


def sc_witness_defer(side, root, mp):
    write_reqs(root, [(3, 5)])
    side.arm("witness:raise:once", mp)
    svc = side.service()
    first = svc.process_dir(root)
    return {"sweeps": [first, svc.process_dir(root)]}


def sc_batched_witness(side, root, mp):
    """The inputs_fn / witness_batch path, a bad payload among good ones,
    prefetch 2 (test_service.py's batched spool)."""
    write_reqs(root, [(3, 5), (2, 7), (6, 6), (9, 2), (5, 5)])
    with open(os.path.join(root, "bad.req.json"), "w") as f:
        json.dump({"x": "nope", "y": 1}, f)
    svc = side.service(inputs_fn=side.inputs_fn, prefetch=2)
    return {"sweeps": [svc.process_dir(root), svc.process_dir(root)]}


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items() if name.startswith("sc_")}


def terminal_files(root):
    """request id -> its terminal artifacts: the proof and public bytes,
    or the error state; a nested spool's requests under 'dir/id'."""
    out = {}
    for d, _, files in sorted(os.walk(root)):
        rel = os.path.relpath(d, root)
        for fn in sorted(files):
            if not fn.endswith(".req.json"):
                continue
            base = fn[: -len(".req.json")]
            key = base if rel == "." else f"{rel}/{base}"
            p = os.path.join(d, base)
            got = {}
            for ext in ("proof.json", "public.json"):
                if os.path.exists(f"{p}.{ext}"):
                    with open(f"{p}.{ext}", "rb") as f:
                        got[ext] = f.read()
            if os.path.exists(p + ".error.json"):
                with open(p + ".error.json") as f:
                    got["error_state"] = json.load(f)["state"]
            got["claim_left"] = os.path.exists(p + ".claim")
            out[key] = got
    return out


def records(root):
    """request id -> its request records, in order, as the compared fields."""
    out = {}
    for d, _, files in sorted(os.walk(os.path.dirname(root))):
        for fn in sorted(files):
            if not fn.endswith(".metrics.jsonl") or not os.path.join(d, fn).startswith(root):
                continue
            with open(os.path.join(d, fn)) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get("type") != "request":
                        continue
                    row = {k: rec.get(k) for k in RECORD_KEYS}
                    row["spans"] = [s["name"] for s in rec.get("spans", [])]
                    out.setdefault(f"{fn}:{rec['request_id']}", []).append(row)
    return out


def observe(side, scenario, root, monkeypatch):
    c0 = side.counters()
    got = SCENARIOS[scenario](side, root, monkeypatch)
    c1 = side.counters()
    got["counters"] = {k: c1[k] - c0[k] for k in c0}
    got["files"] = terminal_files(root)
    got["records"] = records(root)
    return got


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_port_service_matches_the_reference(world, scenario, tmp_path, monkeypatch):
    obs = {}
    for name in ("reference", "port"):
        root = tmp_path / name / "spool"
        root.mkdir(parents=True)
        obs[name] = observe(Side(name, world), scenario, str(root), monkeypatch)
        monkeypatch.delenv("ZKP2P_FAULTS", raising=False)
        ref_faults.reset()
        port_faults.reset()
    ref, port = obs["reference"], obs["port"]
    for key in ref:
        assert port[key] == ref[key], f"{scenario}: {key} differs"
    # the scenario did something: a sweep ended or deferred a request
    assert ref["records"]


def test_check_witness_raises_as_the_reference(world):
    """The port's vectorised Az*Bz = Cz check reports the first unsatisfied
    constraint as the reference's loop does, and accepts what it accepts."""
    ref, port = Side("reference", world), Side("port", world)
    good = {"x": 3, "y": 5}
    ref.cs.check_witness(ref.witness_fn(good))
    port.cs.check_witness(port.witness_fn(good))
    for wire in (1, 2, 3, 4):
        msgs = []
        for side in (ref, port):
            w = list(side.witness_fn(good))
            w[wire] = (w[wire] + 1) % R
            with pytest.raises(AssertionError) as e:
                side.cs.check_witness(w)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_transient_classes_are_the_reference_and_no_launch_error_is_one():
    """The reference's transient classes; on the card an out-of-memory
    error is transient (retried) and a launch or illegal-address error is
    not (isolated at once, never retried in a loop)."""
    import errno

    import torch

    from zkp2p_tpu.pipeline.service import _is_transient as ref_is_transient
    from zkp2p_tpu.utils.faults import FaultInjected as RefFaultInjected

    from zkp2p_tpu_torch.pipeline.service import _is_transient

    cases = [MemoryError(), OSError(errno.ENOSPC, "disk full"), OSError(errno.ENOENT, "no such file"),
             OSError("errno-less pool exhausted"), RuntimeError("RESOURCE_EXHAUSTED: resource exhausted"),
             RuntimeError("failed to allocate 2 GiB"), RuntimeError("no such spool /tmp/pool2"),
             ValueError("out of memory"), RuntimeError("sample proof failed verification"),
             RuntimeError("prover returned 1 proofs for a batch of 2")]
    assert [_is_transient(e) for e in cases] == [ref_is_transient(e) for e in cases]
    assert _is_transient(port_faults.FaultInjected("x")) and ref_is_transient(RefFaultInjected("x"))
    assert _is_transient(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    for e in (RuntimeError("zk_g1_window_accumulate: CUDA launch failed with cudaError 700"),
              RuntimeError("CUDA error: an illegal memory access was encountered"),
              RuntimeError("CUDA error: unspecified launch failure")):
        assert not _is_transient(e)


@pytest.mark.parametrize("spec", ["seed=7,prove:raise:p=0.3,emit:enospc:once,witness:hang=0:n=2:after=1",
                                  "claim:raise:n=3,sink:raise:p=0.5,seed=3", "prove:raise", ""])
def test_fault_plans_fire_as_the_reference(spec):
    """The spec grammar and the seeded draws: both plans fire the same
    hits, raising the same errors."""
    ref, port = ref_faults.parse_faults(spec), port_faults.parse_faults(spec)
    assert ref.digest == port.digest and sorted(ref.by_site) == sorted(port.by_site)
    fired = []
    for plan in (ref, port):
        got = []
        for i in range(40):
            site = ("prove", "emit", "witness", "claim", "sink")[i % 5]
            try:
                plan.fire(site)
                got.append(None)
            except OSError as e:
                got.append(("enospc", e.errno, str(e)))
            except RuntimeError as e:
                got.append(("raise", str(e)))
        fired.append(got)
    assert fired[0] == fired[1]


@pytest.mark.parametrize("spec", ["prove", "prove:explode", "pro ve:raise", "prove:raise:p=2", "prove:raise:n=-1",
                                  "prove:raise:after=x", "prove:hang=-1", "seed=x", "prove:raise:often"])
def test_malformed_fault_specs_raise_as_the_reference(spec):
    with pytest.raises(ValueError):
        ref_faults.parse_faults(spec)
    with pytest.raises(ValueError):
        port_faults.parse_faults(spec)
    port_faults.arm("prove:raise:n=1")
    with pytest.raises(ValueError):
        port_faults.arm(spec)
    with pytest.raises(port_faults.FaultInjected):  # the armed plan stands
        port_faults.fault_point("prove")
    port_faults.fault_point("prove")  # spent
