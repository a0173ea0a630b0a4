"""The port's instruments (zkp2p_tpu_torch.utils: trace, audit, metrics),
the cases of the reference's tests/test_trace.py and test_audit.py that
apply to them: per-thread nesting, stack and context handed across a
pool, the ring's bound and drop count, drain, the dump's manifest and
whole lines under concurrent dumps; the execution digest, the arm
counters and map, a registry reset, and the device memory sampler (None
without a CUDA device, gauges from the allocator's counters); the
digest and the arm strings against the reference's on the same maps."""

import json
import re
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from zkp2p_tpu.utils import audit as ref_audit
from zkp2p_tpu_torch.utils import audit
from zkp2p_tpu_torch.utils import trace as tr
from zkp2p_tpu_torch.utils.metrics import REGISTRY, run_manifest


@pytest.fixture(autouse=True)
def fresh_trace():
    tr.reset()
    tr.clear_context()
    yield
    tr.resize_ring()
    tr.reset()
    tr.clear_context()


# ---------------------------------------------------------------- trace


def test_per_thread_nesting_isolation():
    barrier = threading.Barrier(2, timeout=30)

    def worker(name):
        for _ in range(50):
            with tr.trace(f"{name}_outer"):
                barrier.wait()
                with tr.trace(f"{name}_inner"):
                    pass

    threads = [threading.Thread(target=worker, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    recs = tr.records()
    assert len(recs) == 200
    for rec in recs:
        stage = rec["stage"]
        assert not ("a_" in stage and "b_" in stage), f"cross-thread frame leak: {stage}"
        if "inner" in stage:
            assert stage == f"{stage[0]}_outer/{stage[0]}_inner"


def test_stack_and_context_adoption_across_worker_pool():
    tr.set_context(request_id="req-42")
    with tr.trace("prove"):
        stack, ctx = tr.current_stack(), tr.current_context()

        def seeded(tag):
            tr.adopt_stack(stack)
            tr.adopt_context(ctx)
            with tr.trace(f"msm_{tag}"):
                pass
            return tr.records()[-1]

        with ThreadPoolExecutor(max_workers=4) as ex:
            recs = list(ex.map(seeded, ["a", "b1", "b2", "c"]))
    for rec in recs:
        assert rec["stage"].startswith("prove/msm_") and rec["request_id"] == "req-42"
    assert tr.records()[-1]["stage"] == "prove" and tr.records()[-1]["request_id"] == "req-42"
    tr.clear_context()
    with tr.trace("after"):
        pass
    assert "request_id" not in tr.records()[-1]


def test_explicit_attrs_win_over_context_and_none_removes():
    tr.set_context(request_id="ambient", batch=3)
    with tr.trace("s", request_id="explicit"):
        pass
    assert tr.records()[-1]["request_id"] == "explicit" and tr.records()[-1]["batch"] == 3
    tr.set_context(batch=None)
    assert tr.current_context() == {"request_id": "ambient"}


def test_ring_bound_and_drop_count():
    base = REGISTRY.counter("zkp2p_trace_dropped_total").value
    tr.resize_ring(16)
    for i in range(50):
        with tr.trace("x", i=i):
            pass
    assert len(tr.records()) == 16 and tr.dropped() == 34
    assert tr.records()[-1]["i"] == 49 and tr.records()[0]["i"] == 34
    assert REGISTRY.counter("zkp2p_trace_dropped_total").value == base + 34
    tr.resize_ring()
    assert len(tr.records()) == 16  # growing keeps what is there


def test_drain_empties_ring_and_spans_feed_the_histogram():
    h = REGISTRY.histogram("zkp2p_stage_ms", {"stage": "a"})
    n0 = h.count
    with tr.trace("a"):
        pass
    with tr.trace("b"):
        pass
    assert [r["stage"] for r in tr.drain()] == ["a", "b"]
    assert tr.records() == []
    assert REGISTRY.histogram("zkp2p_stage_ms", {"stage": "a"}).count == n0 + 1


def test_dump_stamps_run_id_pid_and_manifest(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with tr.trace("stage_one"):
        pass
    tr.dump_trace(p)
    tr.dump_trace(p)  # appends, never truncates
    lines = [json.loads(ln) for ln in open(p)]
    manifests = [ln for ln in lines if ln.get("type") == "manifest"]
    stages = [ln for ln in lines if "stage" in ln]
    assert len(manifests) == 2 and len(stages) == 2
    for m in manifests:
        assert m["run_id"] and m["pid"] and m["device"] == "cpu" and m["torch"] == torch.__version__
        assert "trace_dropped" in m and "execution_digest" in m
    assert all(ln["run_id"] == manifests[0]["run_id"] and ln["pid"] == manifests[0]["pid"] for ln in stages)


def test_concurrent_dumps_produce_only_intact_lines(tmp_path):
    p = str(tmp_path / "c.jsonl")
    for i in range(64):
        with tr.trace("warm", i=i):
            pass

    def dumper():
        for _ in range(5):
            tr.dump_trace(p)

    threads = [threading.Thread(target=dumper) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    lines = open(p).read().splitlines()
    assert len(lines) == 20 * 65
    for ln in lines:
        json.loads(ln)  # raises on a torn line


def test_profile_is_a_no_op_without_a_directory(tmp_path):
    with tr.profile("p") as prof:
        pass
    assert prof is None
    with tr.profile("p", trace_dir=str(tmp_path / "prof")) as prof:
        torch.ones(4).sum()
    assert prof is not None and (tmp_path / "prof" / "p.json").is_file()


# ---------------------------------------------------------------- audit


@pytest.mark.parametrize("arms,same", [
    ({"g2": "b", "g1": "a"}, True),  # order-independent
    ({"g1": "c", "g2": "b"}, False),  # one arm flipped
    ({"g1": "a", "g2": "b", "g3": "x"}, False),  # one gate added
])
def test_execution_digest_stable_and_arm_sensitive(arms, same):
    d_ab = audit.execution_digest({"g1": "a", "g2": "b"})
    assert re.fullmatch(r"[0-9a-f]{16}", d_ab)
    assert (audit.execution_digest(arms) == d_ab) == same


ARM_MAPS = [
    {},
    {"msm_affine": "off", "msm_h": "windowed"},
    {"msm_affine": "on", "msm_h": "bucket", "batch_chunk": "4"},
    {"batch_chunk": "0", "msm_h": "windowed", "msm_affine": "off"},
]


@pytest.mark.parametrize("arms", ARM_MAPS)
def test_execution_digest_equals_the_reference(arms, monkeypatch):
    """The same map hashes alike; the same record_arm calls (the provers'
    values, bools and ints among them) leave the same map and digest in
    both processes' recorders, and the manifest carries the port's."""
    assert audit.execution_digest(arms) == ref_audit.execution_digest(arms)
    for mod in (audit, ref_audit):
        monkeypatch.setattr(mod, "_arms", {})
    calls = [(g, {"on": True, "off": False}.get(a, int(a) if a.isdigit() else a)) for g, a in arms.items()]
    for g, a in calls:
        assert audit.record_arm(g, a) is a and ref_audit.record_arm(g, a) is a
    assert audit.gate_arms() == ref_audit.gate_arms() == arms
    assert run_manifest()["execution_digest"] == ref_audit.execution_digest()


@pytest.mark.parametrize("arm", [True, False, "windowed", "bucket", 4, 0, -1])
def test_arm_strings_equal_the_reference(arm):
    assert audit._arm_str(arm) == ref_audit._arm_str(arm)


def test_record_arm_counters_and_map():
    base = REGISTRY.counter("zkp2p_path_taken_total", {"gate": "test_gate", "arm": "x"}).value
    assert audit.record_arm("test_gate", "x") == "x"
    audit.record_arm("test_gate", "x")
    assert REGISTRY.counter("zkp2p_path_taken_total", {"gate": "test_gate", "arm": "x"}).value == base + 2
    assert audit.gate_arms()["test_gate"] == "x"
    assert audit.record_arm("test_gate_b", True) is True
    assert audit.gate_arms()["test_gate_b"] == "on"
    audit.record_arm("test_gate_b", False)
    assert audit.gate_arms()["test_gate_b"] == "off"


def test_record_arm_survives_registry_reset_and_manifest_carries_it():
    audit.record_arm("test_gen_gate", "a")
    REGISTRY.reset()
    audit.record_arm("test_gen_gate", "a")
    assert REGISTRY.counter("zkp2p_path_taken_total", {"gate": "test_gen_gate", "arm": "a"}).value == 1
    man = run_manifest()
    assert man["gates"]["test_gen_gate"] == "a" and man["execution_digest"] == audit.execution_digest()
    audit.reset()
    assert audit.gate_arms() == {}


def test_memory_sampler_gives_none_on_the_cpu():
    assert audit.sample_device_memory("test") is None


def test_memory_sampler_gauges(monkeypatch):
    """The allocator's counters as the reference's HBM gauges, with a
    per-stage peak that keeps its maximum; a device with no allocation
    (no context) is skipped."""
    stats = {0: {"allocated_bytes.all.current": 100, "allocated_bytes.all.peak": 250},
             1: {"allocated_bytes.all.current": 0, "allocated_bytes.all.peak": 0}}
    asked = []

    def mem_get_info(i):
        asked.append(i)
        return (0, 1000)

    for name, fn in (("is_available", lambda: True), ("is_initialized", lambda: True),
                     ("device_count", lambda: 2), ("current_device", lambda: 0),
                     ("memory_stats", lambda i: stats[i]), ("mem_get_info", mem_get_info)):
        monkeypatch.setattr(torch.cuda, name, fn)
    got = audit.sample_device_memory("test_stage")
    assert got == {"device": 0, "bytes_in_use": 100, "peak_bytes_in_use": 250, "bytes_limit": 1000}
    assert asked == [0]
    assert REGISTRY.gauge("zkp2p_hbm_bytes_in_use", {"device": "0"}).value == 100
    assert REGISTRY.gauge("zkp2p_hbm_peak_bytes", {"device": "0"}).value == 250
    assert REGISTRY.gauge("zkp2p_hbm_bytes_limit", {"device": "0"}).value == 1000
    assert REGISTRY.gauge("zkp2p_hbm_stage_peak_bytes", {"stage": "test_stage"}).value == 250
    stats[0] = {"allocated_bytes.all.current": 50, "allocated_bytes.all.peak": 60}
    audit.sample_device_memory("test_stage")
    assert REGISTRY.gauge("zkp2p_hbm_stage_peak_bytes", {"stage": "test_stage"}).value == 250
