"""The port's service (zkp2p_tpu_torch.pipeline.service) across workers
and over its run loop: stale-claim takeover, a fresh claim left alone,
worker threads partitioning one spool exactly once, request_drain in the
middle of a sweep, and the time-series line's schema (held to the
reference sampler's keys).  The prover is the reference's host prover at
a pinned (r, s), its proofs as the port's points (test_torch_service)."""

import json
import os
import sys
import threading
import time

import pytest

from zkp2p_tpu.pipeline.service import TimeseriesSampler as RefSampler
from zkp2p_tpu.utils.metrics import JsonlSink as RefSink

from test_torch_service import Side, age, write_reqs
from zkp2p_tpu_torch.pipeline.fleet import slowed_prover
from zkp2p_tpu_torch.pipeline.service import ProvingService
from zkp2p_tpu_torch.utils.metrics import REGISTRY


@pytest.fixture(scope="module")
def side():
    from test_torch_service import RefCS, RefLC, build_cs, ref_setup

    cs, _, _ = build_cs(RefCS, RefLC)
    pk, vk = ref_setup(cs, seed="svc-claims")
    return Side("port", {"cs": cs, "pk": pk, "vk": vk})


def sink_lines(spool, kind):
    with open(str(spool).rstrip("/") + ".metrics.jsonl") as f:
        return [rec for rec in map(json.loads, f) if rec.get("type") == kind]


def dead_claim(spool, name, seconds=3600):
    claim = os.path.join(spool, name + ".claim")
    with open(claim, "w") as f:
        json.dump({"pid": 99999999, "ts": 0.0}, f)
    age(claim, seconds)
    return claim


def files(spool, ext):
    return sorted(f for f in os.listdir(spool) if f.endswith(ext))


def test_stale_claim_is_taken_over_and_the_request_ends_once(side, tmp_path):
    spool = str(tmp_path)
    write_reqs(spool, [(3, 5), (2, 7)])
    claim = dead_claim(spool, "r0")
    svc = side.service(stale_claim_s=10.0)
    won = REGISTRY.counter("zkp2p_service_takeovers_total", {"result": "won"}).value
    assert svc._try_claim(os.path.join(spool, "r0")) is True
    with open(claim) as f:
        owner = json.load(f)
    assert owner["pid"] == os.getpid() and owner["takeover"] is True
    assert REGISTRY.counter("zkp2p_service_takeovers_total", {"result": "won"}).value == won + 1
    age(claim, 3600)  # the taker dies too
    assert svc.process_dir(spool)["done"] == 2
    assert files(spool, ".proof.json") == ["r0.proof.json", "r1.proof.json"] and not files(spool, ".claim")
    assert sorted((r["request_id"], r["state"]) for r in sink_lines(spool, "request")) == [
        ("r0", "done"), ("r1", "done")]
    assert not any(side.service(stale_claim_s=10.0).process_dir(spool).values())


def test_fresh_claim_is_left_alone(side, tmp_path):
    spool = str(tmp_path)
    write_reqs(spool, [(3, 5)])
    claim = os.path.join(spool, "r0.claim")
    peer = {"pid": 424242, "ts": time.time()}
    with open(claim, "w") as f:
        json.dump(peer, f)
    assert not any(side.service(stale_claim_s=300.0).process_dir(spool).values())
    assert not files(spool, ".proof.json") and not files(spool, ".error.json")
    with open(claim) as f:
        assert json.load(f) == peer


@pytest.mark.parametrize("workers", [2, 4])
def test_worker_threads_partition_one_spool_exactly_once(side, tmp_path, workers):
    """More workers than batches' worth of work at once, the interpreter
    switching threads often: claims give every request to exactly one."""
    spool = str(tmp_path)
    pairs = [(3, 5), (2, 7), (4, 4), (9, 2), (5, 5), (6, 6), (7, 3), (8, 2)]
    write_reqs(spool, pairs)
    prover = slowed_prover(side.prove, per_request_s=0.02)
    results, errors = {}, []

    def run(i):
        try:
            results[i] = side.service(prover_fn=prover, batch_size=2).process_dir(spool)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sum(r["done"] for r in results.values()) == len(pairs)
    assert len(files(spool, ".proof.json")) == len(pairs) and not files(spool, ".claim")
    done = [r["request_id"] for r in sink_lines(spool, "request") if r["state"] == "done"]
    assert sorted(done) == [f"r{i}" for i in range(len(pairs))]


def test_request_drain_mid_sweep_finishes_what_it_claimed(side, tmp_path):
    spool = str(tmp_path)
    write_reqs(spool, [(3, 5), (2, 7), (4, 4), (9, 2), (5, 5), (6, 6), (7, 3), (8, 2)])
    svc = side.service(prover_fn=slowed_prover(side.prove, per_request_s=0.3), batch_size=1)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("why", svc.run(spool, poll_s=0.05)))
    t.start()
    deadline = time.time() + 60
    while not files(spool, ".claim") and time.time() < deadline:
        time.sleep(0.01)
    svc.request_drain()
    t.join(timeout=120)
    assert not t.is_alive() and out["why"] == "drained" and svc.draining
    assert not files(spool, ".claim")
    ended = files(spool, ".proof.json")
    # every request it claimed ended done; the rest were never claimed
    assert 1 <= len(ended) < 8 and not files(spool, ".error.json")
    assert sorted(r["request_id"] + ".proof.json" for r in sink_lines(spool, "request")) == ended
    assert sink_lines(spool, "timeseries")


def test_timeseries_line_has_the_reference_schema(side, tmp_path):
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    write_reqs(spool, [(3, 5), (2, 7)])
    svc = side.service()
    assert svc.run(spool, poll_s=0.01, max_sweeps=1) == "sweeps"
    (line,) = sink_lines(spool, "timeseries")
    assert line["arrivals"] == 2 and line["backlog"] == 0 and line["claimable"] == 0 and line["in_flight"] == 0
    assert line["batch_fill_last"] == 2 and line["batch_size_target"] == 2 and line["window_s"] == 10.0
    assert line["counters"]["requests_done"] >= 2 and line["slo"]["n"] >= 2
    ref = RefSampler(10.0, 300.0)
    ref.batch_fill_last = ref.batch_target_last = 2
    ref_line = ref.maybe_sample(spool, RefSink(str(tmp_path / "ref.jsonl")), force=True)
    # the reference adds its C++ prover's counters and fleet identity
    # where it has them; neither exists in the port
    want = set(ref_line) - {"native_delta", "worker", "fleet"}
    assert set(line) == want
    assert set(line["slo"]) == set(ref_line["slo"])
    stages = {r["stage"] for r in sink_lines(spool, "stage")}
    assert {"service/witness", "service/prove", "service/verify", "service/emit"} <= stages


def test_fleet_identity_on_records_and_the_timeseries_line(side, tmp_path, monkeypatch):
    """A worker's identity (the supervisor's flags) on its request
    records and time-series lines, as the reference's sampler stamps it
    from its environment."""
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    write_reqs(spool, [(3, 5), (2, 7)])
    svc = side.service(worker_id="w7", fleet_id="fleet42")
    assert svc.run(spool, poll_s=0.01, max_sweeps=1) == "sweeps"
    (line,) = sink_lines(spool, "timeseries")
    assert (line["worker"], line["fleet"]) == ("w7", "fleet42")
    reqs = sink_lines(spool, "request")
    assert len(reqs) == 2 and all((r["worker"], r["fleet"]) == ("w7", "fleet42") for r in reqs)
    monkeypatch.setenv("ZKP2P_WORKER_ID", "w7")
    monkeypatch.setenv("ZKP2P_FLEET_ID", "fleet42")
    ref_line = RefSampler(10.0, 300.0).maybe_sample(spool, RefSink(str(tmp_path / "ref.jsonl")), force=True)
    assert set(line) == set(ref_line) - {"native_delta"}
    assert (ref_line["worker"], ref_line["fleet"]) == ("w7", "fleet42")


def test_slo_tracker_snapshots_equal_the_reference():
    from zkp2p_tpu.utils.slo import SloTracker as RefTracker

    from zkp2p_tpu_torch.utils.slo import SloTracker

    samples = [(t * 7.0, 0.5 + (t * 37 % 11) / 4.0, t % 5 != 0) for t in range(60)]
    for objective, window in ((0.0, 300.0), (2.0, 300.0), (2.0, 100.0), (1.5, 0.0)):
        got = []
        for cls in (RefTracker, SloTracker):
            tr = cls(objective_s=objective, window_s=window, clock=lambda: 0.0)
            for t, lat, ok in samples:
                tr.observe(lat, ok=ok, now=t)
            got.append(tr.snapshot(now=samples[-1][0]))
        assert got[0] == got[1]


def test_jsonl_sink_rotates_and_stamps_as_the_reference(tmp_path):
    """The reference's rotation: <path>, <path>.1 .. .<backups>, each
    file opening with a manifest line and held under max_bytes, the
    newest records kept in order.  (The two manifests differ in size, so
    the files hold different numbers of records.)"""
    from zkp2p_tpu_torch.utils.metrics import JsonlSink

    for name, cls in (("ref", RefSink), ("port", JsonlSink)):
        d = tmp_path / name
        sink = cls(str(d / "s.jsonl"), max_bytes=8192, backups=2)
        for i in range(150):
            sink.write({"type": "request", "i": i, "pad": "x" * 200})
        files = sorted(p.name for p in d.iterdir() if not p.name.endswith(".lock"))
        assert files == ["s.jsonl", "s.jsonl.1", "s.jsonl.2"], name
        kept = []
        for f in ("s.jsonl.2", "s.jsonl.1", "s.jsonl"):
            assert (d / f).stat().st_size <= 8192
            with open(d / f) as fh:
                recs = [json.loads(ln) for ln in fh]
            assert recs[0]["type"] == "manifest" and all(r["type"] == "request" for r in recs[1:]), name
            kept += [r["i"] for r in recs[1:]]
        assert kept == list(range(150 - len(kept), 150)), name
