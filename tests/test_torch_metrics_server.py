"""The port's Prometheus exposition (zkp2p_tpu_torch.utils.metrics and
utils.slo) against the reference's: the same instruments fed to both
registries give the same Prometheus text; snapshots merge to the same
state, and a bucket-layout mismatch raises in both; the endpoint is off
by default, port 0 binds a port the manifest reports, and its four
routes answer as the reference's: /metrics (200, Prometheus text),
/status (503 before a preflight, 200 after, with the reference's keys),
/healthz (200), /snapshot (armed, worker, fleet, the SLO window, and
metrics the reference's Registry.merge takes), 404 elsewhere."""

import json
import urllib.error
import urllib.request

import pytest

from zkp2p_tpu.utils import audit as ref_audit
from zkp2p_tpu.utils import metrics as ref_metrics
from zkp2p_tpu.utils import slo as ref_slo
from zkp2p_tpu_torch.utils import audit, metrics, slo

SIDES = {"reference": ref_metrics, "port": metrics}
# timing fields, which differ between two calls
TIMING = {"ts", "uptime_s", "pid", "run_id", "execution_digest"}


def feed(M):
    """The same instruments, in the same order, into a fresh registry."""
    r = M.Registry()
    r.counter("zkp2p_service_requests_total", {"state": "done"}).inc(3)
    r.counter("zkp2p_service_requests_total", {"state": "error-bad-input"}).inc()
    r.counter("zkp2p_proves_total", {"prover": "gpu"}).inc(2.5)
    r.counter("zkp2p_fleet_restarts_total", {"worker": "w1"}).inc(1234567)
    r.gauge("zkp2p_hbm_peak_bytes", {"device": "0"}).set(34_320_000_000)
    r.gauge("zkp2p_slo_attainment").set(0.875)
    r.gauge("zkp2p_odd_family", {"path": 'a"b\\c\nd'}).set(-1.5)
    h = r.histogram("zkp2p_stage_ms", {"stage": "service/prove"})
    for v in (0.5, 3, 42, 2900.25, 1e6):
        h.observe(v)
    f = r.histogram("zkp2p_service_batch_fill", buckets=(1, 2, 4, 8))
    for v in (1, 2, 2, 4, 9):
        f.observe(v)
    return r


def test_prometheus_text_equals_the_reference():
    ref, port = feed(ref_metrics), feed(metrics)
    assert port.to_prometheus() == ref.to_prometheus()
    assert '# HELP zkp2p_odd_family zkp2p metric (docs/OBSERVABILITY.md)' in port.to_prometheus()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        want = ref.histogram("zkp2p_stage_ms", {"stage": "service/prove"}).quantile(q)
        assert port.histogram("zkp2p_stage_ms", {"stage": "service/prove"}).quantile(q) == want


def test_snapshot_merge_round_trips_as_the_reference():
    merged = {}
    for side, M in SIDES.items():
        snap = feed(M).snapshot()
        json.dumps(snap)
        r = M.Registry()
        r.merge(snap)
        r.gauge("zkp2p_slo_attainment").set(0.5)  # a gauge merges as the max
        r.merge(snap)
        merged[side] = sorted(r.snapshot(), key=lambda m: (m["kind"], m["name"], sorted(m["labels"].items())))
    assert merged["port"] == merged["reference"]
    # each side merges the other's snapshot
    port = metrics.Registry()
    port.merge(feed(ref_metrics).snapshot())
    ref = ref_metrics.Registry()
    ref.merge(feed(metrics).snapshot())
    assert port.to_prometheus() == ref.to_prometheus()


def test_a_bucket_layout_mismatch_raises_as_in_the_reference():
    for M in SIDES.values():
        a = M.Registry()
        a.histogram("ms", buckets=(1, 2)).observe(1)
        b = M.Registry()
        b.histogram("ms", buckets=(1, 2, 3)).observe(1)
        with pytest.raises(ValueError, match="bucket layout mismatch"):
            b.merge(a.snapshot())


def test_window_state_equals_the_reference():
    got = []
    for mod in (ref_slo, slo):
        t = mod.SloTracker(objective_s=2.0, window_s=100.0, clock=lambda: 0.0)
        for i in range(60):
            t.observe(0.5 + (i * 37 % 11) / 4.0, ok=i % 7 != 0, now=i * 3.0)
        got.append((t.window_state(now=180.0), t.window_state(max_samples=5, now=180.0)))
    assert got[0] == got[1]


def get(url):
    """(status, body) of a GET, errors included."""
    try:
        r = urllib.request.urlopen(url, timeout=5)
        return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_the_endpoint_is_off_by_default():
    metrics.stop_metrics_server()
    assert metrics.maybe_start_metrics_server() is None
    assert metrics.bound_metrics_port() is None and "metrics_port_bound" not in metrics.run_manifest()


def test_endpoint_routes_against_the_reference(monkeypatch):
    ident = {"worker": "w3", "fleet": "f42"}
    monkeypatch.setattr(audit, "_preflight_report", None)
    metrics.REGISTRY.counter("zkp2p_service_requests_total", {"state": "done"}).inc()
    metrics.REGISTRY.counter("zkp2p_service_takeovers_total", {"result": "won"}).inc()
    metrics.stop_metrics_server()
    srv = metrics.maybe_start_metrics_server(port=0, identity=ident)
    try:
        port = metrics.bound_metrics_port()
        assert srv is not None and port > 0 and metrics.run_manifest()["metrics_port_bound"] == port
        assert metrics.maybe_start_metrics_server(port=0) is srv  # one a process
        base = f"http://127.0.0.1:{port}"
        code, ctype, body = get(base + "/metrics")
        text = body.decode()
        assert (code, ctype) == (200, "text/plain; version=0.0.4")
        assert 'zkp2p_service_requests_total{state="done"}' in text and "# TYPE zkp2p_slo_attainment gauge" in text
        code, _, body = get(base + "/status")
        closed = json.loads(body)
        assert code == 503 and closed["ok"] is False and "preflight" in closed["reason"]
        rep = audit.preflight(workload=False)
        assert audit.last_preflight() == {"ts": rep["ts"], "backend": rep["backend"], "warnings": len(rep["warnings"]),
                                          "execution_digest": rep["execution_digest"]}
        code, _, body = get(base + "/status")
        opened = json.loads(body)
        assert code == 200 and opened["ok"] is True and opened["worker"] == "w3" and opened["fleet"] == "f42"
        assert opened["execution_digest"] == audit.execution_digest() and opened["requests"]["done"] >= 1
        assert opened["counters"]["takeovers_won"] >= 1
        code, ctype, body = get(base + "/healthz")
        assert (code, ctype, json.loads(body)) == (200, "application/json", {"ok": True})
        code, _, body = get(base + "/snapshot")
        snap = json.loads(body)
        assert code == 200 and snap["armed"] is True and (snap["worker"], snap["fleet"]) == ("w3", "f42")
        assert snap["slo_window"]["n"] == slo.default_tracker().window_state()["n"]
        ref_metrics.Registry().merge(snap["metrics"])
        metrics.Registry().merge(snap["metrics"])
        assert get(base + "/nope")[0] == 404
    finally:
        metrics.stop_metrics_server()
    assert metrics.bound_metrics_port() is None

    # the reference's payloads for the same identity (its environment) and
    # state: the same keys, timing fields aside
    monkeypatch.setenv("ZKP2P_WORKER_ID", "w3")
    monkeypatch.setenv("ZKP2P_FLEET_ID", "f42")
    monkeypatch.setattr(ref_audit, "_preflight_report", None)
    want_closed = ref_slo.status_payload()
    monkeypatch.setattr(ref_audit, "_preflight_report", {"ts": 1.0, "backend": "cpu", "warnings": 0,
                                                         "execution_digest": "x"})
    want = ref_slo.status_payload()
    assert set(closed) == set(want_closed) and set(opened) == set(want)
    for k in ("slo", "preflight"):
        assert set(opened[k]) == set(want[k])
    assert {k: v for k, v in opened.items() if k not in TIMING | {"slo", "preflight", "requests", "counters"}} == {
        k: v for k, v in want.items() if k not in TIMING | {"slo", "preflight", "requests", "counters"}}
    ref_metrics.stop_metrics_server()
    assert ref_metrics.maybe_start_metrics_server(port=0) is not None
    try:
        code, _, body = get(f"http://127.0.0.1:{ref_metrics.bound_metrics_port()}/snapshot")
        assert set(json.loads(body)) == set(snap)
    finally:
        ref_metrics.stop_metrics_server()


def test_a_taken_port_leaves_the_endpoint_off(capsys):
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen()
    try:
        metrics.stop_metrics_server()
        assert metrics.maybe_start_metrics_server(port=s.getsockname()[1]) is None
        assert metrics.bound_metrics_port() is None
        assert "exposition off" in capsys.readouterr().err
    finally:
        s.close()
