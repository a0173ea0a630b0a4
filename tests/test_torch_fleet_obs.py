"""The port's fleet observability plane (zkp2p_tpu_torch.pipeline.fleet_obs,
utils.alerts, the merge of SLO windows in utils.slo) against the
reference's, on the same inputs: the cases of tests/test_fleet_obs.py
(all but the trace-report ones), each run through both packages and
compared, then held to the reference's own assertions.

  * the merge: counters summed, gauges labelled by worker, histograms
    merged bucket by bucket, a bucket layout that differs refused and
    counted;
  * the merged SLO window against a pooled oracle (not an average), the
    true n under a transport cap, the fast / slow burn split;
  * the alert engine under an injected clock: for_s, one fire under a
    flapping signal, clear_s, a missing signal holding its state, an
    empty window never burning, the restart storm on a park, the
    heartbeat gap and the governor; the trend tracker;
  * the plane's /status failing closed until every live worker is armed,
    and the heartbeat's SLO window standing in for a failed scrape;
  * `top`'s frame for the same body.

The two-worker plane on the CPU (its counters equal to the workers' sum)
runs in the fleet of tests/test_torch_fleet_smoke.py."""

import random
import time

import pytest

from zkp2p_tpu.pipeline import fleet_obs as ref_obs
from zkp2p_tpu.utils import alerts as ref_alerts
from zkp2p_tpu.utils import metrics as ref_metrics
from zkp2p_tpu.utils import slo as ref_slo
from zkp2p_tpu.utils.config import load_config
from zkp2p_tpu_torch.pipeline import fleet_obs
from zkp2p_tpu_torch.utils import alerts, metrics, slo

SIDES = {"reference": (ref_obs, ref_alerts, ref_metrics, ref_slo), "port": (fleet_obs, alerts, metrics, slo)}
# the reference test's thresholds: for 5 s, clear 10 s, burn 2, restarts 3, gap 15 s
ALERT_ENV = {"ZKP2P_ALERT_FOR_S": "5", "ZKP2P_ALERT_CLEAR_S": "10", "ZKP2P_ALERT_BURN_RATE": "2",
             "ZKP2P_ALERT_RESTARTS": "3", "ZKP2P_ALERT_HB_GAP_S": "15"}


def keyed(reg):
    return {(m["name"], m["kind"], tuple(sorted(m["labels"].items()))): m for m in reg.snapshot()}


def both(fn):
    """fn(side's modules) on both sides; the two results equal; the
    port's returned."""
    got = {side: fn(*mods) for side, mods in SIDES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


# ------------------------------------------------------------ the merge


def worker_registry(m, done: int, backlog: float, fills):
    r = m.Registry()
    r.counter("zkp2p_service_requests_total", {"state": "done"}).inc(done)
    r.gauge("zkp2p_service_backlog").set(backlog)
    h = r.histogram("zkp2p_service_batch_fill", buckets=(1, 2, 4, 8))
    for f in fills:
        h.observe(f)
    return r


def test_merge_counter_sum_gauge_label_histogram_buckets():
    def merged(obs, _a, m, _s):
        fleet = m.Registry()
        obs.merge_worker_metrics(fleet, worker_registry(m, 3, 4, [1, 2]).snapshot(), "w0")
        obs.merge_worker_metrics(fleet, worker_registry(m, 5, 7, [2, 8]).snapshot(), "w1")
        return keyed(fleet), fleet.to_prometheus()

    snap, text = both(merged)
    c = snap[("zkp2p_service_requests_total", "counter", (("state", "done"),))]
    assert c["value"] == 8
    assert snap[("zkp2p_service_backlog", "gauge", (("worker", "w0"),))]["value"] == 4
    assert snap[("zkp2p_service_backlog", "gauge", (("worker", "w1"),))]["value"] == 7
    h = snap[("zkp2p_service_batch_fill", "histogram", ())]
    assert h["count"] == 4 and h["sum"] == 13 and h["counts"][:4] == [1, 2, 0, 1]
    assert 'zkp2p_service_backlog{worker="w1"} 7' in text


def test_merge_refuses_histogram_bucket_mismatch():
    def merged(obs, _a, m, _s):
        fleet = m.Registry()
        obs.merge_worker_metrics(fleet, worker_registry(m, 1, 0, [1]).snapshot(), "w0")
        bad = m.Registry()
        bad.histogram("zkp2p_service_batch_fill", buckets=(10, 20)).observe(15)
        bad.counter("zkp2p_service_requests_total", {"state": "done"}).inc(2)
        refused = []
        obs.merge_worker_metrics(fleet, bad.snapshot(), "w1", refused=refused.append)
        return refused, keyed(fleet)

    refused, snap = both(merged)
    assert refused == ["zkp2p_service_batch_fill"]
    assert snap[("zkp2p_service_requests_total", "counter", (("state", "done"),))]["value"] == 3
    assert snap[("zkp2p_service_batch_fill", "histogram", ())]["count"] == 1


def test_registry_merge_raises_on_bucket_mismatch():
    for _obs, _a, m, _s in SIDES.values():
        a = m.Registry()
        a.histogram("h", buckets=(1, 2)).observe(1)
        b = m.Registry()
        b.histogram("h", buckets=(3, 4)).observe(3)
        with pytest.raises(ValueError, match="bucket layout mismatch"):
            a.merge(b.snapshot())


def test_fleet_families_have_the_reference_help_text():
    names = [n for n in ref_metrics.METRIC_HELP if n.startswith("zkp2p_fleet_")
             and n not in ("zkp2p_fleet_workers_target",)]
    assert all(metrics.METRIC_HELP.get(n) == ref_metrics.METRIC_HELP[n] for n in names)

    def text(_o, _a, m, s):
        reg = m.Registry()
        s.publish_fleet_slo(s.merge_window_states([]), registry=reg)
        reg.counter("zkp2p_fleet_scrapes_total").inc()
        reg.counter("zkp2p_fleet_alerts_total", {"rule": "slo_burn"}).inc()
        return reg.to_prometheus()

    assert "# HELP zkp2p_fleet_slo_burn_fast" in both(text)


# ----------------------------------------------------- the merged window


def test_merged_window_equals_pooled_oracle():
    def run(_o, _a, _m, s):
        rng = random.Random(7)
        oracle = s.SloTracker(objective_s=2.0, target=0.9, window_s=300.0, clock=lambda: 100.0)
        workers = [s.SloTracker(objective_s=2.0, target=0.9, window_s=300.0, clock=lambda: 100.0) for _ in range(3)]
        for i in range(200):
            lat, ok, t = rng.uniform(0.1, 4.0), rng.random() < 0.9, rng.uniform(0.0, 100.0)
            workers[i % 3].observe(lat, ok=ok, now=t)
            oracle.observe(lat, ok=ok, now=t)
        return s.merge_window_states([w.window_state(now=100.0) for w in workers]), oracle.snapshot(now=100.0)

    merged, want = both(run)
    assert merged["n"] == want["n"] == 200 and merged["good"] == want["good"]
    assert abs(merged["attainment"] - want["attainment"]) < 1e-9
    assert (merged["p50_s"], merged["p95_s"], merged["max_s"]) == (want["p50_s"], want["p95_s"], want["max_s"])
    assert abs(merged["burn_slow"] - want["burn_rate"]) < 1e-6


def test_merged_is_not_an_average_of_snapshots():
    def run(_o, _a, _m, s):
        idle = s.SloTracker(objective_s=1.0, clock=lambda: 0.0)
        busy = s.SloTracker(objective_s=1.0, clock=lambda: 0.0)
        for _ in range(10):
            busy.observe(5.0, ok=True, now=0.0)
        return s.merge_window_states([idle.window_state(now=0.0), busy.window_state(now=0.0)])

    merged = both(run)
    assert merged["attainment"] == 0.0 and merged["workers"] == 2 and merged["n"] == 10


def test_window_state_cap_keeps_true_n():
    def run(_o, _a, _m, s):
        t = s.SloTracker(objective_s=0.0, clock=lambda: 50.0)
        for i in range(100):
            t.observe(0.1, ok=True, now=float(i % 50))
        st = t.window_state(max_samples=30, now=50.0)
        return st, s.merge_window_states([st])

    st, merged = both(run)
    assert st["n"] == 100 and len(st["samples"]) == 30 and st["dropped"] == 70
    assert merged["n"] == 100 and merged["n_merged"] == 30


def test_fast_slow_burn_split():
    def run(_o, _a, _m, s):
        t = s.SloTracker(objective_s=1.0, target=0.95, window_s=300.0, clock=lambda: 200.0)
        for i in range(90):
            t.observe(0.2, ok=True, now=float(i))
        for i in range(10):
            t.observe(5.0, ok=True, now=195.0 + i / 10)
        return s.merge_window_states([t.window_state(now=200.0)], fast_window_s=60.0)

    merged = both(run)
    assert merged["n_fast"] == 10
    assert merged["burn_fast"] == pytest.approx(1.0 / 0.05)
    assert merged["burn_slow"] == pytest.approx((10 / 100) / 0.05)


# -------------------------------------------------------- the alert engine


def engines():
    """{side: (engine, registry, log)} at the reference test's thresholds."""
    out = {}
    for side, (_o, a, m, _s) in SIDES.items():
        rules = (a.fleet_rules(load_config(environ=ALERT_ENV)) if side == "reference" else
                 a.fleet_rules(burn_rate=2.0, restarts=3, for_s=5.0, clear_s=10.0, hb_gap_s=15.0))
        reg, log = m.Registry(), []
        out[side] = (a.AlertEngine(rules, registry=reg, log=log.append), reg, log)
    return out


def drive(eng, ticks):
    """Each (signals, now) tick through both engines: the same transitions
    a tick, the same active() and state() after each.  Returns the port's
    transitions a tick."""
    got = []
    for signals, now in ticks:
        trs = {side: e.evaluate(signals, now=now) for side, (e, _, _) in eng.items()}
        assert trs["port"] == trs["reference"], (signals, now)
        for view in ("active", "state"):
            assert getattr(eng["port"][0], view)() == getattr(eng["reference"][0], view)()
        got.append(trs["port"])
    return got


def fired(eng, rule):
    counts = {side: next((m["value"] for m in reg.snapshot() if m["name"] == "zkp2p_fleet_alerts_total"
                          and m["labels"].get("rule") == rule), 0) for side, (_, reg, _) in eng.items()}
    assert counts["port"] == counts["reference"]
    return counts["port"]


ON = {"burn_fast": 5.0, "burn_slow": 5.0, "slo_n": 100}
OFF = {"burn_fast": 0.0, "burn_slow": 0.0, "slo_n": 100}


def test_alert_fires_after_for_s_not_before():
    eng = engines()
    trs = drive(eng, [(ON, 0.0), (ON, 4.0), (ON, 5.0)])
    assert trs[:2] == [[], []] and [t["event"] for t in trs[2]] == ["fired"] and trs[2][0]["rule"] == "slo_burn"
    assert [a["rule"] for a in eng["port"][0].active()] == ["slo_burn"] and fired(eng, "slo_burn") == 1
    assert any("FIRED" in m for m in eng["port"][2]) and eng["port"][2] == eng["reference"][2]


def test_alert_hysteresis_flapping_raises_one_alert():
    eng = engines()
    drive(eng, [(ON, 0.0), (ON, 5.0)])
    trs = drive(eng, [(ON if i % 2 else OFF, 6.0 + i) for i in range(20)])
    assert all(t == [] for t in trs) and fired(eng, "slo_burn") == 1 and eng["port"][0].active()


def test_alert_clears_only_after_clear_s_clean():
    eng = engines()
    trs = drive(eng, [(ON, 0.0), (ON, 5.0), (OFF, 6.0), (OFF, 16.0), (ON, 20.0), (ON, 25.0)])
    assert trs[2] == [] and [t["event"] for t in trs[3]] == ["cleared"]
    assert fired(eng, "slo_burn") == 2 and eng["port"][0].state()["slo_burn"]["fired_count"] == 2
    assert eng["port"][2] == eng["reference"][2]


def test_missing_signal_holds_state():
    eng = engines()
    drive(eng, [(ON, 0.0), (ON, 5.0)])
    assert all(t == [] for t in drive(eng, [({}, 6.0 + i) for i in range(50)]))
    assert eng["port"][0].active() and fired(eng, "slo_burn") == 1


def test_empty_slo_window_never_burns():
    eng = engines()
    drive(eng, [({"burn_fast": 20.0, "burn_slow": 20.0, "slo_n": 0}, float(t)) for t in range(20)])
    assert eng["port"][0].active() == []


def test_restart_storm_fires_immediately_on_park():
    eng = engines()
    assert [t["rule"] for t in drive(eng, [({"parked": 1, "restarts_recent": 0}, 0.0)])[0]] == ["restart_storm"]
    assert fired(eng, "restart_storm") == 1
    eng2 = engines()
    trs = drive(eng2, [({"parked": 0, "restarts_recent": 2}, 0.0), ({"parked": 0, "restarts_recent": 3}, 1.0)])
    assert trs[0] == [] and [t["rule"] for t in trs[1]] == ["restart_storm"]


def test_heartbeat_gap_and_governor_rules():
    assert [t["rule"] for t in drive(engines(), [({"hb_gap_s": 20.0}, 0.0)])[0]] == ["heartbeat_gap"]
    trs = drive(engines(), [({"degraded": 1}, 0.0), ({"degraded": 1}, 5.0)])
    assert trs[0] == [] and [t["rule"] for t in trs[1]] == ["governor_degrade"]


def test_perf_regression_holds_without_budgets():
    """No worker of the port reports stage budgets: the signal stays None
    and the rule holds ok, as the reference's does on an empty ledger."""
    trs = drive(engines(), [({"budget_overruns": None, "overruns_recent": None}, float(t)) for t in range(20)]
                + [({"budget_overruns": 4, "overruns_recent": 2}, 20.0 + t) for t in range(6)])
    assert [t["rule"] for t in trs[-1]] == ["perf_regression"] and all(t == [] for t in trs[:-1])


def test_trend_tracker_growth_and_delta():
    def run(_o, a, _m, _s):
        out = []
        tr = a.TrendTracker(keep_s=100.0)
        out.append(tr.growing(10.0, now=0.0))
        tr.update(0.0, 2.0)
        out.append(tr.growing(10.0, now=0.0))
        for t in range(1, 12):
            tr.update(float(t), 2.0 + t)
        out += [tr.growing(10.0, now=11.0), tr.delta(10.0, now=11.0), tr.delta(100.0, now=11.0)]
        flat = a.TrendTracker(keep_s=100.0)
        for t in range(12):
            flat.update(float(t), 5.0)
        empty = a.TrendTracker(keep_s=100.0)
        out.append(empty.delta(10.0, now=0.0))
        empty.update(0.0, 0.0)
        out += [flat.growing(10.0, now=11.0), empty.growing(10.0, now=0.0)]
        return out

    assert both(run) == [None, None, True, pytest.approx(10.0), pytest.approx(11.0), None, False, False]


# ----------------------------------------------- the plane's fail-closed /status


class FakeProc:
    def __init__(self, alive=True):
        self._alive = alive
        self.pid = 4242

    def poll(self):
        return None if self._alive else 1


class FakeSlot:
    def __init__(self, wid, state="up", alive=True, restarts=0):
        self.wid = wid
        self.state = state
        self.proc = FakeProc(alive) if state != "parked" else None
        self.restarts = restarts
        self.last_rc = None


class FakeSup:
    def __init__(self, spool, slots, hbs=None):
        self.spool = spool
        self.slots = {s.wid: s for s in slots}
        self.hbs = hbs or {}
        self.log = lambda m: None

    def _hb(self, slot):
        return self.hbs.get(slot.wid)

    def _hb_age_s(self, slot):
        return 0.1 if self.hbs.get(slot.wid) else None

    def status(self):
        return {"type": "fleet_status", "fleet_id": "ftest", "workers": {}, "draining": False}


def scrape_both(sup, snapshots):
    """One scrape_once of each side's plane over `sup` with `snapshots`
    (port -> /snapshot body) for the workers' answers: (view, /status
    body) of each, the fields that depend on no registry or clock."""
    out = {}
    for side, (obs, *_rest) in SIDES.items():
        plane = obs.FleetPlane(sup, port=0, scrape_s=0.5, clock=time.time)
        plane._fetch_snapshot = lambda port: snapshots.get(port)
        view = plane.scrape_once()
        body = plane.status_payload()
        body["scrape"] = {k: v for k, v in body["scrape"].items() if k not in ("last_ts", "last_ms")}
        out[side] = ({k: view[k] for k in ("ready", "reason", "slo", "signals", "workers_scraped")}, body)
    assert out["port"] == out["reference"]
    return out["port"]


def test_status_fails_closed_until_every_live_worker_armed(tmp_path):
    spool = tmp_path / "spool"
    spool.mkdir()
    sup = FakeSup(str(spool), [FakeSlot("w0"), FakeSlot("w1")], {"w0": {"port": 1001}, "w1": {"port": 1002}})
    armed = {"armed": True, "metrics": [], "slo_window": None}
    unarmed = {"armed": False, "metrics": [], "slo_window": None}

    view, body = scrape_both(sup, {1001: armed})
    assert view["ready"] is False and "unreachable" in view["reason"] and body["ok"] is False and body["reason"]
    view, _ = scrape_both(sup, {1001: armed, 1002: unarmed})
    assert view["ready"] is False and "armed" in view["reason"]
    view, body = scrape_both(sup, {1001: armed, 1002: armed})
    assert view["ready"] is True and body["ok"] is True
    dead = FakeSup(str(spool), [FakeSlot("w0", state="done", alive=False)])
    view, _ = scrape_both(dead, {})
    assert view["ready"] is False and view["reason"] == "no live workers"


def test_scrape_merges_heartbeat_slo_fallback(tmp_path):
    """A worker whose scrape fails still adds its heartbeat's window."""
    spool = tmp_path / "spool"
    spool.mkdir()
    t = slo.SloTracker(objective_s=1.0, clock=lambda: 10.0)
    for _ in range(4):
        t.observe(0.5, ok=True, now=9.0)
    sup = FakeSup(str(spool), [FakeSlot("w0")], {"w0": {"port": 1001, "slo_window": t.window_state()}})
    view, _ = scrape_both(sup, {})
    assert view["ready"] is False and view["slo"]["n"] == 4


def test_scrape_merges_the_workers_snapshots(tmp_path):
    """Two armed workers' snapshots: the same merged families on both
    sides (the supervisor's own zkp2p_fleet_* instruments aside), the
    request counters the workers' sum."""
    spool = tmp_path / "spool"
    spool.mkdir()
    (spool / "q0.req.json").write_text("{}")
    sup = FakeSup(str(spool), [FakeSlot("w0"), FakeSlot("w1", restarts=1)], {"w0": {"port": 1}, "w1": {"port": 2}})
    workers = {}
    for port, (done, fills) in ((1, (3, [1, 2])), (2, (5, [2, 8]))):
        tr = slo.SloTracker(objective_s=1.0, clock=lambda: 5.0)
        for _ in range(done):
            tr.observe(0.5, ok=True, now=4.0)
        workers[port] = {"armed": True, "metrics": worker_registry(metrics, done, port, fills).snapshot(),
                         "slo_window": tr.window_state(), "pid": port}
    got = {}
    for side, (obs, *_rest) in SIDES.items():
        plane = obs.FleetPlane(sup, port=0, scrape_s=0.5, clock=lambda: 100.0)
        plane._fetch_snapshot = lambda port: workers.get(port)
        view = plane.scrape_once()
        got[side] = {k: v for k, v in keyed(view["registry"]).items() if not k[0].startswith("zkp2p_fleet_")}
        got[side]["view"] = {k: view[k] for k in ("ready", "slo", "signals", "workers_scraped")}
    assert got["port"] == got["reference"]
    assert got["port"][("zkp2p_service_requests_total", "counter", (("state", "done"),))]["value"] == 8
    assert got["port"]["view"]["slo"]["n"] == 8 and got["port"]["view"]["signals"]["backlog"] == 1


# ------------------------------------------------------------------- top


TOP_BODIES = [
    {"ok": True, "fleet_id": "f1", "draining": False,
     "slo": {"attainment": 0.97, "burn_fast": 0.5, "burn_slow": 0.2, "p95_s": 1.25, "objective_p95_s": 2.0,
             "n": 42, "workers": 2},
     "signals": {"backlog": 3, "restarts_recent": 0, "parked": 0, "degraded": 0},
     "alerts": [{"rule": "slo_burn", "detail": "burning", "since": 1.0}],
     "workers": {"w0": {"state": "up", "pid": 1, "port": 1001, "restarts": 0, "rss_mb": 100.0, "hb_age_s": 0.2,
                        "degraded": False}},
     "scrape": {"cycles": 9, "interval_s": 2.0, "last_ts": 123.0}},
    {"ok": False, "reason": "no live workers"},
    {"ok": False, "reason": "1/2 live worker(s) unreachable (no armed snapshot)", "fleet_id": "f2", "draining": True,
     "slo": {"attainment": 1.0, "burn_fast": 0.0, "burn_slow": 0.0, "p95_s": 0.0, "objective_p95_s": 0.0, "n": 0,
             "workers": 0},
     "sched": {"autoscale": True, "workers_live": 2, "workers_min": 1, "workers_max": 4, "scale_events": 1,
               "last_scale": {"direction": "up", "reason": "backlog", "workers": 2, "ts": 5.0}},
     "workers": {"w1": {"state": "backoff", "restarts": 2, "degraded": True,
                        "sched": {"mode": "adaptive", "batch_target": 4, "lane_interactive": 1},
                        "perf": {"budgets": 3, "overruns": 1, "capture": {"file": "w1.folded"}}},
                 "w0": {"state": "parked", "pid": None, "sched": {"mode": "off", "batch_target": 2}}}},
]


@pytest.mark.parametrize("body", range(len(TOP_BODIES)))
def test_render_top_frame(body):
    frame = both(lambda obs, *_: obs.render_top(TOP_BODIES[body]))
    if body == 0:
        assert "READY" in frame and "attainment 0.9700" in frame and "ALERT slo_burn" in frame
        assert "w0" in frame and "9 cycle(s)" in frame
    elif body == 1:
        assert "NOT READY" in frame
    else:
        assert "DRAINING" in frame and "autoscale:" in frame and "flame" in frame
