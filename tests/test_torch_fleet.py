"""The port's fleet supervisor (zkp2p_tpu_torch.pipeline.fleet) against
the reference's (zkp2p_tpu.pipeline.fleet), scenario by scenario: the
supervisor scenarios of tests/test_fleet.py, each run through both
supervisors with the same toy `python -c` workers, compared on the exit
code, the slots' states, restarts, escalations and watchdog kills, and
the keys of status.json.  The reference names its workers through the
environment, the port through the flags it appends to their argv; the
watchdog's toy worker reads its identity from either.  Also the worker
side: the soft degrade and the heartbeat's fields."""

import json
import os
import signal
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from zkp2p_tpu.pipeline import fleet as ref_fleet
from zkp2p_tpu_torch.pipeline import fleet as port_fleet
from zkp2p_tpu_torch.pipeline.service import ProvingService
from zkp2p_tpu_torch.utils import audit
from zkp2p_tpu_torch.utils.metrics import REGISTRY

SLEEPER = [sys.executable, "-c", "import time; time.sleep(60)"]
CRASHER = [sys.executable, "-c", "import sys; sys.exit(1)"]
DEAF = [sys.executable, "-c", "import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); time.sleep(60)"]
# one heartbeat, then silence: hung
HUNG = [sys.executable, "-c", (
    "import json, os, sys, time\n"
    "a = sys.argv[1:]\n"
    "d = a[a.index('--fleet-dir') + 1] if '--fleet-dir' in a else os.environ['ZKP2P_FLEET_DIR']\n"
    "w = a[a.index('--worker-id') + 1] if '--worker-id' in a else os.environ['ZKP2P_WORKER_ID']\n"
    "json.dump({'pid': os.getpid(), 'ts': time.time()}, open(os.path.join(d, w + '.hb'), 'w'))\n"
    "time.sleep(120)\n")]
SIDES = {"reference": ref_fleet, "port": port_fleet}


@pytest.fixture(autouse=True)
def _no_fleet_env(monkeypatch):
    for var in ("ZKP2P_WORKER_ID", "ZKP2P_FLEET_ID", "ZKP2P_FLEET_DIR", "ZKP2P_METRICS_PORT", "ZKP2P_FLEET_WORKERS",
                "ZKP2P_DRAIN_TIMEOUT_S", "ZKP2P_RSS_SOFT_MB", "ZKP2P_RSS_HARD_MB", "ZKP2P_BREAKER_K",
                "ZKP2P_BREAKER_WINDOW_S", "ZKP2P_RESTART_BACKOFF_S", "ZKP2P_FLEET_METRICS_PORT",
                "ZKP2P_WORKERS_MAX"):
        monkeypatch.delenv(var, raising=False)


def supervisor(side, spool, cmd, **kw):
    kw.setdefault("log", lambda m: None)
    return SIDES[side].FleetSupervisor(str(spool), lambda wid: list(cmd), **kw)


def outcome(sup, rc):
    with open(os.path.join(sup.fleet_dir, "status.json")) as f:
        status = json.load(f)
    return {"rc": rc, "states": {w: s.state for w, s in sup.slots.items()},
            "restarts": {w: s.restarts for w, s in sup.slots.items()}, "escalations": sup.escalations,
            "watchdog_kills": sup.watchdog_kills, "status_keys": sorted(status),
            "worker_keys": sorted(k for w in status["workers"].values() for k in w)}


def both(tmp_path, scenario):
    got = {side: scenario(side, tmp_path / side) for side in SIDES}
    assert got["port"] == got["reference"]
    return got["port"]


def test_breaker_parks_a_crash_looping_worker(tmp_path):
    def scenario(side, d):
        sup = supervisor(side, d, CRASHER, workers=1, breaker_k=2, breaker_window_s=30.0, restart_backoff_s=0.05)
        return outcome(sup, sup.run(poll_s=0.05, max_seconds=15, install_signals=False))

    out = both(tmp_path, scenario)
    # K=2: the first crash restarts, the second parks; every worker parked: 4
    assert out["rc"] == 4 and out["states"] == {"w0": "parked"} and out["restarts"] == {"w0": 1}


def test_drain_escalates_to_sigkill(tmp_path):
    def scenario(side, d):
        sup = supervisor(side, d, DEAF, workers=1, drain_timeout_s=1.0)
        threading.Timer(0.8, sup.stop).start()
        return outcome(sup, sup.run(poll_s=0.05, max_seconds=30, install_signals=False))

    out = both(tmp_path, scenario)
    assert out["rc"] == 3 and out["escalations"] == 1 and out["states"] == {"w0": "done"}


def test_sigkilled_worker_restarts_with_backoff(tmp_path):
    def scenario(side, d):
        sup = supervisor(side, d, SLEEPER, workers=1, restart_backoff_s=0.05, breaker_k=5)
        out = {}
        t = threading.Thread(target=lambda: out.update(rc=sup.run(poll_s=0.05, max_seconds=60,
                                                                  install_signals=False)))
        t.start()
        deadline = time.time() + 20
        while time.time() < deadline and sup.slots["w0"].proc is None:
            time.sleep(0.02)
        first = sup.slots["w0"].proc.pid
        os.kill(first, signal.SIGKILL)
        while time.time() < deadline and (sup.slots["w0"].proc.pid == first or sup.slots["w0"].state != "up"):
            time.sleep(0.02)
        sup.stop()
        t.join(timeout=30)
        assert not t.is_alive()
        return outcome(sup, out["rc"])

    out = both(tmp_path, scenario)
    # the replacement dies on the drain's SIGTERM: in a drain any exit is final
    assert out["rc"] == 0 and out["restarts"] == {"w0": 1} and out["states"] == {"w0": "done"}


def test_governor_soft_then_hard(tmp_path):
    """A 1 MiB soft budget (any Python process is over it) writes the
    degrade ctl; a 1 MiB hard budget drains and restarts the worker with
    no count toward the breaker."""

    def scenario(side, d):
        sup = supervisor(side, d, SLEEPER, workers=1, rss_soft_mb=1, rss_hard_mb=0)
        sup.start()
        ctl = os.path.join(sup.fleet_dir, "w0.ctl")
        deadline = time.time() + 15
        while time.time() < deadline and not os.path.exists(ctl):
            sup.tick()
            time.sleep(0.05)
        with open(ctl) as f:
            degrade = json.load(f)["degrade"]
        soft = (degrade, sup.drain(timeout_s=10), outcome(sup, None))
        sup2 = supervisor(side, d / "h", SLEEPER, workers=1, rss_soft_mb=0, rss_hard_mb=1, drain_timeout_s=5.0,
                          restart_backoff_s=0.05)
        sup2.start()
        deadline = time.time() + 20
        while time.time() < deadline and sup2.slots["w0"].restarts < 1:
            sup2.tick()
            time.sleep(0.05)
        slot = sup2.slots["w0"]
        hard = (slot.restarts >= 1, slot.failures, slot.state)
        sup2.drain(timeout_s=10)
        return soft, hard, outcome(sup2, None)

    soft, hard, _ = both(tmp_path, scenario)
    assert soft[:2] == (1, True)
    assert hard == (True, [], "up")


def test_watchdog_kills_a_hung_worker_after_its_first_heartbeat(tmp_path):
    def scenario(side, d):
        sup = supervisor(side, d, HUNG, workers=1, liveness_s=2.0, breaker_k=1, restart_backoff_s=0.05)
        return outcome(sup, sup.run(poll_s=0.1, max_seconds=30, install_signals=False))

    out = both(tmp_path, scenario)
    assert out["watchdog_kills"] == 1 and out["rc"] == 4 and out["states"] == {"w0": "parked"}


def test_supervisor_appends_the_identity_flags(tmp_path):
    sup = supervisor("port", tmp_path, ["prog", "--x"], workers=1, fleet_id="f1")
    assert sup._argv("w0") == ["prog", "--x", "--worker-id", "w0", "--fleet-id", "f1", "--fleet-dir",
                               os.path.join(str(tmp_path), ".fleet"), "--metrics-port", "0"]
    assert audit.gate_arms()["service_fleet"] == "supervisor:1" and audit.gate_arms()["fleet_governor"] == "off"


def test_worker_side_soft_degrade(tmp_path):
    """A degrade ctl halves the batch once, counts it and records the
    fleet_governor arm; the heartbeat says degraded."""
    svc = ProvingService(None, None, None, None, None, batch_size=4, device="cpu", worker_id="w9",
                         fleet_id="ftest")
    d = str(tmp_path)
    port_fleet.worker_tick(svc, d)
    with open(os.path.join(d, "w9.hb")) as f:
        hb = json.load(f)
    assert (hb["worker"], hb["fleet"], hb["state"], hb["degraded"], hb["pid"]) == ("w9", "ftest", "up", False,
                                                                                    os.getpid())
    applied = REGISTRY.counter("zkp2p_fleet_degrade_applied_total").value
    with open(os.path.join(d, "w9.ctl"), "w") as f:
        json.dump({"degrade": 1}, f)
    port_fleet.worker_tick(svc, d)
    assert svc.batch_size == 2 and audit.gate_arms()["fleet_governor"] == "soft-applied"
    port_fleet.worker_tick(svc, d)  # once only
    assert svc.batch_size == 2
    assert REGISTRY.counter("zkp2p_fleet_degrade_applied_total").value == applied + 1
    with open(os.path.join(d, "w9.hb")) as f:
        assert json.load(f)["degraded"] is True
    port_fleet.worker_tick(svc, d, state="drained")
    with open(os.path.join(d, "w9.hb")) as f:
        assert json.load(f)["state"] == "drained"


def test_heartbeat_has_the_reference_fields(tmp_path):
    """The reference's heartbeat fields less perf (the perf sentry is not
    ported), the SLO window's fields equal, the advertised tier equal."""
    stub = SimpleNamespace(draining=False, _worker_id="w4", _fleet_id="f4", _fleet_degraded=False)
    hbs = {}
    for side, mod in SIDES.items():
        d = str(tmp_path / side)
        mod._write_heartbeat(stub, d)
        with open(os.path.join(d, "w4.hb")) as f:
            hbs[side] = json.load(f)
    assert set(hbs["port"]) == set(hbs["reference"]) - {"perf"}
    assert set(hbs["port"]["slo_window"]) == set(hbs["reference"]["slo_window"])
    for k in ("pid", "worker", "fleet", "state", "degraded", "tier"):
        assert hbs["port"][k] == hbs["reference"][k]
