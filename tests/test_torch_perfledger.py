"""The port's perf sentry (zkp2p_tpu_torch.utils.perfledger, the service's
budget checks, the heartbeat's perf block and the `perf` command) against
the reference's utils/perfledger.py and its `perf` command, on the CPU.

Entries are made from a seed with numpy, with the fingerprint key
monkeypatched equal on both sides; the reference takes its window and
tolerance from ZKP2P_PERF_WINDOW / ZKP2P_PERF_TOLERANCE, the port from
keywords.  Held equal, exactly: the signed entry, the refused counts of
torn, tampered, foreign and schema-drifted lines, stage_stats,
derive_budgets under several windows and tolerances, BudgetBook.over,
the baseline document, every gate verdict and rc, and the `perf`
command's --json, --rebaseline and --gate output and exit code.

Then the seeded regression on the CPU: the port's ProvingService
(device="cpu") on the 2-constraint circuit with the reference's host
prover, budgets from a seeded ledger: a clean sweep counts no overrun, a
`prove:hang` sweep counts one a request, in the counter and in the
heartbeat's perf block, and two such workers' heartbeat files make the
fleet plane's perf_regression rule fire and then clear.  The port's key
under device="cpu" differs from a card's, and each refuses the other's
lines."""

import contextlib
import io
import json
import os
import types

import numpy as np
import pytest

from zkp2p_tpu.pipeline import cli as ref_cli
from zkp2p_tpu.utils import hostprof as ref_hostprof
from zkp2p_tpu.utils import perfledger as ref_pl

from test_torch_service import Side, build_cs, RefCS, RefLC, ref_setup, write_reqs
from zkp2p_tpu_torch.pipeline import cli
from zkp2p_tpu_torch.pipeline.fleet import FleetSupervisor, _write_heartbeat
from zkp2p_tpu_torch.pipeline.fleet_obs import FleetPlane, render_top
from zkp2p_tpu_torch.utils import faults, hostprof
from zkp2p_tpu_torch.utils import slo as port_slo
from zkp2p_tpu_torch.utils import perfledger as pl
from zkp2p_tpu_torch.utils.metrics import REGISTRY

KEY = "5eed5eed5eed5eed"
NOW = 1754000000.25
STAGES = ("prove", "verify", "witness")


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    for var in ("ZKP2P_PERF_LEDGER", "ZKP2P_PERF_TOLERANCE", "ZKP2P_PERF_WINDOW", "ZKP2P_FAULTS",
                "ZKP2P_MSM_PRECOMP_CACHE"):
        monkeypatch.delenv(var, raising=False)
    ref_pl.reset()
    pl.reset()
    faults.reset()
    yield
    ref_pl.reset()
    pl.reset()
    faults.reset()


@pytest.fixture
def same_key(monkeypatch):
    """One fingerprint key and one clock on both sides."""
    monkeypatch.setattr(ref_hostprof, "fingerprint_key", lambda fp=None: KEY)
    monkeypatch.setattr(hostprof, "fingerprint_key", lambda fp=None, device=None: KEY)
    clock = types.SimpleNamespace(time=lambda: NOW)
    monkeypatch.setattr(ref_pl, "time", clock)
    monkeypatch.setattr(pl, "time", clock)


def seeded_entries(seed=20, n=14):
    """n signed entries (the reference's make_entry) over two circuits,
    two execution digests and three stages, p50s drawn from numpy."""
    g = np.random.default_rng(seed)
    out = []
    for i in range(n):
        stages = {}
        for st in STAGES:
            if g.random() < 0.8:
                p50 = float(np.round(g.uniform(5.0, 500.0), 3))
                stages[st] = {"p50_ms": p50, "p95_ms": round(p50 * 1.2, 3), "n": int(g.integers(1, 9))}
        stages = stages or {"prove": {"p50_ms": 100.0, "p95_ms": 120.0, "n": 1}}
        out.append(ref_pl.make_entry("service", ("toy", "venmo")[int(g.integers(0, 2))], stages,
                                     run_id=f"run{i}", execution_digest=("d1", "d2")[int(g.random() < 0.25)]))
    return out


def write_ledger(path, entries):
    for e in entries:
        assert ref_pl.append_entry(e, path=path) == path
    return path


def ref_settings(monkeypatch, window, tolerance):
    monkeypatch.setenv("ZKP2P_PERF_WINDOW", str(window))
    monkeypatch.setenv("ZKP2P_PERF_TOLERANCE", str(tolerance))


# ------------------------------------------------------------ the entry


def test_make_entry_equals_the_reference(same_key):
    stages = {"prove": {"p50_ms": 12.34567, "p95_ms": 20.0, "n": 3}, "verify": {"p50_ms": 1.5}}
    for kw in ({}, {"run_id": "r1"}):
        ref = ref_pl.make_entry("service", "toy", stages, execution_digest="abcd", **kw)
        port = pl.make_entry("service", "toy", stages, execution_digest="abcd", device="cpu", **kw)
        assert port == ref and port["entry_digest"] == ref_pl._entry_digest(port)


def test_refused_counts_equal_the_reference(tmp_path, same_key):
    entries = seeded_entries()
    path = write_ledger(str(tmp_path / "ledger.jsonl"), entries[:4])
    tampered = dict(entries[4], stages={"prove": {"p50_ms": 1.0, "p95_ms": 1.0, "n": 1}})
    foreign = dict(entries[5], fingerprint_key="0" * 16)
    foreign["entry_digest"] = ref_pl._entry_digest(foreign)
    drifted = dict(entries[6], schema=ref_pl.SCHEMA_VERSION + 1)
    drifted["entry_digest"] = ref_pl._entry_digest(drifted)
    with open(path, "a") as f:
        f.write('{"schema": 1, "trunc\n')  # torn
        f.write("[1, 2]\n")  # not an entry
        f.write('{"schema": 1, "stages": 3}\n')
        for e in (tampered, foreign, drifted):
            f.write(json.dumps(e) + "\n")
        f.write("\n")
    write_ledger(path, entries[7:9])
    ref = ref_pl.load_entries(path)
    port = pl.load_entries(path, device="cpu")
    assert port == ref
    assert port[1] == {"unparseable": 3, "schema": 1, "foreign": 1, "tampered": 1} and len(port[0]) == 6
    assert pl.load_entries(str(tmp_path / "none.jsonl"), device="cpu") == ref_pl.load_entries(
        str(tmp_path / "none.jsonl"))
    assert pl.load_entries(None, device="cpu") == ([], dict.fromkeys(("unparseable", "schema", "foreign",
                                                                      "tampered"), 0))


# ------------------------------------------------ statistics and budgets


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 20, 101])
def test_stage_stats_equal_the_reference(n):
    vals = list(np.random.default_rng(n).uniform(0.1, 900.0, size=n)) + [None]
    assert pl.stage_stats(vals) == ref_pl.stage_stats(vals)


@pytest.mark.parametrize("window,tolerance", [(1, 1.0), (2, 1.5), (3, 1.25), (8, 1.5), (50, 2.0)])
def test_budgets_equal_the_reference(window, tolerance, tmp_path, same_key, monkeypatch):
    entries = seeded_entries(seed=window)
    ref_settings(monkeypatch, window, tolerance)
    ref = ref_pl.derive_budgets(entries)
    assert pl.derive_budgets(entries, window=window, tolerance=tolerance) == ref and ref
    path = write_ledger(str(tmp_path / "ledger.jsonl"), entries)
    for circuit in ("toy", "venmo", "none"):
        rbook = ref_pl.BudgetBook.load(circuit, path=path)
        book = pl.BudgetBook.load(circuit, path, window=window, tolerance=tolerance, device="cpu")
        assert len(book) == len(rbook)
        for stage in STAGES + ("emit",):
            b = rbook.budget_ms(stage)
            assert book.budget_ms(stage) == b and book.head_digest(stage) == rbook.head_digest(stage)
            probes = [None, 0.0] + ([b - 0.001, b, b + 0.001, 10 * b] if b is not None else [5.0])
            assert [book.over(stage, ms) for ms in probes] == [rbook.over(stage, ms) for ms in probes]


def test_ledger_off_and_no_cache_dir_give_empty_books(tmp_path, same_key, monkeypatch):
    path = write_ledger(str(tmp_path / "ledger.jsonl"), seeded_entries())
    monkeypatch.setenv("ZKP2P_PERF_LEDGER", "0")
    assert len(ref_pl.BudgetBook.load("toy", path=path)) == 0
    assert len(pl.BudgetBook.load("toy", path, perf_ledger=False, device="cpu")) == 0
    assert len(pl.BudgetBook.load("toy", None, device="cpu")) == 0
    assert pl.ledger_path(None, "cpu") is None and pl.append_entry(seeded_entries()[0], None) is None
    assert pl.record("service", "toy", {"prove": {"p50_ms": 1.0}}, perf_ledger=False,
                     cache_dir=str(tmp_path), device="cpu") is None
    assert not os.path.exists(pl.ledger_path(str(tmp_path), "cpu"))


# ------------------------------------------------ the baseline and the gate


def gate_both(base_ref, base_port, ledger):
    return (ref_pl.gate_check(baseline_path=base_ref, ledger_path=ledger),
            pl.gate_check(base_port, ledger, device="cpu"))


def test_baseline_and_gate_verdicts_equal_the_reference(tmp_path, same_key, monkeypatch):
    ledger = str(tmp_path / "ledger.jsonl")
    base_r, base_p = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    ref_settings(monkeypatch, 8, 1.5)
    # no ledger yet: both fail closed, no band written
    assert ref_pl.write_baseline(baseline_path=base_r, ledger_path=ledger) is None
    assert pl.write_baseline(base_p, ledger, device="cpu") is None and not os.path.exists(base_p)
    write_ledger(ledger, seeded_entries()[:6])
    doc_r = ref_pl.write_baseline(baseline_path=base_r, ledger_path=ledger)
    doc_p = pl.write_baseline(base_p, ledger, device="cpu")
    assert doc_p == doc_r
    with open(base_r) as f, open(base_p) as g:
        assert f.read() == g.read()
    steps = [
        {"prove": 100.0},  # ok or IMPROVED against the band
        {"prove": 4000.0, "verify": 1.0},  # DRIFT, IMPROVED
        {"emit": 3.0},  # new
    ]
    for i, st in enumerate(steps):
        for circuit in ("toy", "venmo"):
            ref_pl.append_entry(ref_pl.make_entry(
                "bench", circuit, {k: {"p50_ms": v, "p95_ms": v, "n": 1} for k, v in st.items()},
                execution_digest="d1"), path=ledger)
        (rrc, rv), (prc, pv) = gate_both(base_r, base_p, ledger)
        assert (prc, pv) == (rrc, rv), i
    assert rrc == 1 and {v["verdict"] for v in rv} >= {"DRIFT", "IMPROVED", "new"}
    # a band with a stage the ledger lacks: gone
    with open(base_p) as f:
        band = json.load(f)
    band["bands"]["toy"]["gone_stage"] = {"budget_ms": 1.0, "median_ms": 1.0}
    for b in (base_r, base_p):
        with open(b, "w") as f:
            json.dump(band, f)
    (rrc, rv), (prc, pv) = gate_both(base_r, base_p, ledger)
    assert (prc, pv) == (rrc, rv) and any(v["verdict"] == "gone" for v in pv)
    # fail closed: no baseline, schema drift, no valid entry
    drift = str(tmp_path / "drift.json")
    with open(drift, "w") as f:
        json.dump({"schema": 999}, f)
    for b, led in ((str(tmp_path / "nope.json"), ledger), (drift, ledger), (base_p, str(tmp_path / "empty"))):
        assert pl.gate_check(b, led, device="cpu") == ref_pl.gate_check(baseline_path=b, ledger_path=led)
        assert pl.gate_check(b, led, device="cpu")[0] == 2
    # a band frozen on other hardware: warned about, still compared
    band["fingerprint_key"] = "f" * 16
    with open(base_p, "w") as f:
        json.dump(band, f)
    said = []
    rc, rows = pl.gate_check(base_p, ledger, log=said.append, device="cpu")
    assert rows and any("different hardware" in m for m in said)


# ------------------------------------------------------- the perf command


def run_cli(main, argv):
    buf, rc = io.StringIO(), 0
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            rc = e.code or 0
    return rc, buf.getvalue().replace("zkp2p-tpu-torch perf", "zkp2p-tpu perf")


def test_perf_command_equals_the_reference(tmp_path, same_key, monkeypatch):
    """--json, --rebaseline then --gate (ok, then DRIFT naming the newest
    capture of its stage beside the ledger), the trendlines, and the
    empty ledger's rc 1, against the reference's `perf` on the same
    files (its captures found in its cache dir, the same directory)."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("ZKP2P_MSM_PRECOMP_CACHE", str(cache))
    ref_settings(monkeypatch, 3, 1.25)
    ledger = write_ledger(str(cache / "ledger.jsonl"), seeded_entries()[:8])
    for ts, trigger in ((1754000001, "overrun"), (1754000002, "manual")):
        with open(cache / f"flame_toy_prove_{ts}.json", "w") as f:
            json.dump({"kind": "zkp2p_flame_capture", "schema": 1, "circuit": "toy", "stage": "prove",
                       "trigger": trigger, "ts": ts, "entry_digest": f"e{ts}", "stacks": {"a;b": 2}}, f)

    def both(*args, ref_extra=(), port_extra=("--window", "3", "--tolerance", "1.25")):
        ref = run_cli(ref_cli.main, ["perf", "--ledger", ledger, *args, *ref_extra])
        port = run_cli(cli.main, ["perf", "--device", "cpu", "--ledger", ledger, *args, *port_extra])
        assert port == ref, args
        return port

    rc, out = both("--json")
    assert rc == 0 and json.loads(out)["series"]
    for flt in ((), ("--stage", "prov"), ("--circuit", "toy")):
        rc, out = both(*flt)
        assert rc == 0 and out
    base = str(tmp_path / "base.json")
    assert both("--rebaseline", "--baseline", base) == (0, "")
    rc, out = both("--gate", "--baseline", base)
    assert rc == 0 and "perf-gate: ok" in out
    for circuit in ("toy", "venmo"):
        ref_pl.append_entry(ref_pl.make_entry("bench", circuit, {"prove": {"p50_ms": 9000.0, "p95_ms": 9e3, "n": 1},
                                                                 "verify": {"p50_ms": 0.5, "p95_ms": 0.5, "n": 1}},
                                              execution_digest="d1"), path=ledger)
    rc, out = both("--gate", "--baseline", base)
    assert rc == 1 and "DRIFT    toy/prove" in out and "flame_toy_prove_1754000002.json" in out
    assert "IMPROVED" in out and "perf --rebaseline" in out
    rc, out = both()
    assert "REGRESSED" in out and "capture:" in out
    empty = str(tmp_path / "empty.jsonl")
    assert run_cli(cli.main, ["perf", "--device", "cpu", "--ledger", empty])[0] == 1
    assert run_cli(cli.main, ["perf", "--device", "cpu", "--ledger", empty, "--rebaseline", "--baseline",
                              str(tmp_path / "b2.json")])[0] == 2


# ---------------------------------------------------- the key and the card


def test_the_cpu_key_differs_from_a_cards_and_refuses_its_lines(tmp_path, monkeypatch):
    cpu = hostprof.host_fingerprint("cpu")
    assert cpu["platform"] == "cpu" and set(cpu) == {"platform", "cpu_model"}
    card = {"platform": "cuda", "device_name": "NVIDIA H100 80GB HBM3", "capability": "9.0", "sm_count": 132,
            "total_memory": 85045870592, "cpu_model": cpu["cpu_model"]}
    cpu_key, card_key = hostprof.fingerprint_key(device="cpu"), hostprof.fingerprint_key(card)
    assert cpu_key != card_key and len(cpu_key) == len(card_key) == 16
    assert pl.ledger_path(str(tmp_path), "cpu").endswith(f"perf_ledger_{cpu_key}.jsonl")
    path = str(tmp_path / "ledger.jsonl")
    pl.append_entry(pl.make_entry("service", "toy", {"prove": {"p50_ms": 3.0}}, execution_digest="d", device="cpu"),
                    path)
    assert len(pl.load_entries(path, device="cpu")[0]) == 1
    real = hostprof.host_fingerprint
    monkeypatch.setattr(hostprof, "host_fingerprint", lambda device=None: card if device != "cpu" else real("cpu"))
    pl.append_entry(pl.make_entry("service", "toy", {"prove": {"p50_ms": 4.0}}, execution_digest="d",
                                  device="cuda"), path)
    card_view, cpu_view = pl.load_entries(path, device="cuda"), pl.load_entries(path, device="cpu")
    assert [e["stages"]["prove"]["p50_ms"] for e in card_view[0]] == [4.0] and card_view[1]["foreign"] == 1
    assert [e["stages"]["prove"]["p50_ms"] for e in cpu_view[0]] == [3.0] and cpu_view[1]["foreign"] == 1


def test_without_cuda_the_key_and_perf_raise(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only host's refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hostprof.fingerprint_key()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["perf", "--ledger", str(tmp_path / "l.jsonl")])


# ---------------------------------------------- the seeded regression


@pytest.fixture(scope="module")
def world():
    cs, _, _ = build_cs(RefCS, RefLC)
    pk, vk = ref_setup(cs, seed="svc-faults")
    return {"cs": cs, "pk": pk, "vk": vk}


HISTORY_MS = 400.0  # the seeded prove p50: a 600 ms budget
HANG_S = "0.7"


def seed_history(cache):
    path = pl.ledger_path(str(cache), "cpu")
    for _ in range(3):
        pl.append_entry(pl.make_entry("bench", "toy", {"prove": {"p50_ms": HISTORY_MS, "p95_ms": HISTORY_MS, "n": 4}},
                                      execution_digest="hist", device="cpu"), path)
    return path


def overruns(stage="prove"):
    return REGISTRY.counter("zkp2p_stage_budget_overruns_total", {"stage": stage}).value


def sweep(side, cache, spool, n, wid="", hang=False, **kw):
    os.makedirs(spool, exist_ok=True)
    write_reqs(spool, [(3 + i, 5) for i in range(n)], prefix=f"{os.path.basename(spool)}_")
    if hang:
        faults.arm(f"prove:hang={HANG_S}")
    try:
        svc = kw.pop("svc", None) or side.service(circuit="toy", cache_dir=str(cache), worker_id=wid, **kw)
        assert svc.process_dir(spool)["done"] == n
    finally:
        faults.reset()
    return svc


def test_seeded_regression_counts_overruns_and_a_clean_sweep_none(world, tmp_path):
    side = Side("port", world)
    cache = tmp_path / "cache"
    path = seed_history(cache)
    c0 = overruns()
    svc = sweep(side, cache, str(tmp_path / "clean"), 2)
    assert overruns() == c0 and svc._perf_hb == {"overruns": 0, "checked": 2, "budgets": 1}
    svc2 = sweep(side, cache, str(tmp_path / "slow"), 2, hang=True)
    assert overruns() - c0 == 2 and svc2._perf_hb["overruns"] == 2
    hb_dir = str(tmp_path / "hb")
    _write_heartbeat(svc2, hb_dir)
    (name,) = os.listdir(hb_dir)
    with open(os.path.join(hb_dir, name)) as f:
        assert json.load(f)["perf"] == {"overruns": 2, "checked": 2, "budgets": 1}
    # the exit stamp: one service entry of this run's spans, which the next
    # budgets see
    assert svc2._perf_stamp() == path
    entries, refused = pl.load_entries(path, device="cpu")
    assert entries[-1]["source"] == "service" and entries[-1]["circuit"] == "toy"
    assert entries[-1]["stages"]["prove"]["p50_ms"] > 1.5 * HISTORY_MS and not any(refused.values())
    # the ledger off: no book, no check, no stamp
    svc3 = sweep(side, cache, str(tmp_path / "off"), 1, hang=True, perf_ledger=False)
    assert overruns() - c0 == 2 and svc3._perf_hb["budgets"] == 0 and svc3._perf_stamp() is None


def test_settings_outside_their_ranges_raise(world):
    side = Side("port", world)
    for kw in ({"perf_tolerance": 0.9}, {"perf_window": 0}, {"flame_hz": 0.0}, {"flame_capture_n": 0},
               {"flame_cooldown_s": -1.0}):
        with pytest.raises(ValueError):
            side.service(**kw)


class _Alive:
    pid = 1

    @staticmethod
    def poll():
        return None


def test_perf_regression_fires_from_two_workers_heartbeats_and_clears(world, tmp_path, monkeypatch):
    """Two port workers' real heartbeat files, written after their sweeps,
    feed the fleet plane: the rule holds on budgets with no overrun,
    fires while overruns keep accruing past its for_s, and clears after
    clear_s without a new one (a clock of the test's own)."""
    # the heartbeats' SLO windows come from the process's tracker: a fresh
    # one, so that requests of earlier tests in this process burn no budget
    monkeypatch.setattr(port_slo, "_default", port_slo.SloTracker())
    side = Side("port", world)
    cache = tmp_path / "cache"
    seed_history(cache)
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    sup = FleetSupervisor(spool, lambda wid: ["true"], workers=2, fleet_dir=str(tmp_path / "fleet"),
                          log=lambda m: None)
    for slot in sup.slots.values():
        slot.proc, slot.state = _Alive(), "up"
    svcs = {wid: side.service(circuit="toy", cache_dir=str(cache), worker_id=wid) for wid in sup.slots}
    plane = FleetPlane(sup, port=0, scrape_s=0.5, clock=lambda: 0.0, log=lambda m: None)
    plane._fetch_snapshot = lambda port: None

    def round_(t, hang):
        for wid, svc in svcs.items():
            sweep(side, cache, str(tmp_path / f"{wid}_{t}"), 2, svc=svc, hang=hang)
            _write_heartbeat(svc, sup.fleet_dir)
        return scrape(t)

    def scrape(t):
        view = plane.scrape_once(now=float(t))
        return view["signals"]["budget_overruns"], [a["rule"] for a in plane.engine.active()]

    assert scrape(0) == (None, [])  # no heartbeat has a perf block yet: the rule holds
    assert round_(1, hang=False) == (0, [])
    assert round_(10, hang=True) == (4, [])  # pending
    assert round_(13, hang=True) == (8, [])
    assert scrape(15) == (8, ["perf_regression"])  # accruing for for_s: fired
    assert round_(20, hang=False) == (8, ["perf_regression"])  # quiet, but not for clear_s yet
    assert scrape(51) == (8, [])  # cleared
    assert REGISTRY.counter("zkp2p_fleet_alerts_total", {"rule": "perf_regression"}).value >= 1
    # status.json's worker rows carry the heartbeats' perf blocks, and top's
    # overrun column reads them
    workers = sup.status()["workers"]
    assert {w: v["perf"] for w, v in workers.items()} == {w: {"overruns": 4, "checked": 8, "budgets": 1}
                                                         for w in svcs}
    frame = render_top({"ok": True, "fleet_id": sup.fleet_id, "workers": workers})
    rows = [ln.split() for ln in frame.splitlines() if ln.split() and ln.split()[0] in svcs]
    assert "overrun" in frame and "flame" not in frame and [r[-1] for r in rows] == ["4", "4"]


def test_the_fleet_passes_the_settings_to_its_workers_as_flags(tmp_path):
    """`fleet`'s perf and flame flags reach each worker's argv (after its
    identity), and `service` parses them."""
    import sys

    out = tmp_path / "argv.json"
    worker = [sys.executable, "-c", f"import json, sys; json.dump(sys.argv[1:], open({str(out)!r}, 'w'))"]
    with pytest.raises(SystemExit) as rc:
        cli.main(["fleet", "--spool", str(tmp_path / "spool"), "--workers", "1", "--worker-cmd", json.dumps(worker),
                  "--no-perf-ledger", "--perf-window", "4", "--cache-dir", str(tmp_path / "c"), "--flame", "--flame-hz",
                  "97", "--max-seconds", "60"])
    assert rc.value.code == 0
    argv = json.loads(out.read_text())
    assert argv[argv.index("--metrics-port") + 2:] == ["--perf-window", "4", "--cache-dir", str(tmp_path / "c"),
                                                       "--flame-hz", "97.0", "--no-perf-ledger", "--flame"]
    sup = FleetSupervisor(str(tmp_path / "s2"), lambda wid: ["w"], workers=1, log=lambda m: None)
    assert sup._argv("w0")[-2:] == ["--metrics-port", "0"]  # no setting given: the workers' defaults
    with pytest.raises(ValueError, match="unknown perf settings"):
        FleetSupervisor(str(tmp_path / "s3"), lambda wid: ["w"], perf={"flame_rate": 1}, log=lambda m: None)
    with pytest.raises(SystemExit) as rc:  # parsed, then refused for its circuit, not for its flags
        cli.main(["service", "--spool", str(tmp_path / "s4"), "--device", "cpu", *argv[argv.index("--metrics-port") + 2:],
                  "--perf-tolerance", "2", "--flame-capture-n", "1", "--flame-cooldown-s", "0"])
    assert "email circuits" in str(rc.value.code)
