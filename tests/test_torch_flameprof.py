"""The port's flame sampler (zkp2p_tpu_torch.utils.flameprof, the service's
overrun-triggered captures and the `flame` command) against the
reference's utils/flameprof.py, on the CPU.

  * _fold, collapsed_text, write_capture / load_capture / captures_for
    and CaptureController's trigger, cooldown and sweep_tick give the
    reference's results on the same inputs, under a clock of the test's
    own;
  * the card's frames: a thread parked in a bridge file while the launch
    counters move gets a `gpu:<launcher>` frame (the launcher that moved
    most) under its leaf, and launches no parked thread was seen waiting
    for fold under the `[gpu]` root, one count a launch; the capture's
    gpu_launches are every launch of the window (no kernel runs here: the
    tests drive the counters by hand);
  * a port capture renders through the reference's standalone
    tools/trace_report.py (--flame, --chrome-trace) in a subprocess;
  * a service sweep whose prove overruns a seeded budget writes one
    capture over the next sweep, linked to the ledger's head and in the
    heartbeat's perf block; a clean sweep and the flame gate off write
    none;
  * `python -m zkp2p_tpu_torch --circuit toy flame --device cpu
    --duration 0.5` exits 0, prints collapsed stacks and writes a
    capture."""

import glob
import json
import os
import re
import subprocess
import sys
import threading
import time
import types

import pytest

from zkp2p_tpu.utils import flameprof as ref_fp
from zkp2p_tpu.utils.metrics import REGISTRY as REF_REGISTRY

from test_torch_perfledger import seed_history, sweep
from test_torch_service import Side, build_cs, RefCS, RefLC, ref_setup
from zkp2p_tpu_torch.ops import cuda_build
from zkp2p_tpu_torch.utils import flameprof as fp
from zkp2p_tpu_torch.utils import perfledger as pl
from zkp2p_tpu_torch.utils.metrics import REGISTRY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = "tests/test_torch_flameprof.py"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("ZKP2P_FLAME", "ZKP2P_FLAME_HZ", "ZKP2P_FLAME_CAPTURE_N", "ZKP2P_FLAME_COOLDOWN_S",
                "ZKP2P_MSM_PRECOMP_CACHE", "ZKP2P_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    fp.controller().reset()
    ref_fp.controller().reset()
    yield
    fp.controller().reset()
    ref_fp.controller().reset()


def captures(trigger, registry=REGISTRY):
    return registry.counter("zkp2p_flame_captures_total", {"trigger": trigger}).value


class Clock:
    """One clock for both sides: monotonic, wall and perf_counter."""

    def __init__(self, t=1754000000.0):
        self.t = t

    def __call__(self):
        return self.t

    def module(self):
        return types.SimpleNamespace(monotonic=self, time=self, perf_counter=time.perf_counter)


# ------------------------------------------------------------ folding


def _park(stop_evt):
    # a thread whose leaf frame sits in this file: what a wait on the card
    # looks like to the sampler
    while not stop_evt.is_set():
        time.sleep(0.002)


def _nested(stop_evt):
    def inner():
        _park(stop_evt)

    inner()


def parked_thread(target=_park):
    stop_evt = threading.Event()
    t = threading.Thread(target=target, args=(stop_evt,), daemon=True)
    t.start()
    time.sleep(0.02)
    return t, stop_evt


@pytest.mark.parametrize("depth", [1, 3, 64])
def test_fold_equals_the_reference(depth):
    t, stop_evt = parked_thread(_nested)
    try:
        frame = sys._current_frames()[t.ident]
        assert fp._fold(frame, depth) == ref_fp._fold(frame, depth)
        assert fp._fold(frame)[-3:] == ["test_torch_flameprof.py:_nested", "test_torch_flameprof.py:inner",
                                        "test_torch_flameprof.py:_park"] or depth < 64
    finally:
        stop_evt.set()
        t.join()


def test_collapsed_text_equals_the_reference():
    for stacks in ({}, {"a;b": 3, "a;c": 7, "z": 7}, {"[gpu];gpu:zk_mont_mul": 12, "x;y;gpu:zk_fr_matvec": 1}):
        assert fp.collapsed_text(stacks) == ref_fp.collapsed_text(stacks)
    assert fp.collapsed_text({"a;b": 3, "a;c": 7, "z": 7}).splitlines() == ["a;c 7", "z 7", "a;b 3"]


# ----------------------------------------------------------- the card's frames


class Counts:
    """A launch-counter stand-in that advances every read."""

    def __init__(self, **per_read):
        self.per_read, self.t = per_read, dict.fromkeys(per_read, 0)

    def __call__(self):
        for k, n in self.per_read.items():
            self.t[k] += n
        return dict(self.t)


def sampled(counts_source, filter_parked=True, seconds=0.15):
    t, stop_evt = parked_thread()
    s = fp.FlameSampler(hz=200.0, counts_source=counts_source,
                        thread_filter={t.ident} if filter_parked else set()).start()
    time.sleep(seconds)
    s.stop()
    stop_evt.set()
    t.join()
    return s


def test_a_parked_thread_gets_the_top_launcher_frame(monkeypatch):
    monkeypatch.setattr(fp, "BRIDGE_SUFFIXES", (HERE,))
    s = sampled(Counts(zk_mont_mul=1, zk_fr_matvec=3))
    stacks, body = s.stacks(), s.result()
    assert any(k.endswith("test_torch_flameprof.py:_park;gpu:zk_fr_matvec") for k in stacks), stacks
    assert not any(k.startswith("[gpu]") and "mont_mul" in k for k in stacks if stacks[k] > 1), stacks
    # every launch is counted, and only the last window's went unseen
    assert body["gpu_launches"]["zk_fr_matvec"] == 3 * body["gpu_launches"]["zk_mont_mul"] > 0
    assert body["gpu_unattributed_launches"] == {"zk_mont_mul": 1, "zk_fr_matvec": 3}
    assert body["samples"] > 0 and body["sampler"]["self_ms"] >= 0.0


class Burst:
    """Launch counters that move on the first `reads` reads only: a proof
    that enqueues its kernels, then waits."""

    def __init__(self, reads=2, **per_read):
        self.left, self.per_read, self.t = reads, per_read, dict.fromkeys(per_read, 0)

    def __call__(self):
        if self.left > 0:
            self.left -= 1
            for k, n in self.per_read.items():
                self.t[k] += n
        return dict(self.t)


@pytest.mark.parametrize("busy", [True, False])
def test_a_thread_waiting_on_a_busy_card_keeps_the_last_launcher_frame(monkeypatch, busy):
    monkeypatch.setattr(fp, "BRIDGE_SUFFIXES", (HERE,))
    t, stop_evt = parked_thread()
    s = fp.FlameSampler(hz=200.0, counts_source=Burst(zk_mont_mul=1, zk_g1_window_accumulate=4),
                        thread_filter={t.ident}, busy_source=lambda: busy).start()
    time.sleep(0.15)
    s.stop()
    stop_evt.set()
    t.join()
    body = s.result()
    framed = sum(v for k, v in body["stacks"].items() if k.endswith(":_park;gpu:zk_g1_window_accumulate"))
    bare = sum(v for k, v in body["stacks"].items() if k.endswith(":_park"))
    # the launches are counted alike; only the frames of the waiting windows differ
    assert body["gpu_launches"] == {"zk_mont_mul": 1, "zk_g1_window_accumulate": 4}
    assert body["samples"] > 5 and framed + bare == body["samples"]
    if busy:
        assert bare == 0 and framed == body["samples"], body["stacks"]
    else:
        assert framed == 1 and bare == body["samples"] - 1, body["stacks"]


def test_launches_nobody_waited_for_fold_under_the_gpu_root(monkeypatch):
    monkeypatch.setattr(fp, "BRIDGE_SUFFIXES", ("no/such/file.py",))
    s = sampled(Counts(zk_fr_ntt_pass=2))
    body = s.result()
    assert body["gpu_unattributed_launches"] == body["gpu_launches"] and body["gpu_launches"]["zk_fr_ntt_pass"] > 0
    assert s.stacks()["[gpu];gpu:zk_fr_ntt_pass"] == body["gpu_launches"]["zk_fr_ntt_pass"]
    assert not any(";gpu:" in k and not k.startswith("[gpu]") for k in s.stacks())


def test_the_default_source_reads_the_launch_counters(monkeypatch):
    monkeypatch.setattr(fp, "BRIDGE_SUFFIXES", (HERE,))
    monkeypatch.setitem(cuda_build.LAUNCHES, "zk_signed_recode", 0)  # restored after the test
    t, stop_evt = parked_thread()
    s = fp.FlameSampler(hz=200.0, thread_filter={t.ident}).start()
    for _ in range(20):
        cuda_build.LAUNCHES["zk_signed_recode"] += 2
        time.sleep(0.01)
    s.stop()
    stop_evt.set()
    t.join()
    body = s.result()
    assert body["gpu_launches"] == {"zk_signed_recode": 40}
    assert any(k.endswith(":_park;gpu:zk_signed_recode") for k in body["stacks"]), body["stacks"]
    # no launch, no gpu frame
    quiet = sampled(Counts(), seconds=0.05)
    assert quiet.result()["gpu_launches"] == {} and not any("gpu" in k for k in quiet.stacks())


def test_profile_proves_runs_until_the_duration_and_raises_a_failure():
    calls = []
    s, seconds = fp.profile_proves(lambda: calls.append(time.sleep(0.02)), 0.1, hz=100.0)
    s.stop()
    assert len(seconds) == len(calls) >= 2 and all(x >= 0.02 for x in seconds)
    s, seconds = fp.profile_proves(lambda: None, 0.0)
    s.stop()
    assert len(seconds) == 1  # at least one call

    def boom():
        raise RuntimeError("a kernel failed")

    with pytest.raises(RuntimeError, match="a kernel failed"):
        fp.profile_proves(boom, 1.0)


# ------------------------------------------------------------ capture files


class Frozen:
    """A sampler stand-in with a fixed body, for both sides' writers."""

    samples = 5

    def stop(self):
        pass

    def result(self):
        return {"hz": 47.0, "samples": 5, "windows": 5, "duration_s": 0.1, "sampler": {"self_ms": 0.5},
                "stacks": {"a;b": 3, "a;c": 2}}


def test_capture_files_equal_the_reference(tmp_path, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(ref_fp, "time", clock.module())
    monkeypatch.setattr(ref_fp, "execution_digest", lambda: "x", raising=False)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    c0, r0 = captures("manual"), captures("manual", REF_REGISTRY)
    cases = [("toy", "prove", "manual", {"entry_digest": "e1", "budget_ms": 225.0, "over_ms": 400.0}),
             ("toy", "witness", "overrun", {}), ("venmo", "prove", "manual", {}), ("a/b c", "s:t", "manual", {})]
    for i, (circuit, stage, trigger, kw) in enumerate(cases):
        clock.t += 1
        r = ref_fp.write_capture(Frozen(), circuit, stage, trigger, out_dir=str(ref_dir), **kw)
        p = fp.write_capture(Frozen(), circuit, stage, trigger, str(port_dir), clock=clock, **kw)
        assert os.path.basename(p) == os.path.basename(r)
        rd, pd = ref_fp.load_capture(r), fp.load_capture(p)
        assert {k: v for k, v in pd.items() if k != "execution_digest"} == {
            k: v for k, v in rd.items() if k != "execution_digest"}
        assert fp.load_capture(r) == rd and ref_fp.load_capture(p) == pd
    assert captures("manual") - c0 == captures("manual", REF_REGISTRY) - r0 == 3
    assert not glob.glob(str(port_dir / "*.tmp.*"))
    assert fp.write_capture(Frozen(), "toy", "prove", "manual", None) is None
    for circuit, stage in (("toy", None), ("toy", "prove"), ("venmo", None), ("none", None), ("a/b c", None)):
        got = [(os.path.basename(p), d["stage"]) for p, d in fp.captures_for(circuit, str(port_dir), stage)]
        want = [(os.path.basename(p), d["stage"]) for p, d in ref_fp.captures_for(circuit, stage, str(ref_dir))]
        assert got == want, (circuit, stage)
    assert fp.captures_for("toy", None) == []
    good = fp.captures_for("toy", str(port_dir), "prove")[0][0]
    with open(good) as f:
        doc = json.load(f)
    bad = str(tmp_path / "bad.json")
    for mutate in (lambda d: d.update(kind="other"), lambda d: d.update(schema=2),
                   lambda d: d.update(stacks={"a;b": "3"}), lambda d: d.update(stacks=["a;b"]),
                   lambda d: d.update(stacks={"a": -1})):
        d = dict(doc)
        mutate(d)
        with open(bad, "w") as f:
            json.dump(d, f)
        assert fp.load_capture(bad) is None and ref_fp.load_capture(bad) is None
    with open(bad, "w") as f:
        f.write(json.dumps(doc)[:40])
    assert fp.load_capture(bad) is None is ref_fp.load_capture(bad)
    assert fp.load_capture(str(tmp_path / "none.json")) is None


# ------------------------------------------------------- CaptureController


def test_controller_equals_the_reference(tmp_path, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(ref_fp, "time", clock.module())
    monkeypatch.setenv("ZKP2P_FLAME", "1")
    monkeypatch.setenv("ZKP2P_FLAME_HZ", "200")
    monkeypatch.setenv("ZKP2P_FLAME_CAPTURE_N", "2")
    monkeypatch.setenv("ZKP2P_FLAME_COOLDOWN_S", "60")
    monkeypatch.setenv("ZKP2P_MSM_PRECOMP_CACHE", str(tmp_path / "ref"))
    ref, port = ref_fp.CaptureController(), fp.CaptureController(clock=clock, wall=clock)
    out = str(tmp_path / "port")

    def trig(**kw):
        r = ref.trigger("toy", "prove", **kw)
        return r, port.trigger("toy", "prove", out, hz=200.0, capture_n=2, cooldown_s=cooldown[0], **kw)

    def tick():
        r, p = ref.sweep_tick(), port.sweep_tick()
        return (r and os.path.basename(r)), (p and os.path.basename(p))

    cooldown = [60.0]
    assert trig(entry_digest="ed9", budget_ms=225.0, over_ms=750.0) == (True, True)
    assert ref.active() and port.active()
    assert trig() == (False, False)  # one capture at a time
    assert tick() == (None, None)  # sweep 1 of 2
    clock.t += 5
    r, p = tick()
    assert r == p == "flame_toy_prove_1754000005.json"
    rd = ref_fp.load_capture(os.path.join(str(tmp_path / "ref"), r))
    pd = fp.load_capture(os.path.join(out, p))
    for k in ("trigger", "entry_digest", "budget_ms", "over_ms", "circuit", "stage", "ts", "hz"):
        assert rd[k] == pd[k], k
    assert pd["trigger"] == "overrun" and pd["entry_digest"] == "ed9"
    assert port.pointer() == ref.pointer() | {"samples": port.pointer()["samples"]}
    clock.t += 30
    assert trig() == (False, False)  # cooling down
    assert tick() == (None, None)
    clock.t += 31
    assert trig() == (True, True)  # past the cooldown
    ref.reset()
    port.reset()
    assert not port.active() and port.pointer() is None
    monkeypatch.setenv("ZKP2P_FLAME_COOLDOWN_S", "0")
    cooldown[0] = 0.0
    for _ in range(2):
        assert trig() == (True, True)
        tick()
        assert tick()[1] is not None  # no cooldown: again at once
    ref.reset()
    port.reset()


# --------------------------------------------------- the reference's report


def test_a_port_capture_renders_through_the_reference_trace_report(tmp_path, monkeypatch):
    monkeypatch.setattr(fp, "BRIDGE_SUFFIXES", (HERE,))
    s = sampled(Counts(zk_mont_mul=2))
    path = fp.write_capture(s, "toy", "prove", "overrun", str(tmp_path), entry_digest="ed")
    tool = os.path.join(ROOT, "tools", "trace_report.py")
    p = subprocess.run([sys.executable, tool, "--flame", path], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines() == fp.collapsed_text(fp.load_capture(path)["stacks"]).splitlines()
    out_json = str(tmp_path / "trace.json")
    p = subprocess.run([sys.executable, tool, "--flame", path, "--chrome-trace", out_json], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    with open(out_json) as f:
        ev = json.load(f)["traceEvents"]
    assert any("flame toy/prove" in e["args"]["name"] for e in ev if e["ph"] == "M")
    names = {e["name"] for e in ev if e["ph"] == "X"}
    assert "gpu:zk_mont_mul" in names and "test_torch_flameprof.py:_park" in names


# ------------------------------------------------ the service's captures


@pytest.fixture(scope="module")
def world():
    cs, _, _ = build_cs(RefCS, RefLC)
    pk, vk = ref_setup(cs, seed="svc-faults")
    return {"cs": cs, "pk": pk, "vk": vk}


def test_an_overrun_writes_one_linked_capture_with_gpu_frames(world, tmp_path, monkeypatch):
    """flame on, a capture over one sweep: the seeded regression's first
    prove overrun triggers it, the rest of the sweep runs under the
    sampler (its prover parks in this file while launch counters move),
    the end of the sweep writes it.  A clean sweep and the gate off write
    none."""
    monkeypatch.setattr(fp, "BRIDGE_SUFFIXES", (HERE,))
    monkeypatch.setitem(cuda_build.LAUNCHES, "zk_g1_window_accumulate", 0)
    side = Side("port", world)

    def launching_prover(dpk, wits):
        for _ in range(5):
            cuda_build.LAUNCHES["zk_g1_window_accumulate"] += 1
            time.sleep(0.02)
        return side.prove(dpk, wits)

    cache = tmp_path / "cache"
    path = seed_history(cache)
    head = pl.load_entries(path, device="cpu")[0][-1]["entry_digest"]
    kw = dict(prover_fn=launching_prover, batch_size=1, flame=True, flame_hz=97.0, flame_capture_n=1,
              flame_cooldown_s=0.0)
    svc = sweep(side, cache, str(tmp_path / "clean"), 2, **kw)
    assert svc._perf_hb["overruns"] == 0 and "capture" not in svc._perf_hb
    assert fp.captures_for("toy", str(cache)) == []
    c0 = captures("overrun")
    svc = sweep(side, cache, str(tmp_path / "slow"), 3, hang=True, **kw)
    assert svc._perf_hb["overruns"] == 3
    (cap_path, doc), = fp.captures_for("toy", str(cache))
    assert captures("overrun") - c0 == 1
    assert (doc["trigger"], doc["stage"], doc["entry_digest"], doc["budget_ms"]) == ("overrun", "prove", head, 600.0)
    assert doc["over_ms"] > 600.0 and doc["samples"] > 0
    assert doc["gpu_launches"]["zk_g1_window_accumulate"] >= 5
    assert any("launching_prover;gpu:zk_g1_window_accumulate" in k for k in doc["stacks"]), doc["stacks"]
    ptr = svc._perf_hb["capture"]
    assert ptr["file"] == os.path.basename(cap_path) and ptr["stage"] == "prove" and ptr["samples"] == doc["samples"]
    # the gate off: the overrun counts, no capture starts
    off = sweep(side, cache, str(tmp_path / "off"), 1, hang=True, **{**kw, "flame": False})
    assert off._perf_hb["overruns"] == 1 and len(fp.captures_for("toy", str(cache))) == 1


# ---------------------------------------------------------- the command


def test_flame_command_on_the_cpu_writes_a_capture(tmp_path):
    p = subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch", "--circuit", "toy", "--build-dir",
                        str(tmp_path / "nokey"), "flame", "--device", "cpu", "--duration", "0.5", "--cache-dir",
                        str(tmp_path / "captures")],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [ln.rsplit(" ", 1) for ln in p.stdout.splitlines() if ln.strip()]
    assert rows and all(len(r) == 2 and r[1].isdigit() for r in rows)
    assert any("groth16_gpu.py:prove_gpu" in r[0] for r in rows)
    m = re.search(r"flame: capture -> (\S+)", p.stderr)
    assert m, p.stderr[-2000:]
    try:
        doc = fp.load_capture(m.group(1))
        assert doc["trigger"] == "manual" and doc["stage"] == "on-demand" and doc["circuit"] == "toy"
        assert doc["gpu_launches"] == {}  # the CPU runs the plain versions: no launch
        assert os.path.dirname(m.group(1)) == str(tmp_path / "captures")
    finally:
        os.remove(m.group(1))
