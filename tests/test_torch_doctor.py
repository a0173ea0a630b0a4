"""The port's doctor (zkp2p_tpu_torch.utils.audit.preflight), on a host
with no CUDA device: `python -m zkp2p_tpu_torch doctor --json
--no-workload` exits 0 with one JSON object that reports the backend
unavailable with a warning, every source's kernels and every gate's arm;
two in-process runs give the same digest; --strict exits 1; the service
logs the preflight before its first claim."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zkp2p_tpu_torch.ops import cuda_build
from zkp2p_tpu_torch.pipeline import cli
from zkp2p_tpu_torch.utils import audit
from zkp2p_tpu_torch.utils.audit import preflight

ROOT = Path(__file__).resolve().parent.parent
GATES = ("msm_affine", "msm_h", "batch_chunk", "faults", "service_slo", "service_timeseries")


def _doctor(*flags):
    return subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch", "doctor", *flags], capture_output=True,
                          text=True, cwd=ROOT, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_doctor_json_without_cuda():
    run = _doctor("--json", "--no-workload")
    assert run.returncode == 0, run.stderr[-2000:]
    rep = json.loads(run.stdout)
    assert rep["type"] == "doctor" and rep["backend"] == "unavailable" and rep["device"] is None
    assert any("no CUDA device" in w for w in rep["warnings"])
    assert "workload_s" not in rep and rep["device_memory"] is None
    assert set(rep["kernels"]) == set(cuda_build.SOURCES)
    assert rep["kernels"]["scale"]["launchers"] == ["zk_g1_scale"]
    for gate in GATES:
        assert rep["gates"].get(gate), f"gate {gate} reported no arm"
    assert rep["gates"]["msm_affine"] == "off" and rep["gates"]["msm_h"] == "windowed"
    assert rep["gates"]["batch_chunk"] == "4" and rep["gates"]["faults"] == "off"
    assert re.fullmatch(r"[0-9a-f]{16}", rep["execution_digest"])
    assert "knobs" not in rep and "provenance" not in rep and "tpu_probe" not in rep


def test_doctor_strict_exits_1_on_the_warning():
    run = _doctor("--strict", "--no-workload")
    assert run.returncode == 1 and run.stdout == ""
    assert "backend: unavailable" in run.stderr and "WARNING: no CUDA device" in run.stderr


def test_digest_identical_across_two_inprocess_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r1 = preflight(workload=False)
    r2 = preflight()
    assert r1["gates"] == r2["gates"] and r1["execution_digest"] == r2["execution_digest"]
    assert r2["workload_s"] is None  # no card: the workload does not run


def test_a_gate_taken_is_reported_as_taken(monkeypatch):
    """A gate this process resolved keeps its arm; preflight fills in
    only the gates not yet seen, at their defaults, and the digest
    follows the arms."""
    monkeypatch.setattr(audit, "_arms", {})
    base = preflight(workload=False)
    audit.record_arm("msm_h", "bucket")
    rep = preflight(workload=False)
    assert rep["gates"]["msm_h"] == "bucket" and rep["execution_digest"] != base["execution_digest"]


def test_workload_mismatch_is_a_warning(monkeypatch):
    """On a card, the K1 workload is held against its plain version: a
    kernel that differs or fails is a warning (strict doctor fails)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (9, 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(audit, "sample_device_memory", lambda stage="": None)
    for bad in ("K1 (mont_mul) over 4096 elements differs from its plain version", None):
        monkeypatch.setattr(audit, "_workload", lambda device, bad=bad: bad)
        rep = preflight()
        assert rep["backend"] == "cuda" and rep["device"] == {"name": "card", "capability": "9.0", "count": 1}
        assert rep["warnings"] == ([bad] if bad else [])
        assert isinstance(rep["workload_s"], float)

    def broken(device):
        raise RuntimeError("CUDA kernel build failed")

    monkeypatch.setattr(audit, "_workload", broken)
    assert preflight()["warnings"] == ["K1 (mont_mul) workload failed: CUDA kernel build failed"]


def test_service_logs_the_preflight_before_claiming(tmp_path, capsys):
    from zkp2p_tpu_torch.pipeline.service import ProvingService

    spool = tmp_path / "spool"
    spool.mkdir()
    svc = ProvingService(None, None, None, None, None, device="cpu", cache_dir=None)
    assert svc.run(str(spool), max_sweeps=1) == "sweeps"
    out = capsys.readouterr()
    assert re.search(r"\[service\] preflight: backend=\w+ execution_digest=[0-9a-f]{16}", out.out)


def test_cli_doctor_in_process(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli.main(["doctor", "--json", "--no-workload"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["backend"] == "unavailable"
    with pytest.raises(SystemExit) as done:
        cli.main(["doctor", "--strict"])
    assert done.value.code == 1
