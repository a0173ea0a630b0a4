"""The port's ceremony on the reference's test world (built as in
test_torch_ceremony.py), on the CPU: the chain's prefixes verify, and the
command line's `ceremony contribute` (a subprocess, fresh randomness) and
`ceremony verify` print the reference's lines and exit codes."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_ceremony import build_world
from zkp2p_tpu_torch.pipeline import cli
from zkp2p_tpu_torch.snark import ceremony

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_world(tmp_path_factory.mktemp("ceremony_cli"))


@pytest.mark.parametrize("upto", [1, 2])
def test_intermediate_prefix_also_verifies(world, upto):
    z0, prefix = world[1], world[1 + upto]
    ok, log = ceremony.verify_chain(z0, prefix, device="cpu")
    assert ok, log
    assert sum("PoK + delta link verified" in line for line in log) == upto


def test_cli_ceremony_roundtrip(world, tmp_path, capsys):
    """contribute as `python -m zkp2p_tpu_torch` runs it, then verify
    through main(): ZKEY OK and exit 0; the initial key against itself
    has no MPC section: ZKEY INVALID and exit 1; beacon without a hash
    exits 2 before it reads a file."""
    z0 = world[1]
    out = str(tmp_path / "cli.zkey")
    run = subprocess.run([sys.executable, "-m", "zkp2p_tpu_torch", "ceremony", "contribute", z0, out, "--entropy",
                          "cli-test", "--name", "cli", "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip() == f"contributed -> {out}"
    assert "contribute: read" in run.stderr and '"g1_scale"' not in run.stderr  # the plain version counts nothing
    for argv, code, last in ((["ceremony", "verify", z0, out], 0, "ZKEY OK"),
                             (["ceremony", "verify", z0, z0], 1, "ZKEY INVALID")):
        with pytest.raises(SystemExit) as done:
            cli.main(argv + ["--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        assert done.value.code == code and lines[-1] == last
    assert lines[0] == "FAIL: cs_hash does not bind to the initial circuit"
    with pytest.raises(SystemExit) as done:
        cli.main(["ceremony", "beacon", str(tmp_path / "absent.zkey"), str(tmp_path / "b.zkey")])
    assert done.value.code == 2 and "beacon requires --beacon-hash" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "b.zkey")
