"""The port's ``batch`` command on its circuit route, on the CPU: a
directory of toy-circuit inputs (*.json, {"message": ...}; the .eml
beside them is not the toy circuit's type and is left alone) against a
key the reference's ``setup`` wrote gives <name>.proof.json and
<name>.public.json equal, byte for byte, to the reference's
``dump(proof_to_json(prove_host(...)))`` for each input's witness and
pinned r, s; the port's ``verify`` accepts them.  Apart from
test_torch_circuit_cli.py so that the test runner's workers prove the
two files in parallel (one chunk costs about one CPU proof)."""

import argparse
import json

import pytest
import torch

from zkp2p_tpu.formats import proof_json as ref_json
from zkp2p_tpu.pipeline import cli as ref_cli
from zkp2p_tpu.snark.groth16 import prove_host, setup

from test_torch_circuit_cli import SEED, ref_setup_args
from test_torch_cli import pinned_randbelow
from zkp2p_tpu_torch.pipeline import cli

torch.set_num_threads(1)

MESSAGES = {"a": "57", "b": "ÿ!"}
DRAWS = [11, 22, 33, 44]  # r - 1, s - 1 for a, b in turn


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch")
    ref_cli.cmd_setup(ref_setup_args(d, "toy"))
    indir, outdir = d / "in", d / "out"
    indir.mkdir()
    for name, msg in MESSAGES.items():
        (indir / f"{name}.json").write_text(json.dumps({"message": msg}))
    (indir / "other.eml").write_bytes(b"not an input of the toy circuit")
    with pinned_randbelow(DRAWS):
        cli.main(["--build-dir", str(d), "--circuit", "toy", "batch", "--device", "cpu", "--indir", str(indir),
                  "--outdir", str(outdir), "--chunk", "0"])
    return d, indir, outdir


@pytest.mark.parametrize("i,name", list(enumerate(MESSAGES)))
def test_batch_files_equal_the_reference(batch, tmp_path, i, name):
    d, indir, outdir = batch
    cs, meta = ref_cli._build_circuit("toy", 256, 192)
    pk, _ = setup(cs, seed=SEED)
    args = argparse.Namespace(circuit="toy", message=None, eml=None, order_id=1, claim_id=0)
    w, pub = ref_cli._witness_for(args, cs, meta, source=str(indir / f"{name}.json"))
    r, s = DRAWS[2 * i] + 1, DRAWS[2 * i + 1] + 1
    ref_json.dump(ref_json.proof_to_json(prove_host(pk, cs, w, r, s)), str(tmp_path / "p.json"))
    ref_json.dump(ref_json.public_to_json(pub), str(tmp_path / "q.json"))
    assert (outdir / f"{name}.proof.json").read_bytes() == (tmp_path / "p.json").read_bytes()
    assert (outdir / f"{name}.public.json").read_bytes() == (tmp_path / "q.json").read_bytes()
    assert sorted(p.name for p in outdir.iterdir()) == sorted(
        f"{k}.{kind}.json" for k in MESSAGES for kind in ("proof", "public"))


def test_verify_accepts_a_batch_proof(batch, capsys):
    d, _, outdir = batch
    with pytest.raises(SystemExit) as e:
        cli.main(["--build-dir", str(d), "verify", "--proof", str(outdir / "b.proof.json"),
                  "--public", str(outdir / "b.public.json")])
    assert e.value.code == 0 and capsys.readouterr().out.strip() == "OK"


def test_batch_without_inputs_of_the_circuits_type_exits(batch, tmp_path):
    d, _, _ = batch
    (tmp_path / "x.eml").write_bytes(b"")
    with pytest.raises(SystemExit, match=r"no \*.wtns inputs in .* \(nor \*.json ones of --circuit toy\)"):
        cli.main(["--build-dir", str(d), "--circuit", "toy", "batch", "--device", "cpu", "--indir", str(tmp_path),
                  "--outdir", str(tmp_path / "out")])
