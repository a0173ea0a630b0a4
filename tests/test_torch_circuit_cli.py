"""The port's command line on its circuit route (``setup``, ``prove``
without --wtns, ``verify``) against the reference's, on the CPU
(--device cpu: the plain versions of the kernels).

``setup --circuit toy`` writes circuit_final.zkey, verification_key.json
and verifier.sol equal, byte for byte, to what the reference's ``setup``
command writes for the same seed (its host setup and ``write_zkey``);
``prove --circuit toy --message ...`` writes the reference's
``dump(proof_to_json(prove_host(...)))`` for the same witness and pinned
r, s, and its public.json; the port's ``verify`` accepts them and rejects
a wrong public signal; a key of another circuit is refused before any
proof.  The sha256 circuit's setup is not run here: at its smallest
header (64 bytes, 27,432 constraints, a 2^15 domain) the CPU setup's
plain fixed-base comb takes many minutes.  One CPU proof (about 40 s)."""

import argparse
import json

import pytest
import torch

from zkp2p_tpu.formats import proof_json as ref_json
from zkp2p_tpu.pipeline import cli as ref_cli
from zkp2p_tpu.snark.groth16 import prove_host, setup

from test_torch_cli import pinned_randbelow
from zkp2p_tpu_torch.pipeline import cli

torch.set_num_threads(1)

SEED = "circuit-cli"


def ref_setup_args(build_dir, circuit):
    return argparse.Namespace(build_dir=str(build_dir), circuit=circuit, max_header=256, max_body=192,
                              skip_audit=False, seed=SEED, chunks=0, publish=None)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    d, ref_d = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("ref")
    cli.main(["--build-dir", str(d), "--circuit", "toy", "setup", "--device", "cpu", "--seed", SEED])
    ref_cli.cmd_setup(ref_setup_args(ref_d, "toy"))
    with pinned_randbelow([11, 22]):
        cli.main(["--build-dir", str(d), "--circuit", "toy", "prove", "--device", "cpu", "--message", "Wz",
                  "--proof", str(d / "proof.json"), "--public", str(d / "public.json")])
    return d, ref_d


@pytest.mark.parametrize("name", ["circuit_final.zkey", "verification_key.json", "verifier.sol"])
def test_setup_files_equal_the_reference(toy, name):
    d, ref_d = toy
    assert (d / name).read_bytes() == (ref_d / name).read_bytes()


def test_prove_writes_the_reference_proof(toy, tmp_path):
    d, _ = toy
    cs, meta = ref_cli._build_circuit("toy", 256, 192)
    pk, _ = setup(cs, seed=SEED)
    args = argparse.Namespace(circuit="toy", message="Wz", eml=None, order_id=1, claim_id=0)
    w, pub = ref_cli._witness_for(args, cs, meta)
    ref_json.dump(ref_json.proof_to_json(prove_host(pk, cs, w, 12, 23)), str(tmp_path / "proof.json"))
    ref_json.dump(ref_json.public_to_json(pub), str(tmp_path / "public.json"))
    assert (d / "proof.json").read_bytes() == (tmp_path / "proof.json").read_bytes()
    assert (d / "public.json").read_bytes() == (tmp_path / "public.json").read_bytes()
    assert json.loads((d / "public.json").read_text()) == [str((ord("W") * ord("z")) ** 2)]


@pytest.mark.parametrize("case,want", [("good", 0), ("public", 1)])
def test_verify_accepts_what_setup_and_prove_wrote(toy, tmp_path, capsys, case, want):
    d, _ = toy
    public = d / "public.json"
    if case == "public":
        public = tmp_path / "public.json"
        public.write_text(json.dumps([str(int(json.loads((d / "public.json").read_text())[0]) + 1)]))
    with pytest.raises(SystemExit) as e:
        cli.main(["--build-dir", str(d), "verify", "--proof", str(d / "proof.json"), "--public", str(public)])
    assert e.value.code == want
    assert capsys.readouterr().out.strip() == ("OK" if want == 0 else "INVALID")


def test_prove_refuses_a_key_of_another_circuit(toy, tmp_path):
    d, _ = toy
    with pytest.raises(SystemExit, match="zkey does not match circuit: zkey has 5 wires / domain 4, circuit has"):
        cli.main(["--build-dir", str(d), "--circuit", "sha256", "--max-header", "64", "prove", "--device", "cpu",
                  "--proof", str(tmp_path / "p.json"), "--public", str(tmp_path / "q.json")])
    assert not (tmp_path / "p.json").exists()
