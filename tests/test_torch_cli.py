"""The port's command line (python -m zkp2p_tpu_torch prove / verify)
against the reference's, on the CPU (--device cpu: the plain versions of
the kernels).

One module-scoped key (build_bits, written by the reference's
write_zkey) and one CLI proof, from a .wtns that holds an unreduced
public and two unreduced private values: proof.json is the reference's
``dump(proof_to_json(prove_host(...)))`` for the same r and s, byte for
byte, and public.json carries the file's values as the reference's CLI
writes them.  The same run shows prove_gpu's span, memory samples,
counter and arms, and writes them with its manifest to the --trace file.  verify gives the reference's exit codes on good and
tampered files; a wrong wire count exits with the reference's message.
A CPU proof costs about 40 s of plain point operations whatever the
circuit, so this file proves once."""

import argparse
import glob
import json
import os
import secrets
import struct
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.formats import proof_json as ref_json
from zkp2p_tpu.formats.circom_bin import write_wtns as ref_write_wtns
from zkp2p_tpu.formats.zkey import split_zkey, write_zkey
from zkp2p_tpu.pipeline import cli as ref_cli
from zkp2p_tpu.snark.groth16 import prove_host, qap_rows, setup

from test_torch_keycache import build_bits
from zkp2p_tpu_torch.formats.zkey import read_zkey
from zkp2p_tpu_torch.pipeline import cli
from zkp2p_tpu_torch.utils import audit
from zkp2p_tpu_torch.utils import trace as tr
from zkp2p_tpu_torch.utils.metrics import REGISTRY

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


def raw_wtns(path, values):
    """A .wtns holding `values` as they are (the writers reduce them)."""
    body = b"".join(v.to_bytes(32, "little") for v in values)
    hdr = struct.pack("<I", 32) + R.to_bytes(32, "little") + struct.pack("<I", len(values))
    with open(path, "wb") as f:
        f.write(b"wtns" + struct.pack("<II", 2, 2))
        f.write(struct.pack("<IQ", 1, len(hdr)) + hdr + struct.pack("<IQ", 2, len(body)) + body)


@contextmanager
def pinned_randbelow(values):
    """secrets.randbelow returns `values` in turn: r = values[0] + 1, s =
    values[1] + 1 for one proof (the provers draw r, then s)."""
    it = iter(values)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(secrets, "randbelow", lambda n: next(it))
        yield


def bits_key(tmp_path_factory, seed):
    """(cs, x wire, pk, vk, build dir holding circuit_final.zkey and
    verification_key.json)."""
    cs, x = build_bits()
    pk, vk = setup(cs, seed=seed)
    d = tmp_path_factory.mktemp(seed)
    write_zkey(str(d / "circuit_final.zkey"), pk, vk, qap_rows(cs))
    ref_json.dump(ref_json.vkey_to_json(vk), str(d / "verification_key.json"))
    return cs, x, pk, vk, d


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    cs, x, pk, vk, d = bits_key(tmp_path_factory, "cli")
    w = cs.witness([49], {x: 7})
    raw = list(w)
    raw[1] += R  # the public input, unreduced
    raw[x] += 2 * R
    raw[-1] += 5 * R
    raw_wtns(str(d / "raw.wtns"), raw)
    ref_write_wtns(w, str(d / "w.wtns"))
    tr.reset()
    proves = REGISTRY.counter("zkp2p_proves_total", {"prover": "gpu"}).value
    with pinned_randbelow([11, 22]):
        cli.main(["--build-dir", str(d), "prove", "--device", "cpu", "--wtns", str(d / "raw.wtns"),
                  "--proof", str(d / "proof.json"), "--public", str(d / "public.json"),
                  "--trace", str(d / "trace.jsonl")])
    return dict(cs=cs, pk=pk, vk=vk, d=d, w=w, raw=raw, records=tr.records(), arms=audit.gate_arms(),
                proves=REGISTRY.counter("zkp2p_proves_total", {"prover": "gpu"}).value - proves)


def test_prove_writes_the_reference_proof_and_the_raw_public_values(proved, tmp_path):
    d = proved["d"]
    ref_json.dump(ref_json.proof_to_json(prove_host(proved["pk"], proved["cs"], proved["raw"], 12, 23)),
                  str(tmp_path / "proof.json"))
    ref_json.dump(ref_json.public_to_json(proved["raw"][1:2]), str(tmp_path / "public.json"))
    assert (d / "proof.json").read_bytes() == (tmp_path / "proof.json").read_bytes()
    assert (d / "public.json").read_bytes() == (tmp_path / "public.json").read_bytes()
    assert json.loads((d / "public.json").read_text()) == [str(49 + R)]
    # the reference-written (reduced) file gives the prover the same rows
    zk = read_zkey(str(d / "circuit_final.zkey"))
    got, pub = cli._read_witness(str(d / "w.wtns"), zk)
    assert np.array_equal(got, cli._read_witness(str(d / "raw.wtns"), zk)[0]) and pub == [49]


def test_prove_records_its_span_and_arms(proved):
    """One gpu/prove span, the msm arms of the reference's gates, one
    proof counted; on the CPU the memory samples give nothing."""
    assert [r["stage"] for r in proved["records"]] == ["gpu/prove"]
    assert proved["arms"]["msm_affine"] == "off" and proved["arms"]["msm_h"] == "windowed"
    assert proved["proves"] == 1
    assert audit.sample_device_memory("gpu/prove") is None


def test_prove_trace_file_carries_the_manifest_and_the_span(proved):
    """--trace: a manifest line (this process, the gate arms and their
    digest), then the gpu/prove span stamped with the run id and pid."""
    lines = [json.loads(ln) for ln in (proved["d"] / "trace.jsonl").read_text().splitlines()]
    man, recs = lines[0], lines[1:]
    assert man["type"] == "manifest" and man["pid"] == os.getpid() and man["device"] == "cpu"
    assert man["gates"]["msm_affine"] == "off" and man["execution_digest"] == audit.execution_digest(man["gates"])
    assert [(r["stage"], r["run_id"], r["pid"]) for r in recs] == [("gpu/prove", man["run_id"], os.getpid())]
    assert recs[0]["ms"] == proved["records"][0]["ms"]


def _verify(main, d, proof, public):
    with pytest.raises(SystemExit) as e:
        main(["--build-dir", str(d), "verify", "--proof", str(proof), "--public", str(public)])
    return e.value.code


@pytest.mark.parametrize("case,want", [("good", 0), ("public", 1), ("proof", 1)])
def test_verify_exit_codes_match_reference(proved, tmp_path, capsys, case, want):
    d = proved["d"]
    proof, public = json.loads((d / "proof.json").read_text()), json.loads((d / "public.json").read_text())
    if case == "public":
        public[0] = str(int(public[0]) + 1)
    if case == "proof":
        proof["pi_c"] = proof["pi_a"]  # on the curve, the wrong point
    ref_json.dump(proof, str(tmp_path / "p.json"))
    ref_json.dump(public, str(tmp_path / "q.json"))
    got = _verify(cli.main, d, tmp_path / "p.json", tmp_path / "q.json")
    assert capsys.readouterr().out == ("OK\n" if want == 0 else "INVALID\n")
    assert got == _verify(ref_cli.main, d, tmp_path / "p.json", tmp_path / "q.json") == want


def test_wrong_wire_count_exits_with_the_reference_message(proved, tmp_path):
    d = proved["d"]
    short = str(tmp_path / "short.wtns")
    ref_write_wtns(proved["w"][:-1], short)
    argv = ["prove", "--zkey", str(d / "circuit_final.zkey"), "--wtns", short,
            "--proof", str(tmp_path / "p.json"), "--public", str(tmp_path / "q.json")]
    with pytest.raises(SystemExit) as got:
        cli.main([argv[0], "--device", "cpu"] + argv[1:])
    with pytest.raises(SystemExit) as want:
        ref_cli.main(argv)
    assert got.value.code == want.value.code == f"witness has {len(proved['w']) - 1} wires, zkey expects 11"
    assert not os.path.exists(tmp_path / "p.json")


def test_zkey_chunk_glob_reads_the_chunks_in_order(proved, tmp_path):
    src = str(tmp_path / "k.zkey")
    (tmp_path / "k.zkey").write_bytes((proved["d"] / "circuit_final.zkey").read_bytes())
    chunks = split_zkey(src, n_chunks=4)
    os.remove(src)
    got = cli._load_zkey(argparse.Namespace(zkey=str(tmp_path / "k.zkey*"), build_dir="unused"))
    want = read_zkey(str(proved["d"] / "circuit_final.zkey"))
    assert sorted(glob.glob(str(tmp_path / "k.zkey*"))) == chunks
    for name in ("coeff_value", "coeff_row"):
        assert np.array_equal(getattr(got, name), getattr(want, name))
    assert all(np.array_equal(a, b) for a, b in zip(got.h_query, want.h_query))
    with pytest.raises(SystemExit, match="no zkey matches"):
        cli._load_zkey(argparse.Namespace(zkey=str(tmp_path / "none*"), build_dir="unused"))


@pytest.mark.slow
@pytest.mark.xslow
def test_prove_matches_the_reference_cli_prove_tpu(proved, tmp_path):
    """The reference CLI's own drop-in route (prove --wtns through
    prove_tpu) on the same files and r, s writes the same two files."""
    d = proved["d"]
    with pinned_randbelow([11, 22]):
        ref_cli.main(["--build-dir", str(d), "prove", "--wtns", str(d / "raw.wtns"),
                      "--proof", str(tmp_path / "proof.json"), "--public", str(tmp_path / "public.json")])
    assert (d / "proof.json").read_bytes() == (tmp_path / "proof.json").read_bytes()
    assert (d / "public.json").read_bytes() == (tmp_path / "public.json").read_bytes()
