"""The port's ``batch`` command (python -m zkp2p_tpu_torch batch) on the
CPU: three .wtns files at chunk 2 (two chunks, the second padded) give
<name>.proof.json and <name>.public.json equal, byte for byte, to the
reference's ``dump(proof_to_json(prove_host(...)))`` for each witness's
r and s, unreduced values included; the run records one gpu/prove_batch
span, the three arms and three proofs, and its --trace file holds the
span after a manifest line.  Apart from test_torch_cli.py so
that the test runner's workers prove the two files in parallel (each
chunk costs about one CPU proof, ~40 s)."""

import json

import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.formats import proof_json as ref_json
from zkp2p_tpu.formats.circom_bin import write_wtns as ref_write_wtns
from zkp2p_tpu.snark.groth16 import prove_host

from test_torch_cli import bits_key, pinned_randbelow, raw_wtns
from zkp2p_tpu_torch.pipeline import cli
from zkp2p_tpu_torch.utils import audit
from zkp2p_tpu_torch.utils import trace as tr
from zkp2p_tpu_torch.utils.metrics import REGISTRY

torch.set_num_threads(1)

XS = {"a": 7, "b": 200, "c": 3}
DRAWS = [11, 22, 33, 44, 55, 66]  # r - 1, s - 1 for a, b, c in turn


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    cs, x, pk, vk, d = bits_key(tmp_path_factory, "cli-batch")
    indir, outdir = d / "in", d / "out"
    indir.mkdir()
    wits = {k: cs.witness([v * v], {x: v}) for k, v in XS.items()}
    ref_write_wtns(wits["a"], str(indir / "a.wtns"))
    ref_write_wtns(wits["b"], str(indir / "b.wtns"))
    raw_c = list(wits["c"])
    raw_c[1] += R
    raw_c[x] += 3 * R
    raw_wtns(str(indir / "c.wtns"), raw_c)
    (indir / "ignored.json").write_text("{}")
    tr.reset()
    proves = REGISTRY.counter("zkp2p_proves_total", {"prover": "gpu"}).value
    with pinned_randbelow(DRAWS):
        cli.main(["--build-dir", str(d), "batch", "--device", "cpu", "--indir", str(indir),
                  "--outdir", str(outdir), "--chunk", "2", "--trace", str(d / "trace.jsonl")])
    return dict(cs=cs, pk=pk, outdir=outdir, trace_file=d / "trace.jsonl", wits=dict(wits, c=raw_c), records=tr.records(),
                arms=audit.gate_arms(),
                proves=REGISTRY.counter("zkp2p_proves_total", {"prover": "gpu"}).value - proves)


@pytest.mark.parametrize("i,name", list(enumerate(XS)))
def test_batch_files_match_reference(batch, tmp_path, i, name):
    w = batch["wits"][name]
    r, s = DRAWS[2 * i] + 1, DRAWS[2 * i + 1] + 1
    ref_json.dump(ref_json.proof_to_json(prove_host(batch["pk"], batch["cs"], w, r, s)), str(tmp_path / "p.json"))
    ref_json.dump(ref_json.public_to_json(w[1:2]), str(tmp_path / "q.json"))
    out = batch["outdir"]
    assert (out / f"{name}.proof.json").read_bytes() == (tmp_path / "p.json").read_bytes()
    assert (out / f"{name}.public.json").read_bytes() == (tmp_path / "q.json").read_bytes()


def test_batch_records_its_span_and_arms(batch):
    assert sorted(p.name for p in batch["outdir"].iterdir()) == sorted(
        f"{k}.{kind}.json" for k in XS for kind in ("proof", "public"))
    assert json.loads((batch["outdir"] / "c.public.json").read_text()) == [str(9 + R)]
    assert batch["records"] == [{"stage": "gpu/prove_batch", "ms": batch["records"][0]["ms"], "n": 3}]
    assert {k: batch["arms"][k] for k in ("batch_chunk", "msm_affine", "msm_h")} == {
        "batch_chunk": "2", "msm_affine": "off", "msm_h": "windowed"}
    assert batch["proves"] == 3


def test_batch_trace_file_carries_the_manifest_and_the_span(batch):
    lines = [json.loads(ln) for ln in batch["trace_file"].read_text().splitlines()]
    assert lines[0]["type"] == "manifest" and lines[0]["gates"]["batch_chunk"] == "2"
    assert [(r["stage"], r["n"], r["ms"]) for r in lines[1:]] == [
        ("gpu/prove_batch", 3, batch["records"][0]["ms"])]


def test_batch_without_inputs_exits(tmp_path):
    with pytest.raises(SystemExit, match="no \\*.wtns inputs"):
        cli.main(["batch", "--device", "cpu", "--indir", str(tmp_path), "--outdir", str(tmp_path / "o")])
