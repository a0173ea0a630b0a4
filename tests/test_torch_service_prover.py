"""The port's service with its default prover, ``prove_gpu_batch``, on the
CPU (device="cpu": the plain versions of the kernels): two requests
through the batched witness path in one batch, one chunk of 2, the
draws pinned as tests/test_torch_cli.py pins them.  Each .proof.json
and .public.json equals the reference's ``dump(proof_to_json(
prove_host(...)))`` for the same witness and (r, s), byte for byte.  One
CPU proof costs about 40 s of plain point operations."""

import json
import os

import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.formats import proof_json as ref_json
from zkp2p_tpu.snark.groth16 import prove_host

from test_torch_cli import pinned_randbelow
from test_torch_service import PortCS, PortLC, RefCS, RefLC, build_cs, port_vk, ref_setup, write_reqs
from zkp2p_tpu_torch.pipeline.service import ProvingService
from zkp2p_tpu_torch.prover.groth16_gpu import device_pk
from zkp2p_tpu_torch.utils import trace as tr

# one process a core: torch's intra-op threads would oversubscribe them
torch.set_num_threads(1)

PAIRS = [(3, 5), (2, 7)]
DRAWS = [11, 22, 33, 44]  # r then s, a witness at a time: (12, 23), (34, 45)


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    ref_cs, _, _ = build_cs(RefCS, RefLC)
    pk, vk = ref_setup(ref_cs, seed="svc-prover")
    cs, x, y = build_cs(PortCS, PortLC)

    def inputs_fn(payload):
        xv, yv = int(payload["x"]), int(payload["y"])
        return [pow(xv * yv, 2, R)], {x: xv, y: yv}

    def witness_fn(payload):
        return cs.witness(*inputs_fn(payload))

    svc = ProvingService(cs, device_pk(pk, cs, device="cpu"), port_vk(vk), witness_fn, lambda w: [w[1]],
                         batch_size=2, inputs_fn=inputs_fn, device="cpu", cache_dir=None)
    spool = str(tmp_path_factory.mktemp("svc-prover") / "spool")
    os.makedirs(spool)
    write_reqs(spool, PAIRS)
    tr.reset()
    with pinned_randbelow(DRAWS):
        stats = svc.process_dir(spool)
    return dict(stats=stats, spool=spool, ref_cs=ref_cs, pk=pk, cs=cs, records=tr.records())


def test_default_prover_files_equal_the_reference(swept, tmp_path):
    assert swept["stats"]["done"] == 2 and sum(swept["stats"].values()) == 2
    for i, (xv, yv) in enumerate(PAIRS):
        w = swept["cs"].witness([pow(xv * yv, 2, R)], {2: xv, 3: yv})
        proof = prove_host(swept["pk"], swept["ref_cs"], list(w), DRAWS[2 * i] + 1, DRAWS[2 * i + 1] + 1)
        ref_json.dump(ref_json.proof_to_json(proof), str(tmp_path / f"r{i}.proof.json"))
        ref_json.dump(ref_json.public_to_json([w[1]]), str(tmp_path / f"r{i}.public.json"))
        for ext in ("proof.json", "public.json"):
            with open(os.path.join(swept["spool"], f"r{i}.{ext}"), "rb") as f:
                assert f.read() == (tmp_path / f"r{i}.{ext}").read_bytes(), f"r{i}.{ext}"


def test_default_prover_runs_one_batch_and_records_it(swept):
    spans = [r for r in swept["records"] if r["stage"].startswith("service/")]
    assert [r["stage"] for r in spans if r["stage"] in ("service/witness_batch", "service/prove")] == [
        "service/witness_batch", "service/prove"]
    # one prove_gpu_batch call, inside the service's prove span
    assert [r["stage"] for r in swept["records"] if r["stage"].endswith("gpu/prove_batch")] == [
        "service/prove/gpu/prove_batch"]
    with open(swept["spool"] + ".metrics.jsonl") as f:
        recs = [r for r in map(json.loads, f) if r.get("type") == "request"]
    assert sorted((r["request_id"], r["batch_index"], r["batch_n"]) for r in recs) == [("r0", 0, 2), ("r1", 1, 2)]
    # on the CPU no device memory is sampled
    assert all(r["state"] == "done" and "hbm_peak_bytes" not in r for r in recs)
    assert not [f for f in os.listdir(swept["spool"]) if f.endswith(".claim")]
