"""The port's prover under its two off-default MSM arms against the
reference: prove_gpu(..., device="cpu", msm_affine=True) (the batch-affine
accumulate, the reference's ZKP2P_MSM_AFFINE=1) and msm_h="bucket" (the
sorted-prefix bucket h MSM at w=16, ZKP2P_MSM_H=bucket), alone and
together.  A Groth16 proof is fixed by (witness, r, s), whatever the arm:
every proof must equal prove_host's byte for byte and verify, on the
toy, wide and width-classed circuits of test_torch_prover.py, on a
circuit whose narrow class has 3 digit planes (so the batch inversion
pads) and on the committed test vector.

On the CPU every batch inversion is a 363-product plain ladder and the
w=16 bucket MSM takes about 16 * (2 log2 m + 16) of them, some minutes a
proof: the bucket arm runs in tier 1 on the toy circuit (with the
affine arm), and on the others in the slow tier.  Those cases are in
test_torch_prover_bucket.py, so that the two files run in parallel."""

import random
import zlib

import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.prover.groth16_tpu import device_pk
from zkp2p_tpu.snark.groth16 import prove_host, setup, verify
from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem

from test_torch_prover import as_reference_proof, build_classed, build_toy, build_wide, jax_key_to_numpy
from zkp2p_tpu_torch.prover.groth16_gpu import key_from_numpy, prove_gpu
from zkp2p_tpu_torch.prover.vector import VECTOR_PATH, load_vector
from zkp2p_tpu_torch.snark.groth16 import proof_bytes

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

ARMS = {
    "affine": dict(msm_affine=True),
    "bucket": dict(msm_h="bucket"),
    "both": dict(msm_affine=True, msm_h="bucket"),
}


def build_narrow():
    """Two private wires tagged 8 bits wide: the key gets a narrow class
    beside the wide one, whose 3-plane MSMs pad the batch inversion."""
    cs = ConstraintSystem("narrow_affine")
    out = cs.new_public("out")
    x, y, z = cs.new_wire(), cs.new_wire(), cs.new_wire()
    cs.enforce(LC.of(x), LC.of(y), LC.of(z))
    cs.enforce(LC.of(z), LC.of(z), LC.of(out))
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    cs.set_width(x, 8)
    cs.set_width(y, 8)
    return cs, cs.witness([225], {x: 3, y: 5}), [225]


BUILDS = {"toy": build_toy, "wide": build_wide, "classed": build_classed, "narrow": build_narrow}


def check_arm(circuit, arm):
    """prove_gpu under `arm` on the CPU equals prove_host and verifies."""
    cs, w, pub = BUILDS[circuit]()
    pk, vk = setup(cs)
    dpk = device_pk(pk, cs)
    if circuit == "narrow":
        assert int(dpk.a_nsel.shape[0]) > 0, "the key must have a narrow class"
    key = key_from_numpy(*jax_key_to_numpy(dpk), device="cpu")
    rng = random.Random(zlib.crc32(f"{circuit}/{arm}".encode()))
    r, s = rng.randrange(1, R), rng.randrange(1, R)
    got = prove_gpu(key, w, r=r, s=s, device="cpu", **ARMS[arm])
    assert proof_bytes(got) == proof_bytes(prove_host(pk, cs, w, r=r, s=s))
    assert verify(vk, as_reference_proof(got), pub)


@pytest.mark.parametrize("circuit", list(BUILDS))
def test_prove_gpu_affine_arm_matches_host(circuit):
    check_arm(circuit, "affine")


@pytest.mark.slow
@pytest.mark.parametrize("arm", list(ARMS))
def test_prove_gpu_arm_reproduces_committed_vector(arm):
    arrays, meta, witness, r, s, proof = load_vector(VECTOR_PATH)
    key = key_from_numpy(arrays, meta, device="cpu")
    got = prove_gpu(key, witness, r=r, s=s, device="cpu", **ARMS[arm])
    assert proof_bytes(got) == proof_bytes(proof)


def test_unknown_arm_values_raise():
    cs, w, _ = build_toy()
    pk, _ = setup(cs)
    key = key_from_numpy(*jax_key_to_numpy(device_pk(pk, cs)), device="cpu")
    for kw in (dict(msm_h="auto"), dict(msm_h="Bucket"), dict(msm_h=None), dict(msm_affine="1"),
               dict(msm_affine="auto"), dict(msm_affine=1)):
        with pytest.raises(ValueError, match="msm_"):
            prove_gpu(key, w, r=1, s=1, device="cpu", **kw)


@pytest.mark.slow
@pytest.mark.xslow
@pytest.mark.parametrize("arm", list(ARMS))
def test_prove_gpu_arm_matches_prove_tpu(arm, monkeypatch):
    """The same arm armed in the reference through its knobs."""
    import zkp2p_tpu.prover.groth16_tpu as gt
    from zkp2p_tpu.prover import prove_tpu

    if "msm_affine" in ARMS[arm]:
        monkeypatch.setattr(gt, "MSM_AFFINE", "1")
    if "msm_h" in ARMS[arm]:
        monkeypatch.setattr(gt, "MSM_H", "bucket")
        # K = 8 buckets keep the reference's XLA compile small on the CPU,
        # as in its own test; the proof does not depend on the window
        monkeypatch.setattr(gt, "H_BUCKET_WINDOW", 4)
    cs, w, _ = build_classed()
    pk, _ = setup(cs)
    dpk = device_pk(pk, cs)
    key = key_from_numpy(*jax_key_to_numpy(dpk), device="cpu")
    r, s = 0x1234567, 0x7654321
    want = prove_tpu(dpk, w, r=r, s=s)
    assert proof_bytes(prove_gpu(key, w, r=r, s=s, device="cpu", **ARMS[arm])) == proof_bytes(want)
