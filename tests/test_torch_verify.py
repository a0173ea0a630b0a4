"""The port's verifier (zkp2p_tpu_torch.snark.groth16.verify, over its
own host pairing) against the reference's, and a proof of the port's
prover under a key the port set up itself, on the CPU.

The proof from prove_gpu under setup_device's key equals prove_host's
under the reference's key, byte for byte, and both verifiers accept it;
on the verify skill's probes (a wrong public input, a tampered point, a
wrong arity, a key from another seed) both reject it."""

import pytest
import torch

from zkp2p_tpu.curve.host import G1_GENERATOR, g1_add
from zkp2p_tpu.snark.groth16 import VerifyingKey as RefVerifyingKey
from zkp2p_tpu.snark.groth16 import prove_host, setup
from zkp2p_tpu.snark.groth16 import verify as ref_verify

from test_torch_prover import as_reference_proof, u64_rows
from test_torch_setup import build_demo, port_vk, ref_g2
from zkp2p_tpu_torch.prover.groth16_gpu import prove_gpu
from zkp2p_tpu_torch.prover.setup_device import setup_device
from zkp2p_tpu_torch.snark.groth16 import Proof, proof_bytes, verify

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

R_S = (0x1234567, 0x7654321)


@pytest.fixture(scope="module")
def demo():
    cs, witness, pub = build_demo()
    key, vk = setup_device(cs, device="cpu")
    proof = prove_gpu(key, u64_rows(witness), r=R_S[0], s=R_S[1], device="cpu")
    return cs, witness, pub, key, vk, proof


def test_port_proof_under_port_key_equals_prove_host_and_verifies(demo):
    cs, witness, pub, key, vk, proof = demo
    pk, rvk = setup(cs)
    want = prove_host(pk, cs, witness, r=R_S[0], s=R_S[1])
    assert proof_bytes(proof) == proof_bytes(want)
    assert verify(vk, proof, pub)
    assert ref_verify(rvk, as_reference_proof(proof), pub)
    assert verify(port_vk(rvk), proof, pub)


def _probe(name, cs, pub, vk, proof):
    """(vk, proof, public inputs) of one probe, with the port's types."""
    if name == "wrong public input":
        return vk, proof, [pub[0] + 1]
    if name == "tampered point":
        return vk, Proof(a=g1_add(proof.a, G1_GENERATOR), b=proof.b, c=proof.c), pub
    if name == "wrong arity":
        return vk, proof, pub + [0]
    if name == "other seed":
        return port_vk(setup(cs, seed="another")[1]), proof, pub
    if name == "B off the twist":
        x, y = proof.b
        return vk, Proof(a=proof.a, b=(x, y + y), c=proof.c), pub
    raise AssertionError(name)


@pytest.mark.parametrize("probe", ["wrong public input", "tampered point", "wrong arity", "other seed",
                                   "B off the twist"])
def test_verify_agrees_with_reference_on_probes(demo, probe):
    cs, _, pub, _, vk, proof = demo
    pvk, pproof, ppub = _probe(probe, cs, pub, vk, proof)
    assert verify(pvk, pproof, ppub) is False
    rvk = RefVerifyingKey(n_public=pvk.n_public, alpha_1=pvk.alpha_1, beta_2=ref_g2(pvk.beta_2),
                          gamma_2=ref_g2(pvk.gamma_2), delta_2=ref_g2(pvk.delta_2), ic=list(pvk.ic))
    assert ref_verify(rvk, as_reference_proof(pproof), ppub) is False
