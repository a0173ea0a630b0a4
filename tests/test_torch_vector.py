"""The port's committed test vector (zkp2p_tpu_torch/data/port_vector.npz,
the input of chip_smoke.py's end-to-end check on the card).

The vector is rebuilt here from its circuit with the reference package
(setup, prove_host, verify), so it cannot drift, and the port on the CPU
must reproduce its proof byte for byte.  Write it anew with
`python tests/test_torch_vector.py --write-vector`."""

import random
import sys

import numpy as np
import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.gadgets.core import bits2num, num2bits
from zkp2p_tpu.prover.groth16_tpu import device_pk
from zkp2p_tpu.snark.groth16 import prove_host, setup, verify
from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem

from test_torch_prover import jax_key_to_numpy, u64_rows
from zkp2p_tpu_torch.prover.groth16_gpu import DPK_ARRAY_FIELDS, key_from_numpy, prove_gpu
from zkp2p_tpu_torch.prover.vector import VECTOR_PATH, load_vector, save_vector
from zkp2p_tpu_torch.snark.groth16 import proof_bytes

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


def build_vector_circuit():
    """Public inputs, narrow (bit and byte) wires, wide wires and products,
    over a 2^11 domain: every MSM of the proof takes several lane steps."""
    cs = ConstraintSystem("port_vector")
    pubs = [cs.new_public(f"p{i}") for i in range(3)]
    xs = [cs.new_wire(f"x{k}") for k in range(40)]
    lows = []
    for k, x in enumerate(xs):
        bits = num2bits(cs, x, 24, f"x{k}b")
        lows.append(bits2num(cs, bits[:8], f"x{k}lo"))
    prods = []
    for k in range(39):
        z = cs.new_wire(f"z{k}")
        cs.enforce(LC.of(xs[k]), LC.of(xs[k + 1]) + LC.of(lows[k]), LC.of(z), f"mul{k}")
        cs.compute(z, lambda a, b, c: a * (b + c) % R, [xs[k], xs[k + 1], lows[k]])
        prods.append(z)
    cs.enforce(LC.of(prods[0]), LC.of(prods[1]), LC.of(pubs[0]), "pub0")
    cs.enforce(LC.of(prods[2]) + LC.of(xs[3]), LC.const(1), LC.of(pubs[1]), "pub1")
    acc = LC.of(lows[0])
    for lo in lows[1:]:
        acc = acc + LC.of(lo)
    cs.enforce(acc, LC.const(1), LC.of(pubs[2]), "pub2")

    rng = random.Random(20261017)
    vals = {x: rng.randrange(1 << 24) for x in xs}
    xv = [vals[x] for x in xs]
    lo = [v & 0xFF for v in xv]
    z = [xv[k] * (xv[k + 1] + lo[k]) % R for k in range(39)]
    pub = [z[0] * z[1] % R, (z[2] + xv[3]) % R, sum(lo) % R]
    witness = cs.witness(pub, vals)
    r, s = rng.randrange(1, R), rng.randrange(1, R)
    return cs, witness, pub, r, s


def rebuild_vector():
    """-> (arrays, meta, witness u64, r, s, proof, pk, vk, public)."""
    cs, witness, pub, r, s = build_vector_circuit()
    cs.check_witness(witness)
    pk, vk = setup(cs, seed="port-vector")
    proof = prove_host(pk, cs, witness, r=r, s=s)
    arrays, meta = jax_key_to_numpy(device_pk(pk, cs))
    return arrays, meta, u64_rows(witness), r, s, proof, vk, pub


@pytest.fixture(scope="module")
def rebuilt_vector():
    return rebuild_vector()


def test_committed_vector_matches_its_circuit(rebuilt_vector):
    arrays, meta, witness, r, s, proof, vk, pub = rebuilt_vector
    assert verify(vk, proof, pub)
    c_arrays, c_meta, c_witness, c_r, c_s, c_proof = load_vector(VECTOR_PATH)
    for name in DPK_ARRAY_FIELDS:
        assert np.array_equal(c_arrays[name].astype(np.int64), arrays[name].astype(np.int64)), name
    for k in ("n_public", "n_wires", "log_m", "alpha_1", "beta_1", "delta_1", "inferred_narrow_wires"):
        assert c_meta[k] == meta[k], k
    for k in ("beta_2", "delta_2"):
        assert [(c.c0, c.c1) for c in c_meta[k]] == [tuple(v) for v in meta[k]], k
    assert np.array_equal(c_witness, witness)
    assert (c_r, c_s) == (r, s)
    assert proof_bytes(c_proof) == proof_bytes(proof)
    # every MSM takes several lane steps, and both width classes are live
    assert meta["log_m"] == 11 and len(arrays["a_nsel"]) > 900 and len(arrays["a_wsel"]) >= 80


def test_prove_gpu_cpu_reproduces_committed_vector():
    arrays, meta, witness, r, s, proof = load_vector(VECTOR_PATH)
    key = key_from_numpy(arrays, meta, device="cpu")
    got = prove_gpu(key, witness, r=r, s=s, device="cpu")
    assert proof_bytes(got) == proof_bytes(proof)


if __name__ == "__main__" and "--write-vector" in sys.argv:
    arrays, meta, witness, r, s, proof, vk, pub = rebuild_vector()
    assert verify(vk, proof, pub)
    save_vector(VECTOR_PATH, arrays, meta, witness, r, s, proof)
    print(f"wrote {VECTOR_PATH}")
