"""The port's prover (zkp2p_tpu_torch.prover) against the reference.

prove_gpu(..., device="cpu") runs every kernel's plain version and must
give the host oracle's proof byte for byte for the same (witness, r, s),
on the toy, wide and width-classed circuits of test_prover_tpu.py, with
the witness as ints and as (n, 4) u64 rows.  The key crosses from the
JAX package through key_from_numpy, as numpy arrays."""

import random
import zlib

import numpy as np
import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.gadgets.core import bits2num, num2bits
from zkp2p_tpu.prover.groth16_tpu import _DPK_ARRAY_FIELDS, device_pk
from zkp2p_tpu.snark.groth16 import Proof as JProof
from zkp2p_tpu.snark.groth16 import coset_gen as ref_coset_gen
from zkp2p_tpu.snark.groth16 import domain_size_for as ref_domain_size_for
from zkp2p_tpu.snark.groth16 import prove_host, qap_rows, setup, verify
from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem
from zkp2p_tpu.field.tower import Fq2 as JFq2

from zkp2p_tpu_torch.prover.groth16_gpu import DPK_ARRAY_FIELDS, key_from_numpy, prove_gpu
from zkp2p_tpu_torch.snark.groth16 import coset_gen, domain_size_for, proof_bytes

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


def jax_key_to_numpy(dpk):
    """A JAX DeviceProvingKey -> (arrays, meta) as key_from_numpy takes them."""
    arrays = {k: np.asarray(getattr(dpk, k)) for k in _DPK_ARRAY_FIELDS}

    def g2(p):
        return None if p is None else tuple((c.c0, c.c1) for c in p)

    meta = dict(
        n_public=dpk.n_public, n_wires=dpk.n_wires, log_m=dpk.log_m,
        alpha_1=dpk.alpha_1, beta_1=dpk.beta_1, beta_2=g2(dpk.beta_2),
        delta_1=dpk.delta_1, delta_2=g2(dpk.delta_2),
        inferred_narrow_wires=dpk.inferred_narrow_wires,
    )
    return arrays, meta


def as_reference_proof(p):
    """A port proof as the reference's Proof type (for its verifier)."""
    b = None if p.b is None else tuple(JFq2(c.c0, c.c1) for c in p.b)
    return JProof(a=p.a, b=b, c=p.c)


def u64_rows(witness):
    buf = b"".join(int(v % R).to_bytes(32, "little") for v in witness)
    return np.frombuffer(buf, dtype="<u8").reshape(len(witness), 4).copy()


def build_toy():
    cs = ConstraintSystem("toy")
    out = cs.new_public("out")
    x = cs.new_wire("x")
    y = cs.new_wire("y")
    z = cs.new_wire("z")
    cs.enforce(LC.of(x), LC.of(y), LC.of(z), "mul")
    cs.enforce(LC.of(z), LC.of(z), LC.of(out), "sq")
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    return cs, cs.witness([225], {x: 3, y: 5}), [225]


def build_wide():
    cs = ConstraintSystem("wide")
    pub_a = cs.new_public("a")
    pub_b = cs.new_public("b")
    wires = [pub_a, pub_b]
    for i in range(12):
        u, v = wires[-2], wires[-1]
        w = cs.new_wire(f"w{i}")
        cs.enforce(LC.of(u) + LC.of(v) * 3 + LC.const(i + 1), LC.of(v) + LC.const(2), LC.of(w))
        cs.compute(w, lambda x, y, k=i: (x + 3 * y + k + 1) * (y + 2) % R, [u, v])
        wires.append(w)
    return cs, cs.witness([7, 11], {}), [7, 11]


def build_classed():
    cs = ConstraintSystem("classed")
    out = cs.new_public("out")
    x = cs.new_wire("x")
    bits = num2bits(cs, x, 16, "xb")
    y = bits2num(cs, bits[:8], "ylow")
    z = cs.new_wire("z")
    cs.enforce(LC.of(y), LC.of(x), LC.of(z), "mul")
    cs.enforce(LC.of(z) + LC.const(3), LC.of(z), LC.of(out), "fin")
    cs.compute(z, lambda a, b: a * b % R, [y, x])
    cs.compute(out, lambda a: (a + 3) * a % R, [z])
    xv = 0xBEEF
    zv = (xv & 0xFF) * xv
    pub = [(zv + 3) * zv % R]
    return cs, cs.witness(pub, {x: xv}), pub


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("build", [build_toy, build_wide, build_classed], ids=["toy", "wide", "classed"])
@pytest.mark.parametrize("form", ["ints", "u64"])
def test_prove_gpu_cpu_matches_host(build, form):
    cs, w, pub = build()
    pk, vk = setup(cs)
    dpk = device_pk(pk, cs)
    if build is build_classed:  # both width classes must be live
        assert int(dpk.a_nsel.shape[0]) > 16 and int(dpk.a_wsel.shape[0]) >= 2
    key = key_from_numpy(*jax_key_to_numpy(dpk), device="cpu")
    rng = random.Random(zlib.crc32(f"{build.__name__}/{form}".encode()))
    r, s = rng.randrange(1, R), rng.randrange(1, R)
    witness = w if form == "ints" else u64_rows(w)
    got = prove_gpu(key, witness, r=r, s=s, device="cpu")
    want = prove_host(pk, cs, w, r=r, s=s)
    assert proof_bytes(got) == proof_bytes(want)
    assert verify(vk, as_reference_proof(got), pub)


def test_key_from_numpy_carries_every_array():
    cs, _, _ = build_classed()
    pk, _ = setup(cs)
    dpk = device_pk(pk, cs)
    arrays, meta = jax_key_to_numpy(dpk)
    key = key_from_numpy(arrays, meta, device="cpu")
    assert set(DPK_ARRAY_FIELDS) == set(_DPK_ARRAY_FIELDS)
    for name in DPK_ARRAY_FIELDS:
        got = getattr(key, name)
        got = np.stack([c.numpy() for c in got]) if isinstance(got, tuple) else got.numpy()
        assert np.array_equal(got.astype(np.int64), arrays[name].astype(np.int64)), name
    assert (key.n_public, key.n_wires, key.log_m) == (dpk.n_public, dpk.n_wires, dpk.log_m)
    assert domain_size_for(len(qap_rows(cs))) == ref_domain_size_for(cs) == 1 << dpk.log_m
    assert coset_gen(dpk.log_m) == ref_coset_gen(dpk.log_m)
    assert (key.alpha_1, key.beta_1, key.delta_1) == (dpk.alpha_1, dpk.beta_1, dpk.delta_1)
    for mine, ref in ((key.beta_2, dpk.beta_2), (key.delta_2, dpk.delta_2)):
        assert [(c.c0, c.c1) for c in mine] == [(c.c0, c.c1) for c in ref]


def test_unreduced_u64_witness_is_rejected():
    cs, w, _ = build_toy()
    pk, _ = setup(cs)
    key = key_from_numpy(*jax_key_to_numpy(device_pk(pk, cs)), device="cpu")
    rows = u64_rows(w)
    rows[2] = np.frombuffer(R.to_bytes(32, "little"), dtype="<u8")
    with pytest.raises(ValueError, match="not reduced"):
        prove_gpu(key, rows, r=1, s=1, device="cpu")


@pytest.mark.slow
@pytest.mark.xslow
@pytest.mark.parametrize("build", [build_toy, build_classed], ids=["toy", "classed"])
def test_prove_gpu_cpu_matches_prove_tpu(build):
    from zkp2p_tpu.prover import prove_tpu

    cs, w, _ = build()
    pk, _ = setup(cs)
    dpk = device_pk(pk, cs)
    key = key_from_numpy(*jax_key_to_numpy(dpk), device="cpu")
    r, s = 0x1234567, 0x7654321
    assert proof_bytes(prove_gpu(key, w, r=r, s=s, device="cpu")) == proof_bytes(prove_tpu(dpk, w, r=r, s=s))
