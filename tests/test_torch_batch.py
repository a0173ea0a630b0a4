"""The port's batch prover (zkp2p_tpu_torch.prover.groth16_gpu.
prove_gpu_batch) against the reference.

prove_gpu_batch(..., device="cpu") runs the whole pipeline over a leading
batch axis of witnesses with every kernel's plain version.  Five distinct
witnesses of the toy, wide and width-classed circuits of
test_torch_prover.py, as ints and as (n, 4) u64 rows, at chunk=2 (three
chunks, the last padded by repeating its final witness) and chunk=0 (one
chunk of five), with explicit (r, s): every proof must equal prove_gpu's
and the host oracle's (prove_host) byte for byte.  The wide and classed
circuits' cases are in test_torch_batch_wide.py and
test_torch_batch_classed.py, so that the three files run in parallel (a
CPU proof costs some 20 s of plain point operations, mostly in the
MSMs' Horner folds, whatever the batch).  Here also: the default (r, s)
give proofs that verify, the chunk rule against the reference's, the
batched Kogge-Stone recode against the JAX recode under vmap, the
argument checks, and, in the slow tier, the batched accumulators and the
proofs against the reference's own batch prover."""

import dataclasses
import random
import zlib
from functools import lru_cache
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.gadgets.core import bits2num, num2bits
from zkp2p_tpu.ops import msm as jmsm
from zkp2p_tpu.prover.groth16_tpu import device_pk
from zkp2p_tpu.snark.groth16 import prove_host, setup, verify
from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem

from test_torch_prover import as_reference_proof, jax_key_to_numpy, u64_rows
from zkp2p_tpu_torch.ops import msm
from zkp2p_tpu_torch.prover import groth16_gpu as gp
from zkp2p_tpu_torch.prover.groth16_gpu import batch_spans, key_from_numpy, prove_gpu, prove_gpu_batch
from zkp2p_tpu_torch.snark.groth16 import proof_bytes

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

N_WITNESSES = 5


# ------------------------------------------------------------ the circuits
# test_torch_prover.py's three circuits, each with N_WITNESSES witnesses:
# (cs, [(witness, public inputs)]).


def toy_circuit():
    cs = ConstraintSystem("toy")
    out = cs.new_public("out")
    x = cs.new_wire("x")
    y = cs.new_wire("y")
    z = cs.new_wire("z")
    cs.enforce(LC.of(x), LC.of(y), LC.of(z), "mul")
    cs.enforce(LC.of(z), LC.of(z), LC.of(out), "sq")
    cs.compute(z, lambda a, b: a * b % R, [x, y])

    def wit(i):
        a, b = 3 + 2 * i, R - 5 - 7 * i
        pub = [(a * b) ** 2 % R]
        return cs.witness(pub, {x: a, y: b}), pub

    return cs, [wit(i) for i in range(N_WITNESSES)]


def wide_circuit():
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

    def wit(i):
        pub = [7 + 13 * i, R - 11 - i]
        return cs.witness(pub, {}), pub

    return cs, [wit(i) for i in range(N_WITNESSES)]


def classed_circuit():
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

    def wit(i):
        xv = (0xBEEF + 0x1357 * i) & 0xFFFF
        zv = (xv & 0xFF) * xv
        pub = [(zv + 3) * zv % R]
        return cs.witness(pub, {x: xv}), pub

    return cs, [wit(i) for i in range(N_WITNESSES)]


CIRCUITS = {"toy": toy_circuit, "wide": wide_circuit, "classed": classed_circuit}


@lru_cache(maxsize=None)
def circuit_case(name):
    """The circuit's key on the CPU, its witnesses, explicit (r, s) pairs
    and the bytes of prove_gpu's and prove_host's proof of each witness
    (built once a process: a CPU proof takes some 20 s)."""
    cs, wits = CIRCUITS[name]()
    pk, vk = setup(cs)
    dpk = device_pk(pk, cs)
    key = key_from_numpy(*jax_key_to_numpy(dpk), device="cpu")
    rng = random.Random(zlib.crc32(f"batch/{name}".encode()))
    rs = [(rng.randrange(1, R), rng.randrange(1, R)) for _ in wits]
    single = [proof_bytes(prove_gpu(key, w, r=r, s=s, device="cpu")) for (w, _), (r, s) in zip(wits, rs)]
    host = [proof_bytes(prove_host(pk, cs, w, r=r, s=s)) for (w, _), (r, s) in zip(wits, rs)]
    return SimpleNamespace(cs=cs, pk=pk, vk=vk, dpk=dpk, key=key, wits=[w for w, _ in wits],
                           pubs=[p for _, p in wits], rs=rs, single=single, host=host)


def check_batch(name, form, chunk):
    """prove_gpu_batch of the circuit's witnesses in `form` at `chunk`:
    one proof a witness, each equal to prove_gpu's and prove_host's."""
    c = circuit_case(name)
    ws = c.wits if form == "ints" else [u64_rows(w) for w in c.wits]
    stages = {}
    proofs = prove_gpu_batch(c.key, ws, rs=c.rs, chunk=chunk, device="cpu", stages=stages)
    assert [proof_bytes(p) for p in proofs] == c.single == c.host
    assert len(set(c.host)) == N_WITNESSES  # five distinct proofs
    assert len(stages["chunks"]) == len(batch_spans(N_WITNESSES, chunk)) == (3 if chunk == 2 else 1)
    assert all({"s_witness", "s_matvec", "s_ntt", "s_planes", "s_msm_h", "s_assemble"} <= set(st)
               for st in stages["chunks"])
    assert len(stages["acc"]) == N_WITNESSES


BATCH_CASES = [("ints", 2), ("ints", 0), ("u64", 2), ("u64", 0)]
BATCH_IDS = [f"{form}-chunk{chunk}" for form, chunk in BATCH_CASES]


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("form,chunk", BATCH_CASES, ids=BATCH_IDS)
def test_prove_gpu_batch_toy_matches_prove_gpu_and_host(form, chunk):
    check_batch("toy", form, chunk)


def test_prove_gpu_batch_default_rs_verify():
    c = circuit_case("toy")
    proofs = prove_gpu_batch(c.key, c.wits, chunk=0, device="cpu")
    assert len(proofs) == N_WITNESSES
    assert not {proof_bytes(p) for p in proofs} & set(c.host)  # fresh (r, s), not the explicit ones
    for p, pub in zip(proofs, c.pubs):
        assert verify(c.vk, as_reference_proof(p), pub)


# prove_tpu_batch's rule (zkp2p_tpu/prover/groth16_tpu.py): one span when
# chunk <= 0 or n <= chunk, else spans of chunk, the last padded by
# repeating its final witness
SPANS = {
    (5, 2): [[0, 1], [2, 3], [4, 4]],
    (5, 0): [[0, 1, 2, 3, 4]],
    (4, 4): [[0, 1, 2, 3]],
    (3, 4): [[0, 1, 2]],
    (8, 4): [[0, 1, 2, 3], [4, 5, 6, 7]],
    (9, 4): [[0, 1, 2, 3], [4, 5, 6, 7], [8, 8, 8, 8]],
    (3, 1): [[0], [1], [2]],
}


@pytest.mark.parametrize("n,chunk", list(SPANS), ids=[f"n{n}-chunk{c}" for n, c in SPANS])
def test_batch_spans_follow_the_reference_rule(n, chunk):
    assert batch_spans(n, chunk) == SPANS[n, chunk]


def test_prove_gpu_batch_refuses_bad_arguments(monkeypatch):
    c = circuit_case("toy")
    with pytest.raises(ValueError, match="no witnesses"):
        prove_gpu_batch(c.key, [], device="cpu")
    for chunk in (-1, 2.0, "auto", True):
        with pytest.raises(ValueError, match="chunk"):
            prove_gpu_batch(c.key, c.wits, chunk=chunk, device="cpu")
    with pytest.raises(ValueError, match="pairs"):
        prove_gpu_batch(c.key, c.wits, rs=c.rs[:-1], device="cpu")
    # a witness that fails the width guard stops the batch before any device
    # work: the toy key with wire x (id 2) classed narrow by inference
    key = dataclasses.replace(c.key, inferred_narrow_wires=np.array([2], dtype=np.int64).tobytes())
    bad = list(c.wits[2])
    bad[2] = 1 << 40
    monkeypatch.setattr(gp, "witness_to_device", lambda *a: pytest.fail("device work before the width guard"))
    with pytest.raises(ValueError, match="width bound"):
        prove_gpu_batch(key, c.wits[:2] + [bad], rs=c.rs[:3], device="cpu")
    with pytest.raises(ValueError, match="width bound"):
        prove_gpu_batch(key, [u64_rows(w) for w in c.wits[:2]] + [u64_rows(bad)], rs=c.rs[:3], device="cpu")


def test_batched_recode_matches_each_witness_and_jax_vmap():
    rng = np.random.default_rng(11)
    vals = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(37)] for _ in range(3)]
    vals[1][:3] = [0, 1, R - 1]
    lim = np.stack([np.frombuffer(b"".join(v.to_bytes(32, "little") for v in row), dtype="<u2")
                    .astype(np.int32).reshape(-1, 16) for row in vals])
    for window in (4, 16):
        mags, negs = msm.signed_digit_planes(torch.from_numpy(lim), window)
        assert mags.shape == negs.shape == (256 // window, 3, 37)
        jm, jn = jax.vmap(lambda x: jmsm.signed_digit_planes_from_limbs(x, window))(jnp.asarray(lim.astype(np.uint32)))
        for b in range(3):
            one_m, one_n = msm.signed_digit_planes(torch.from_numpy(lim[b]), window)
            assert torch.equal(mags[:, b], one_m) and torch.equal(negs[:, b], one_n)
            assert np.array_equal(mags[:, b].numpy(), np.asarray(jm[b]).astype(np.int32))
            assert np.array_equal(negs[:, b].numpy(), np.asarray(jn[b]))


# --------------------------------------------------------- the slow twins


@pytest.mark.slow
@pytest.mark.xslow
@pytest.mark.parametrize("name", ["toy", "classed"])
def test_batched_accumulators_match_reference_prove_device(name):
    from zkp2p_tpu.curve.jcurve import g1_jac_to_host, g2_jac_to_host
    from zkp2p_tpu.field.jfield import FR as JFR
    from zkp2p_tpu.prover.groth16_tpu import _prove_device, _witness_std_limbs

    c = circuit_case(name)
    w = JFR.to_mont(jnp.asarray(np.stack([_witness_std_limbs(x) for x in c.wits])))
    ref = _prove_device(c.dpk, w, batched=True)
    want = list(zip(g1_jac_to_host(ref[0]), g1_jac_to_host(ref[1]),
                    [tuple((q.c0, q.c1) for q in p) if p is not None else None for p in g2_jac_to_host(ref[2])],
                    g1_jac_to_host(ref[3]), g1_jac_to_host(ref[4])))
    got = gp.accumulators_to_host(gp._prove_device(c.key, gp.witness_to_device(np.stack(
        [u64_rows(x) for x in c.wits]), "cpu"), False, "windowed"))
    got = [(a, b1, None if b2 is None else tuple((q.c0, q.c1) for q in b2), cc, h) for a, b1, b2, cc, h in got]
    # G2 as affine points: the reference folds G2 lanes by a scan on the CPU
    assert got == want


@pytest.mark.slow
@pytest.mark.xslow
@pytest.mark.parametrize("name", ["toy", "classed"])
def test_prove_gpu_batch_matches_prove_tpu_batch(name, monkeypatch):
    from zkp2p_tpu.prover import groth16_tpu
    from zkp2p_tpu.prover import prove_tpu_batch

    c = circuit_case(name)
    rng = random.Random(zlib.crc32(f"tpu_batch/{name}".encode()))
    draws = [rng.randrange(R - 1) for _ in range(2 * N_WITNESSES)]
    it = iter(draws)
    monkeypatch.setattr(groth16_tpu, "secrets", SimpleNamespace(randbelow=lambda n: next(it)))
    want = [proof_bytes(p) for p in prove_tpu_batch(c.dpk, c.wits)]
    rs = [(1 + draws[2 * i], 1 + draws[2 * i + 1]) for i in range(N_WITNESSES)]
    got = [proof_bytes(p) for p in prove_gpu_batch(c.key, c.wits, rs=rs, chunk=2, device="cpu")]
    assert got == want
