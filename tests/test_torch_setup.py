"""The port's key setup (zkp2p_tpu_torch.prover.setup_device) and its
fixed-base kernel's plain version (ops.cuda_fixed_base, K17) against
the reference, on the CPU, bit for bit.

- fixed_base_plain + the plain jac_to_affine against the reference's
  native fixed-base batches (G1 and G2), on 0, 1, 2, r-1, 2^(8k),
  scalars with zero windows and random ones;
- setup_device(cs, device="cpu") against the reference's
  setup_device(cs, seed) and device_pk(setup(cs, seed), cs) on the
  verify skill's demo circuit, and against the committed vector's key
  (zkp2p_tpu_torch/data/port_vector.npz, itself held against the
  reference in test_torch_vector.py) on its 2^11 circuit;
- the committed setup vector (zkp2p_tpu_torch/data/setup_vector.npz),
  rebuilt here from its circuit with the reference so that it cannot
  drift: setup_from_rows on its rows gives the vector's key, and the
  port's verify accepts the vector's proof under the VK.

Write the setup vector anew with
`python tests/test_torch_setup.py --write-vector`."""

import random
import sys

import numpy as np
import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.field.tower import Fq2 as JFq2
from zkp2p_tpu.native.lib import g1_fixed_base_batch_mont_limbs, g2_fixed_base_batch_mont_limbs
from zkp2p_tpu.prover.groth16_tpu import _rows_to_arrays as ref_rows_to_arrays
from zkp2p_tpu.prover.groth16_tpu import device_pk as ref_device_pk
from zkp2p_tpu.prover.groth16_tpu import widths_array as ref_widths_array
from zkp2p_tpu.prover.setup_device import setup_device as ref_setup_device
from zkp2p_tpu.snark.groth16 import qap_rows as ref_qap_rows
from zkp2p_tpu.snark.groth16 import setup as ref_setup
from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem

from test_torch_vector import build_vector_circuit
from zkp2p_tpu_torch.curve import host
from zkp2p_tpu_torch.field.tfield import FQ, FQ2, int_to_limbs
from zkp2p_tpu_torch.ops import cuda_build
from zkp2p_tpu_torch.ops.cuda_fixed_base import fixed_base, fixed_base_plain, fixed_base_table
from zkp2p_tpu_torch.ops.msm_affine import jac_to_affine_batch
from zkp2p_tpu_torch.prover.groth16_gpu import DPK_ARRAY_FIELDS
from zkp2p_tpu_torch.ops.cuda_matvec import csr_from_rows, fr_matvec
from zkp2p_tpu_torch.prover import setup_device as setup_device_module
from zkp2p_tpu_torch.prover.setup_device import qap_coo, setup_device, setup_from_rows
from zkp2p_tpu_torch.prover.vector import (SETUP_VECTOR_PATH, VECTOR_PATH, load_setup_vector, load_vector,
                                           save_setup_vector)
from zkp2p_tpu_torch.snark.groth16 import VerifyingKey, verify

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


def build_demo():
    """The verify skill's demo circuit and witness."""
    cs = ConstraintSystem("demo")
    out = cs.new_public("out")
    x, y, z = cs.new_wire(), cs.new_wire(), cs.new_wire()
    cs.enforce(LC.of(x), LC.of(y), LC.of(z))
    cs.enforce(LC.of(z), LC.of(z), LC.of(out))
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    return cs, cs.witness([1849], {x: 43, y: 1}), [1849]


def port_g2(p):
    """A reference G2 point (or (c0, c1) pairs) as the port's."""
    from zkp2p_tpu_torch.field.tower import Fq2

    if p is None:
        return None
    return tuple(Fq2(*((c.c0, c.c1) if hasattr(c, "c0") else c)) for c in p)


def ref_g2(p):
    return None if p is None else tuple(JFq2(c.c0, c.c1) for c in p)


def g2_key(p):
    return None if p is None else tuple((c.c0, c.c1) for c in p)


def port_vk(vk) -> VerifyingKey:
    """A reference VerifyingKey as the port's."""
    return VerifyingKey(n_public=vk.n_public, alpha_1=vk.alpha_1, beta_2=port_g2(vk.beta_2),
                        gamma_2=port_g2(vk.gamma_2), delta_2=port_g2(vk.delta_2), ic=list(vk.ic))


def assert_vk_equal(got, want):
    assert got.n_public == want.n_public and got.alpha_1 == want.alpha_1 and got.ic == want.ic
    for k in ("beta_2", "gamma_2", "delta_2"):
        assert g2_key(getattr(got, k)) == g2_key(getattr(want, k)), k


def assert_key_equal(key, ref):
    """Every array field and meta field of a port key equal to a key of
    the reference (or to key_from_numpy arrays given as a dict)."""
    for name in DPK_ARRAY_FIELDS:
        got = getattr(key, name)
        want = ref[name] if isinstance(ref, dict) else getattr(ref, name)
        gots = got if isinstance(got, tuple) else (got,)
        wants = tuple(want) if isinstance(got, tuple) else (want,)
        for g, w in zip(gots, wants):
            assert np.array_equal(g.cpu().numpy().astype(np.int64), np.asarray(w).astype(np.int64)), name
    if not isinstance(ref, dict):
        for k in ("n_public", "n_wires", "log_m", "alpha_1", "beta_1", "delta_1"):
            assert getattr(key, k) == getattr(ref, k), k
        for k in ("beta_2", "delta_2"):
            assert g2_key(getattr(key, k)) == g2_key(getattr(ref, k)), k


# ------------------------------------------------------------ K17 (plain)


def special_scalars():
    rng = random.Random(17)
    zero_windows = int.from_bytes(bytes(b if k % 3 else 0 for k, b in enumerate(rng.randbytes(32))), "little") % R
    return ([0, 1, 2, R - 1, R - 2] + [1 << (8 * k) for k in (1, 5, 16, 31)] + [0x30 << 248, zero_windows]
            + [rng.randrange(R) for _ in range(5)])


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_fixed_base_plain_matches_native(g2):
    scalars = special_scalars() + ([] if g2 else [random.Random(3).randrange(R) for _ in range(48)])
    base = host.G2_GENERATOR if g2 else host.G1_GENERATOR
    table = fixed_base_table(g2, base, "cpu")
    k = torch.from_numpy(np.stack([int_to_limbs(s) for s in scalars]))
    cuda_build.reset_launches()
    jac = fixed_base(g2, table, k)
    assert all(torch.equal(a, b) for a, b in zip(jac, fixed_base_plain(g2, table, k)))
    x, y = jac_to_affine_batch(FQ2 if g2 else FQ, jac)
    if g2:
        wx, wy = g2_fixed_base_batch_mont_limbs(ref_g2(base), scalars)
    else:
        wx, wy = g1_fixed_base_batch_mont_limbs(base, scalars)
    assert np.array_equal(x.numpy(), wx.astype(np.int32)) and np.array_equal(y.numpy(), wy.astype(np.int32))
    assert int(FQ.is_zero(jac[2].reshape(len(scalars), -1)).sum()) == 1  # only the scalar 0 at infinity
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())


def test_fixed_base_table_rows():
    """Row w * 255 + d - 1 of the table is 2^(8w) * d * G."""
    for g2, base, mul in ((False, host.G1_GENERATOR, host.g1_mul), (True, host.G2_GENERATOR, host.g2_mul)):
        tx, ty = fixed_base_table(g2, base, "cpu")
        for row in (0, 1, 254, 255, 4000, 8159):
            w, d = divmod(row, 255)
            coords = [[FQ.from_mont_host(c) for c in (t[row] if g2 else t[row][None])] for t in (tx, ty)]
            want = mul(base, (d + 1) << (8 * w))
            assert (g2_key(port_g2(coords)) if g2 else tuple(v[0] for v in coords)) == \
                (g2_key(want) if g2 else want), row


# ------------------------------------------------------------ the setup


@pytest.fixture(scope="module")
def demo_setup():
    cs, _, _ = build_demo()
    return cs, setup_device(cs, device="cpu")


def test_setup_device_demo_matches_reference(demo_setup):
    cs, (key, vk) = demo_setup
    rkey, rvk = ref_setup_device(cs)
    assert_key_equal(key, rkey)
    pk, rvk2 = ref_setup(cs)
    assert_key_equal(key, ref_device_pk(pk, cs))
    assert_vk_equal(vk, rvk)
    assert_vk_equal(vk, rvk2)
    assert key.inferred_narrow_wires is None


def test_setup_device_vector_matches_committed_key():
    """The 2^11 circuit's setup on the CPU gives the committed vector's
    key; its rows are the setup vector's; the VK verifies the committed
    proof and rejects a wrong public input."""
    cs, _, pub, _, _ = build_vector_circuit()
    stages = {}
    key, vk = setup_device(cs, seed="port-vector", device="cpu", stages=stages)
    assert set(stages) == {"s_" + k for k in ("powers", "inverse", "lagrange", "qap", "scaled", "prune", "points")}
    arrays, meta, _, _, _, proof = load_vector(VECTOR_PATH)
    assert_key_equal(key, arrays)
    assert key.alpha_1 == meta["alpha_1"] and key.beta_1 == meta["beta_1"] and key.delta_1 == meta["delta_1"]
    sv = load_setup_vector(SETUP_VECTOR_PATH)
    assert sv["seed"] == "port-vector" and sv["public"] == pub
    a, b, c, n_rows = qap_coo(cs)
    for got, want in ((a, (arrays["a_coeff"], arrays["a_wire"], arrays["a_row"])),
                      (b, (arrays["b_coeff"], arrays["b_wire"], arrays["b_row"])), (c, sv["c"])):
        assert all(np.array_equal(np.asarray(g).astype(np.int64), np.asarray(w).astype(np.int64))
                   for g, w in zip(got, want))
    assert np.array_equal(sv["widths"], np.asarray([cs.wire_width.get(i, 254) for i in range(cs.num_wires)]))
    assert vk.ic == sv["ic"] and g2_key(vk.gamma_2) == g2_key(sv["gamma_2"])
    assert verify(vk, proof, pub)
    assert not verify(vk, proof, [pub[0] + 1] + pub[1:])


def test_setup_from_rows_takes_the_key_rows_as_given(demo_setup, monkeypatch):
    """setup_from_rows on arrays (the demo circuit's COO rows, C's
    shuffled, the row count given) keeps the A and B arrays it is given
    and gives setup_device's points, unclassed without widths; with every
    row of M^T longer than one nonzero cut into chunks (two K13 passes)."""
    cs, (ref, rvk) = demo_setup
    monkeypatch.setattr(setup_device_module, "LONG_ROW", 1)
    a, b, c, n_rows = qap_coo(cs)
    perm = np.random.default_rng(1).permutation(len(c[0]))
    key, vk = setup_from_rows(a, b, tuple(x[perm] for x in c), cs.num_wires, cs.num_public, None,
                              device="cpu", n_rows=n_rows)
    assert torch.equal(key.a_coeff, torch.from_numpy(a[0])) and torch.equal(key.b_row, torch.from_numpy(b[2]).long())
    for name in ("a_bases", "b1_bases", "b2_bases", "c_bases", "h_bases", "b_sel", "c_sel"):
        got, want = getattr(key, name), getattr(ref, name)
        assert all(torch.equal(g, w) for g, w in zip(got, want)) if isinstance(got, tuple) \
            else torch.equal(got, want), name
    assert key.a_nsel.numel() == 0 and key.a_wsel.numel() == cs.num_wires
    assert_vk_equal(vk, rvk)


@pytest.mark.parametrize("long_row", [1, 3, 64, 2048])
def test_transposed_matvec_cuts_long_rows(monkeypatch, long_row):
    """A^T v with the rows of A^T longer than LONG_ROW in chunks and a
    second pass over the chunk sums: equal to one K13 pass (plain here),
    with an empty row, a row of 2,000 nonzeros and a repeated (row, wire)."""
    gen = torch.Generator().manual_seed(long_row)

    def canon(n):
        x = torch.randint(0, 1 << 16, (n, 16), generator=gen, dtype=torch.int32)
        x[:, 15] = torch.randint(0, 0x3064, (n,), generator=gen, dtype=torch.int32)
        return x

    nnz, m, n_wires = 2600, 64, 40
    coeff, vec = canon(nnz), canon(m)
    row = torch.randint(0, m, (nnz,), generator=gen)
    wire = torch.randint(1, n_wires - 1, (nnz,), generator=gen)
    wire[:2000] = 0
    row[5], wire[5] = row[4], wire[4]
    want = fr_matvec(*csr_from_rows(coeff, row, wire, n_wires), vec)
    monkeypatch.setattr(setup_device_module, "LONG_ROW", long_row)
    got = setup_device_module._transposed_matvec((coeff, wire, row), vec, n_wires)
    assert torch.equal(got, want) and not bool(want[n_wires - 1].any())


# ------------------------------------------------------------ setup vector


def rebuild_setup_vector():
    """The setup vector from its circuit, with the reference alone:
    (C rows, widths, seed, VK, public inputs)."""
    cs, _, pub, _, _ = build_vector_circuit()
    rows = ref_qap_rows(cs)
    m = 1 << 11
    c_rows = tuple(np.asarray(x) for x in ref_rows_to_arrays([t[2] for t in rows], m))
    _, vk = ref_setup_device(cs, seed="port-vector")
    return c_rows, ref_widths_array(cs), "port-vector", vk, pub


def test_committed_setup_vector_matches_its_circuit():
    c_rows, widths, seed, vk, pub = rebuild_setup_vector()
    sv = load_setup_vector(SETUP_VECTOR_PATH)
    for got, want in zip(sv["c"], c_rows):
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64))
    assert np.array_equal(sv["widths"], widths)
    assert sv["seed"] == seed and sv["public"] == pub
    assert sv["ic"] == vk.ic and g2_key(sv["gamma_2"]) == g2_key(vk.gamma_2)
    arrays, meta, *_ = load_vector(VECTOR_PATH)
    assert meta["alpha_1"] == vk.alpha_1 and g2_key(meta["beta_2"]) == g2_key(vk.beta_2)


if __name__ == "__main__" and "--write-vector" in sys.argv:
    c_rows, widths, seed, vk, pub = rebuild_setup_vector()
    save_setup_vector(SETUP_VECTOR_PATH, c_rows, widths, seed, vk.gamma_2, vk.ic, pub)
    print(f"wrote {SETUP_VECTOR_PATH}")
