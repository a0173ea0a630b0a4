"""The witness side of the port's proof against the reference: the CSR
sparse matvec (zkp2p_tpu_torch.ops.cuda_matvec, K13's plain version on
the CPU) against the gathered route it replaces (groth16_gpu._matvec)
and the JAX abc_evals / jfield.lazy_segment_sum_mod, and the witness
upload (groth16_gpu.witness_to_device) against the host-widened route
and the JAX witness_to_device.  Inputs are made from a numpy seed;
every comparison is of exact limbs."""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.field import jfield
from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.prover import groth16_tpu as jgroth

from zkp2p_tpu_torch.field.tfield import FR
from zkp2p_tpu_torch.ops import cuda_build, cuda_matvec
from zkp2p_tpu_torch.prover import groth16_gpu as gp

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

SPECIAL = (0, 1, R - 1)
LONG_ROW = 5000  # below 2^16 nonzeros, where the reference's uint32 limb sums are exact


def fr_limbs(vals) -> np.ndarray:
    """Python ints (< R) -> (n, 16) int32 16-bit limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").astype(np.int32).reshape(len(vals), 16)


def rand_fr(rng, n, special=()) -> np.ndarray:
    """n random canonical Fr values as limbs, the first ones `special`."""
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    vals[:len(special)] = special
    return fr_limbs(vals)


def matrix_case(seed, log_m, sort_rows, long_row=False):
    """A random QAP matrix of 2^log_m rows over n_wires witness values
    (coeff, wire, row as numpy; w as limbs): row 1 empty, row 2 repeating
    one wire, the coefficients and witness values 0, 1 and R-1 in row 3,
    and with `long_row` a row of LONG_ROW nonzeros."""
    rng = np.random.default_rng(seed)
    m = 1 << log_m
    n_wires = m // 2 + 3
    nnz = 3 * m
    row = rng.integers(0, m, size=nnz)
    row[row == 1] = 0
    wire = rng.integers(0, n_wires, size=nnz)
    row[:4], wire[:4] = 2, 7  # one wire four times in one row
    row[4:13] = 3
    wire[4:13] = np.repeat(np.arange(3), 3)  # witness values 0, 1, R-1 ...
    coeff = rand_fr(rng, nnz)
    coeff[4:13] = fr_limbs(SPECIAL * 3)  # ... against coefficients 0, 1, R-1
    w = rand_fr(rng, n_wires, SPECIAL)
    if long_row:
        row = np.concatenate([row, np.full(LONG_ROW, m - 1)])
        wire = np.concatenate([wire, rng.integers(0, n_wires, size=LONG_ROW)])
        coeff = np.concatenate([coeff, rand_fr(rng, LONG_ROW, SPECIAL)])
    order = np.argsort(row, kind="stable") if sort_rows else rng.permutation(len(row))
    return coeff[order], wire[order], row[order], w


def jax_segment_sums(coeff, wire, row, w, m):
    vals = jfield.FR.mul(jnp.asarray(coeff.astype(np.uint32)), jnp.asarray(w.astype(np.uint32))[wire])
    return np.asarray(jfield.lazy_segment_sum_mod(jfield.FR, vals, jnp.asarray(row.astype(np.int32)), m))


@pytest.mark.parametrize("sort_rows", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("log_m", [8, 9, 10, 11])
def test_fr_matvec_plain_matches_matvec_and_jax(log_m, sort_rows):
    m = 1 << log_m
    coeff, wire, row, w = matrix_case(1000 * log_m + sort_rows, log_m, sort_rows, long_row=log_m == 11)
    t = {k: torch.from_numpy(v) for k, v in dict(coeff=coeff, wire=wire, row=row, w=w).items()}
    csr = cuda_matvec.csr_from_rows(t["coeff"], t["wire"], t["row"], m)
    assert csr.offsets.tolist() == [0] + np.cumsum(np.bincount(row, minlength=m)).tolist()
    assert (csr.coeff is t["coeff"]) == sort_rows  # a permuted copy only when a sort was needed
    got = cuda_matvec.fr_matvec(*csr, t["w"])
    assert got[1].eq(0).all()  # the empty row
    assert torch.equal(got, cuda_matvec.fr_matvec_plain(*csr, t["w"]))
    assert torch.equal(got, gp._matvec(t["coeff"], t["wire"], t["row"], t["w"], m))
    assert np.array_equal(got.numpy(), jax_segment_sums(coeff, wire, row, w, m).astype(np.int32))


def test_fr_matvec_plain_chunks_its_products(monkeypatch):
    coeff, wire, row, w = matrix_case(7, 8, False)
    t = [torch.from_numpy(v) for v in (coeff, wire, row, w)]
    csr = cuda_matvec.csr_from_rows(*t[:3], 256)
    want = cuda_matvec.fr_matvec_plain(*csr, t[3])
    monkeypatch.setattr(cuda_matvec, "PLAIN_CHUNK", 100)
    assert torch.equal(cuda_matvec.fr_matvec_plain(*csr, t[3]), want)
    out = torch.full((256, 16), -1, dtype=torch.int32)
    assert cuda_matvec.fr_matvec(*csr, t[3], out=out) is out and torch.equal(out, want)


def test_csr_from_rows_refuses_rows_outside_the_domain():
    coeff = torch.zeros(3, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="row ids"):
        cuda_matvec.csr_from_rows(coeff, torch.zeros(3, dtype=torch.int64), torch.tensor([0, 4, 1]), 4)
    empty = cuda_matvec.csr_from_rows(coeff[:0], torch.zeros(0, dtype=torch.int64),
                                      torch.zeros(0, dtype=torch.int64), 4)
    assert empty.offsets.tolist() == [0] * 5
    assert cuda_matvec.fr_matvec(*empty, torch.zeros(2, 16, dtype=torch.int32)).eq(0).all()


def test_abc_evals_cpu_matches_jax_and_builds_the_csr_once(monkeypatch):
    log_m = 9
    a = matrix_case(31, log_m, True)
    b = matrix_case(32, log_m, False)
    w = a[3]
    w_mont = FR.to_mont(torch.from_numpy(w))
    fields = {}
    for name, (coeff, wire, row, _) in (("a", a), ("b", b)):
        fields.update({f"{name}_coeff": coeff, f"{name}_wire": wire, f"{name}_row": row})
    key = SimpleNamespace(log_m=log_m, _split={}, **{k: torch.from_numpy(v) for k, v in fields.items()})
    built = []
    real = gp.csr_from_rows
    monkeypatch.setattr(gp, "csr_from_rows", lambda *args: built.append(1) or real(*args))
    got = gp.abc_evals(key, w_mont)
    assert got.shape == (3, 1 << log_m, 16)
    assert torch.equal(gp.abc_evals(key, w_mont), got) and len(built) == 2
    assert torch.equal(got, gp._abc_evals_gathered(key, w_mont))
    jkey = SimpleNamespace(log_m=log_m, **{k: jnp.asarray(v.astype(np.uint32 if "coeff" in k else np.int32))
                                            for k, v in fields.items()})
    want = jgroth.abc_evals(jkey, jnp.asarray(w_mont.numpy().astype(np.uint32)))
    assert np.array_equal(got.numpy(), np.stack([np.asarray(x) for x in want]).astype(np.int32))


# ------------------------------------------------------------------ witness


def witness_values(seed, n=300):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    vals[:4] = [0, 1, R - 1, (1 << 253) + 5]
    return vals


def u64_rows(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u8").reshape(len(vals), 4).copy()


@pytest.mark.parametrize("form", ["ints", "u64", "u64 read-only"])
def test_witness_to_device_matches_widened_and_jax(form):
    vals = witness_values(5)
    witness = vals if form == "ints" else u64_rows(vals)
    if form == "u64 read-only":
        witness.setflags(write=False)
    cuda_build.reset_launches()
    got = gp.witness_to_device(witness, "cpu")
    assert got.dtype == torch.int32 and got.shape == (len(vals), 16)
    assert torch.equal(got, gp._witness_to_device_widened(witness, "cpu"))
    assert torch.equal(got, FR.to_mont(torch.from_numpy(gp._witness_std_limbs(witness))))
    assert np.array_equal(got.numpy(), np.asarray(jgroth.witness_to_device(witness)).astype(np.int32))
    assert [FR.from_mont_host(r) for r in got.numpy()[:4]] == vals[:4]
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())


R_WORDS = np.frombuffer(R.to_bytes(32, "little"), dtype="<u8")


def _bad_rows(case):
    rows = u64_rows(witness_values(9, 64))
    rows[3] = R_WORDS - np.array([1, 0, 0, 0], dtype=np.uint64)  # R - 1: reduced
    if case == "equal to R":
        rows[[17, 40]] = R_WORDS
    elif case == "above R in a low word":
        rows[[25, 30]] = R_WORDS
        rows[25, 0] += 1
        rows[30, 2] += 1
    elif case == "above R in the top word":
        rows[[11, 50]] = R_WORDS
        rows[11, 3] += 1
        rows[50, 3] = np.uint64(1 << 63)
    elif case == "mixed":
        rows[44] = R_WORDS
        rows[21] = R_WORDS
        rows[21, 1] += 7
        rows[58, 3] = np.uint64((1 << 64) - 1)
    return rows


@pytest.mark.parametrize("case", ["equal to R", "above R in a low word", "above R in the top word", "mixed",
                                  "none"])
def test_unreduced_check_names_the_reference_row(case):
    rows = _bad_rows(case)

    def flagged(check):
        try:
            check(rows)
        except ValueError as e:
            return int(re.search(r"witness row (\d+) is not reduced", str(e)).group(1))
        return None

    want = flagged(jgroth._check_u64_reduced)
    assert flagged(gp._check_u64_reduced) == want
    assert want == {"equal to R": 17, "above R in a low word": 25, "above R in the top word": 11, "mixed": 21,
                    "none": None}[case]
    if want is not None:
        with pytest.raises(ValueError, match=f"witness row {want} is not reduced"):
            gp.witness_to_device(rows, "cpu")
