"""The port's snarkjs .zkey import (zkp2p_tpu_torch.formats.zkey and
prover.groth16_gpu.device_pk_from_zkey) against the reference's, on the
CPU: zkeys written by the reference's writers, whole and in chunks, with
and without inferred widths, give the reference's key bit for bit; the
width guard raises on a witness that breaks an inferred bound; repeated
coefficient entries sum as the reference sums them."""

import os
import struct

import numpy as np
import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.formats.zkey import read_zkey as ref_read_zkey
from zkp2p_tpu.formats.zkey import split_zkey, write_zkey, write_zkey_data
from zkp2p_tpu.prover.groth16_tpu import device_pk_from_zkey as ref_device_pk_from_zkey
from zkp2p_tpu.prover.groth16_tpu import infer_zkey_widths as ref_infer_zkey_widths
from zkp2p_tpu.snark.groth16 import qap_rows, setup
from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem

from test_torch_keycache import build_bits
from test_torch_prover import u64_rows
from test_torch_setup import assert_key_equal, assert_vk_equal, g2_key
from zkp2p_tpu_torch.formats.zkey import read_zkey
from zkp2p_tpu_torch.prover.groth16_gpu import _check_inferred_widths, device_pk_from_zkey, infer_zkey_widths

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bits_zkey(tmp_path_factory):
    cs, x = build_bits()
    pk, vk = setup(cs, seed="zkey")
    path = str(tmp_path_factory.mktemp("zkey") / "bits.zkey")
    write_zkey(path, pk, vk, qap_rows(cs))
    return cs, x, pk, vk, path


def _ref_key(path, infer):
    return ref_device_pk_from_zkey(ref_read_zkey(path), infer_widths=infer)


@pytest.mark.parametrize("infer", [True, False], ids=["inferred", "unclassed"])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunks"])
def test_device_pk_from_zkey_matches_reference(bits_zkey, tmp_path, chunked, infer):
    cs, x, pk, vk, path = bits_zkey
    src = split_zkey(path, n_chunks=10) if chunked else path
    zk = read_zkey(src)
    key = device_pk_from_zkey(zk, infer_widths=infer, device="cpu")
    rkey = _ref_key(path, infer)
    assert_key_equal(key, rkey)
    assert key.inferred_narrow_wires == rkey.inferred_narrow_wires
    assert (key.a_nsel.numel() > 0) == infer
    assert_vk_equal(zk.to_verifying_key(), vk)


def test_read_zkey_matches_reference(bits_zkey):
    cs, x, pk, vk, path = bits_zkey
    zk, rz = read_zkey(path), ref_read_zkey(path)
    assert (zk.n_vars, zk.n_public, zk.domain_size) == (rz.n_vars, rz.n_public, rz.domain_size)
    assert zk.ic == rz.ic and zk.alpha_1 == rz.alpha_1 and g2_key(zk.gamma_2) == g2_key(rz.gamma_2)
    assert np.array_equal(infer_zkey_widths(zk), ref_infer_zkey_widths(rz))
    got = zk.to_proving_key()
    for name in ("a_query", "b1_query", "c_query", "h_query"):
        assert getattr(got, name) == getattr(rz, name), name
    assert [g2_key(p) for p in got.b2_query] == [g2_key(p) for p in rz.b2_query]


def test_width_guard_raises_on_a_broken_inferred_bound(tmp_path):
    """x*(x-1) = y is read as a bit constraint: a witness with a wide x
    must be refused, and proves once inference is off."""
    cs = ConstraintSystem("trap")
    out = cs.new_public("out")
    x = cs.new_wire("x")
    y = cs.new_wire("y")
    cs.enforce(LC.of(x), LC.of(x) - 1, LC.of(y), "not-a-bit")
    cs.enforce(LC.of(y), LC.const(1), LC.of(out), "bind")
    cs.compute(y, lambda v: v * (v - 1) % R, [x])
    pk, vk = setup(cs, seed="width-trap")
    path = os.path.join(tmp_path, "trap.zkey")
    write_zkey(path, pk, vk, qap_rows(cs))
    zk = read_zkey(path)
    key = device_pk_from_zkey(zk, device="cpu")
    assert key.inferred_narrow_wires == _ref_key(path, True).inferred_narrow_wires
    xv = 5000  # > 2^11
    w = cs.witness([xv * (xv - 1) % R], {x: xv})
    with pytest.raises(ValueError, match="width bound inferred"):
        _check_inferred_widths(key, w)
    with pytest.raises(ValueError, match="width bound inferred"):
        _check_inferred_widths(key, w, w_std=u64_rows(w))
    _check_inferred_widths(device_pk_from_zkey(zk, infer_widths=False, device="cpu"), w)
    ok = cs.witness([0], {x: 1})
    _check_inferred_widths(key, ok)


def _coeff_value_offset(data: bytes, k: int) -> int:
    """The byte offset of the k-th coefficient's value in a zkey."""
    off = 12
    while True:
        stype, size = struct.unpack_from("<IQ", data, off)
        if stype == 4:
            return off + 12 + 4 + k * 44 + 12
        off += 12 + size


def test_repeated_and_unreduced_coefficients_read_as_the_reference_reads_them(bits_zkey, tmp_path):
    """A coefficient section with repeated (row, wire) entries and a
    value stored at or above r: summed mod r into the first entry and
    reduced, as the reference's per-row dicts hold them."""
    cs, x, pk, vk, path = bits_zkey
    rz = ref_read_zkey(path)
    rz.coeffs = list(rz.coeffs) + [(0, 0, rz.coeffs[0][2], 5), (1, 2, 1, R - 1), (0, 3, 0, 7), (1, 2, 1, 3)]
    p2 = os.path.join(tmp_path, "dups.zkey")
    write_zkey_data(p2, rz)
    with open(p2, "rb") as f:
        data = bytearray(f.read())
    at = _coeff_value_offset(data, 1)
    v = int.from_bytes(data[at:at + 32], "little") + R  # the same value, unreduced
    data[at:at + 32] = v.to_bytes(32, "little")
    with open(p2, "wb") as f:
        f.write(data)
    zk = read_zkey(p2)
    key = device_pk_from_zkey(zk, infer_widths=False, device="cpu")
    assert_key_equal(key, ref_device_pk_from_zkey(ref_read_zkey(p2), infer_widths=False))
    assert len(key.a_coeff) + len(key.b_coeff) < len(zk.coeff_row)  # the repeats were merged
