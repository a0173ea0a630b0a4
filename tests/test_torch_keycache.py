"""The port's key cache (zkp2p_tpu_torch.prover.keycache) against the
reference's, on the CPU: a file written by either package loads in the
other and gives the same key and VK, bit for bit; a wrong schema or a
wrong circuit digest raises KeyCacheSchemaError; the digest is the
reference's; and, as in the reference, the cache does not keep a
zkey-imported key's inferred widths."""

import os

import numpy as np
import pytest
import torch

from zkp2p_tpu.formats.zkey import write_zkey
from zkp2p_tpu.gadgets.core import num2bits
from zkp2p_tpu.prover import keycache as ref_keycache
from zkp2p_tpu.prover.groth16_tpu import device_pk as ref_device_pk
from zkp2p_tpu.snark.groth16 import qap_rows, setup
from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem

from test_torch_setup import assert_key_equal, assert_vk_equal, port_vk
from zkp2p_tpu_torch.formats.zkey import read_zkey
from zkp2p_tpu_torch.prover import keycache
from zkp2p_tpu_torch.prover.groth16_gpu import device_pk, device_pk_from_zkey

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


def build_bits():
    """Public input, an 8-bit decomposition (narrow wires) and a square."""
    cs = ConstraintSystem("bits")
    out = cs.new_public("out")
    x = cs.new_wire("x")
    num2bits(cs, x, 8)
    cs.enforce(LC.of(x), LC.of(x), LC.of(out), "sq")
    return cs, x


@pytest.fixture(scope="module")
def keys():
    cs, _ = build_bits()
    pk, vk = setup(cs, seed="keycache")
    return cs, pk, vk, ref_device_pk(pk, cs)


def test_device_pk_matches_reference(keys):
    cs, pk, vk, rkey = keys
    key = device_pk(pk, cs, device="cpu")
    assert_key_equal(key, rkey)
    assert key.a_nsel.numel() > 0 and key.a_wsel.numel() > 0


def test_port_cache_loads_in_reference(keys, tmp_path):
    cs, pk, vk, rkey = keys
    path = str(tmp_path / "port.npz")
    digest = keycache.circuit_digest(cs)
    keycache.save_dpk(path, device_pk(pk, cs, device="cpu"), port_vk(vk), digest=digest)
    got, gvk = ref_keycache.load_dpk(path, digest=digest)
    for name in ("a_coeff", "b_sel", "c_nsel"):  # the reference's dtypes
        assert np.asarray(getattr(got, name)).dtype == np.asarray(getattr(rkey, name)).dtype, name
    assert np.asarray(got.b2_bases[0]).dtype == np.asarray(rkey.b2_bases[0]).dtype
    key = keycache.load_dpk(path, digest=digest, device="cpu")[0]
    assert_key_equal(key, got)
    assert_key_equal(key, rkey)
    assert_vk_equal(gvk, vk)


def test_reference_cache_loads_in_port(keys, tmp_path):
    cs, pk, vk, rkey = keys
    path = str(tmp_path / "ref.npz")
    digest = ref_keycache.circuit_digest(cs)
    ref_keycache.save_dpk(path, rkey, vk, digest=digest)
    key, kvk = keycache.load_dpk(path, digest=digest, device="cpu")
    assert_key_equal(key, rkey)
    assert_vk_equal(kvk, vk)
    assert key.device == torch.device("cpu")


def test_circuit_digest_is_the_reference_one(keys):
    cs, *_ = keys
    assert keycache.circuit_digest(cs) == ref_keycache.circuit_digest(cs)
    other, _ = build_bits()
    other.wire_width[3] = 200
    assert keycache.circuit_digest(other) != keycache.circuit_digest(cs)


@pytest.mark.parametrize("fault", ["schema", "digest", "missing field"])
def test_bad_cache_raises(keys, tmp_path, fault):
    cs, pk, vk, rkey = keys
    path = str(tmp_path / "k.npz")
    keycache.save_dpk(path, device_pk(pk, cs, device="cpu"), port_vk(vk), digest="abc")
    with np.load(path) as z:
        data = dict(z)
    if fault == "schema":
        data["schema_version"] = np.array([2], dtype=np.int64)
    elif fault == "missing field":
        del data["c_wsel"]
    np.savez(path, **data)
    with pytest.raises(keycache.KeyCacheSchemaError):
        keycache.load_dpk(path, digest="xyz" if fault == "digest" else "abc", device="cpu")
    if fault == "digest":
        keycache.load_dpk(path, digest="abc", device="cpu")  # the right digest, or none, loads
        keycache.load_dpk(path, device="cpu")


def test_cache_drops_inferred_widths_as_the_reference_does(keys, tmp_path):
    """A key imported from a zkey with inferred widths keeps its width
    guard, but not through the cache: neither package stores it."""
    cs, pk, vk, rkey = keys
    zpath = os.path.join(tmp_path, "bits.zkey")
    write_zkey(zpath, pk, vk, qap_rows(cs))
    key = device_pk_from_zkey(read_zkey(zpath), device="cpu")
    assert key.inferred_narrow_wires
    path = str(tmp_path / "z.npz")
    keycache.save_dpk(path, key, port_vk(vk))
    loaded, _ = keycache.load_dpk(path, device="cpu")
    assert loaded.inferred_narrow_wires is None
    assert ref_keycache.load_dpk(path)[0].inferred_narrow_wires is None
    assert_key_equal(loaded, {k: v for k, v in vars(key).items() if not k.startswith("_")})
