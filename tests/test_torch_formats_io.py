"""The port's file formats (zkp2p_tpu_torch.formats: circom_bin,
proof_json, the zkey writer) against the reference's, on the CPU: a .wtns
reads as the reference reads it, unreduced values included, and writes
the reference's bytes; a zkey written by the reference, read and written
again by the port, comes back byte for byte, whole and in chunks; the
proof, public-signal and verification-key JSON is the reference's byte
for byte."""

import struct

import numpy as np
import pytest

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.formats import proof_json as ref_json
from zkp2p_tpu.formats.circom_bin import read_wtns as ref_read_wtns
from zkp2p_tpu.formats.circom_bin import write_wtns as ref_write_wtns
from zkp2p_tpu.formats.zkey import split_zkey, write_zkey
from zkp2p_tpu.snark.groth16 import prove_host, qap_rows, setup

from test_torch_keycache import build_bits
from test_torch_setup import port_g2, port_vk
from zkp2p_tpu_torch.formats import proof_json
from zkp2p_tpu_torch.formats.circom_bin import read_wtns, reduce_rows, row_ints, write_wtns
from zkp2p_tpu_torch.formats.zkey import read_zkey, write_zkey_data
from zkp2p_tpu_torch.snark.groth16 import Proof

# values a .wtns may hold at or above r (every 256-bit value is below 6r)
UNREDUCED = [0, 1, R - 1, R, R + 5, 2 * R + 3, 5 * R + 7, (1 << 256) - 1]


@pytest.fixture(scope="module")
def bits(tmp_path_factory):
    cs, x = build_bits()
    pk, vk = setup(cs, seed="formats")
    d = tmp_path_factory.mktemp("formats")
    path = str(d / "bits.zkey")
    write_zkey(path, pk, vk, qap_rows(cs))
    return cs, pk, vk, path, cs.witness([49], {x: 7})


def raw_wtns(path, values):
    """A .wtns holding `values` as they are (the writers reduce them)."""
    body = b"".join(v.to_bytes(32, "little") for v in values)
    hdr = struct.pack("<I", 32) + R.to_bytes(32, "little") + struct.pack("<I", len(values))
    with open(path, "wb") as f:
        f.write(b"wtns" + struct.pack("<II", 2, 2))
        f.write(struct.pack("<IQ", 1, len(hdr)) + hdr + struct.pack("<IQ", 2, len(body)) + body)


def rows_of(values):
    return np.frombuffer(b"".join(v.to_bytes(32, "little") for v in values), "<u8").reshape(-1, 4).copy()


def test_read_wtns_matches_reference(bits, tmp_path):
    w = bits[4]
    p = str(tmp_path / "w.wtns")
    ref_write_wtns(w, p)
    rows = read_wtns(p)
    assert rows.shape == (len(w), 4) and rows.dtype == np.dtype("<u8") and rows.flags.writeable
    assert row_ints(rows) == ref_read_wtns(p) == w
    raw = str(tmp_path / "raw.wtns")
    raw_wtns(raw, w + UNREDUCED)
    rows = read_wtns(raw)
    assert row_ints(rows) == ref_read_wtns(raw) == w + UNREDUCED  # the file's values, unreduced
    assert row_ints(reduce_rows(rows)) == [v % R for v in w + UNREDUCED]
    small = rows[: len(w)]
    assert reduce_rows(small) is small  # nothing to reduce: no copy


@pytest.mark.parametrize("form", ["ints", "u64 rows"])
def test_write_wtns_matches_reference(bits, tmp_path, form):
    values = bits[4] + UNREDUCED
    ref_write_wtns(values, str(tmp_path / "ref.wtns"))
    write_wtns(values if form == "ints" else rows_of(values), str(tmp_path / "port.wtns"))
    assert (tmp_path / "port.wtns").read_bytes() == (tmp_path / "ref.wtns").read_bytes()


def test_read_wtns_rejects_other_files(tmp_path):
    p = str(tmp_path / "w.wtns")
    raw_wtns(p, [1, 2, 3])
    data = bytearray(open(p, "rb").read())
    for name, edit in (("magic", lambda d: d.__setitem__(slice(0, 4), b"r1cs")),
                       ("prime", lambda d: d.__setitem__(slice(28, 60), (R + 2).to_bytes(32, "little"))),
                       ("short", lambda d: d.__delitem__(slice(len(d) - 32, len(d))))):
        bad = bytearray(data)
        edit(bad)
        q = tmp_path / f"{name}.wtns"
        q.write_bytes(bytes(bad))
        with pytest.raises(ValueError):
            read_wtns(str(q))


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunks"])
def test_write_zkey_data_gives_back_the_reference_file(bits, tmp_path, chunked):
    path = bits[3]
    src = split_zkey(path, n_chunks=10) if chunked else path
    out = str(tmp_path / "again.zkey")
    write_zkey_data(out, read_zkey(src))
    assert open(out, "rb").read() == open(path, "rb").read()


def test_proof_and_vkey_json_match_reference(bits, tmp_path):
    cs, pk, vk, path, w = bits
    ref = prove_host(pk, cs, w, 12, 23)
    proof = Proof(a=ref.a, b=port_g2(ref.b), c=ref.c)
    pub = w[1:2] + [R + 5]
    for name, port, want in (
        ("proof", proof_json.proof_to_json(proof), ref_json.proof_to_json(ref)),
        ("public", proof_json.public_to_json(pub), ref_json.public_to_json(pub)),
        ("vkey", proof_json.vkey_to_json(port_vk(vk)), ref_json.vkey_to_json(vk)),
    ):
        proof_json.dump(port, str(tmp_path / f"{name}.port.json"))
        ref_json.dump(want, str(tmp_path / f"{name}.ref.json"))
        assert (tmp_path / f"{name}.port.json").read_bytes() == (tmp_path / f"{name}.ref.json").read_bytes(), name
    back = proof_json.proof_from_json(proof_json.load(str(tmp_path / "proof.port.json")))
    assert (back.a, back.c) == (proof.a, proof.c) and port_g2(ref.b) == back.b
    got_vk = proof_json.vkey_from_json(proof_json.load(str(tmp_path / "vkey.port.json")))
    assert got_vk.ic == vk.ic and got_vk.gamma_2 == port_g2(vk.gamma_2) and got_vk.n_public == vk.n_public


def test_point_at_infinity_has_no_json_form(bits):
    """The reference asserts; the port raises ValueError."""
    ref = prove_host(bits[1], bits[0], bits[4], 12, 23)
    for proof in (Proof(a=None, b=port_g2(ref.b), c=ref.c), Proof(a=ref.a, b=None, c=ref.c)):
        with pytest.raises(ValueError, match="infinity"):
            proof_json.proof_to_json(proof)
        with pytest.raises(AssertionError):
            ref_json.proof_to_json(proof)
