"""The port's phase-2 ceremony (zkp2p_tpu_torch.snark.ceremony) against the
reference's (zkp2p_tpu.snark.ceremony), on the CPU, over the reference's
test world (a 3-wire circuit, two contributions and a beacon at iter_exp
6): with secrets pinned the port's contribute and beacon write the
reference's bytes; each package's verify_chain accepts the other's chain
with the same log; circuit_hash and hash_to_g2 agree; the MPC section
round-trips; and every tamper scenario of tests/test_ceremony.py is
rejected by the port.  The prefixes, the command line and a proof under
the final key are in test_torch_ceremony_cli.py and
test_torch_ceremony_prove.py, which build the same world."""

import contextlib
import hashlib
import secrets
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

from zkp2p_tpu.curve.host import g2_is_on_curve as ref_g2_is_on_curve
from zkp2p_tpu.curve.host import g2_mul as ref_g2_mul
from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.formats.zkey import read_zkey as ref_read_zkey
from zkp2p_tpu.formats.zkey import write_zkey
from zkp2p_tpu.snark import ceremony as ref
from zkp2p_tpu.snark.groth16 import qap_rows, setup
from zkp2p_tpu.snark.r1cs import LC, ConstraintSystem

from zkp2p_tpu_torch.curve.host import G1_GENERATOR, g1_add, g1_mul, g2_mul
from zkp2p_tpu_torch.curve.tcurve import g1_limbs
from zkp2p_tpu_torch.field.tfield import FQ
from zkp2p_tpu_torch.field.tower import Fq2
from zkp2p_tpu_torch.formats.zkey import _mpc_from_bytes, read_zkey, write_zkey_data
from zkp2p_tpu_torch.snark import ceremony

torch.set_num_threads(1)

BEACON = hashlib.sha256(b"public drand round").digest()
STEPS = (("contribute", b"first contributor entropy", "alice"), ("contribute", b"second contributor entropy", "bob"),
         ("beacon", BEACON, None))


@contextlib.contextmanager
def pinned(step: int):
    """secrets.token_bytes and secrets.randbelow fixed for one ceremony
    step: the same draws in both packages."""
    old = secrets.token_bytes, secrets.randbelow
    secrets.token_bytes = lambda n: hashlib.sha256(b"entropy %d" % step).digest()[:n]
    secrets.randbelow = lambda n: int.from_bytes(hashlib.sha512(b"s %d" % step).digest(), "little") % n
    try:
        yield
    finally:
        secrets.token_bytes, secrets.randbelow = old


def run_step(mod, i: int, src: str, dst: str, **kw):
    op, value, name = STEPS[i]
    with pinned(i):
        if op == "contribute":
            return mod.contribute(src, dst, value, name=name, **kw)
        return mod.beacon(src, dst, value, iter_exp=6, **kw)


def build_world(td):
    """The reference's world: its circuit, setup and initial zkey, then
    its chain (secrets pinned a step) z0 -> z1 -> z2 -> zf."""
    cs = ConstraintSystem("ceremony-demo")
    out = cs.new_public("out")
    x, y, z = cs.new_wire(), cs.new_wire(), cs.new_wire()
    cs.enforce(LC.of(x), LC.of(y), LC.of(z))
    cs.enforce(LC.of(z), LC.of(z), LC.of(out))
    cs.compute(z, lambda a, b: a * b % R, [x, y])
    pk, vk = setup(cs, seed="ceremony-test")
    paths = [str(td / f"{n}.zkey") for n in ("initial", "c1", "c2", "final")]
    write_zkey(paths[0], pk, vk, qap_rows(cs))
    for i in range(3):
        run_step(ref, i, paths[i], paths[i + 1])
    return (cs, x, y), *paths


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_world(tmp_path_factory.mktemp("ceremony"))


@pytest.fixture(scope="module")
def port_files(world, tmp_path_factory):
    """The port's contribute from the initial key and its beacon from the
    reference's c2, each with the draws the reference's step had."""
    _, z0, _, z2, _ = world
    td = tmp_path_factory.mktemp("port")
    p1, pf = str(td / "c1.zkey"), str(td / "final.zkey")
    run_step(ceremony, 0, z0, p1, device="cpu")
    run_step(ceremony, 2, z2, pf, device="cpu")
    return p1, pf


def same_bytes(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_contribute_and_beacon_write_the_reference_bytes(world, port_files):
    _, _, z1, _, zf = world
    p1, pf = port_files
    assert same_bytes(p1, z1)
    assert same_bytes(pf, zf)


def test_each_verify_chain_accepts_the_others_chain(world, port_files):
    _, z0, _, _, zf = world
    stages = {}
    ok, log = ceremony.verify_chain(z0, zf, device="cpu", stages=stages)
    assert ok, log
    assert any("beacon re-derived" in line for line in log)
    assert sum("PoK + delta link verified" in line for line in log) == 2
    assert {"s_read", "s_circuit_hash", "s_chain", "s_combo"} <= set(stages)
    ref_ok, ref_log = ref.verify_chain(z0, port_files[1])
    assert ref_ok and ref_log == log


def test_circuit_hash_and_hash_to_g2_match_the_reference(world):
    _, z0, _, _, zf = world
    for path in (z0, zf):
        assert ceremony.circuit_hash(read_zkey(path), device="cpu") == ref.circuit_hash(ref_read_zkey(path))
    for seed in (b"a", b"b", b"longer seed value"):
        got, want = ceremony.hash_to_g2(seed), ref.hash_to_g2(seed)
        assert [(c.c0, c.c1) for c in got] == [(c.c0, c.c1) for c in want]
        assert ref_g2_is_on_curve(want) and ref_g2_mul(want, R) is None
    assert ceremony.G2_COFACTOR == ref.G2_COFACTOR and ceremony.MAX_BEACON_ITER_EXP == ref.MAX_BEACON_ITER_EXP
    assert ceremony.beacon_delta(BEACON.ljust(64, b"\x00"), 3) == ref.beacon_delta(BEACON.ljust(64, b"\x00"), 3)


def test_mpc_section_roundtrips(world, tmp_path):
    _, _, _, _, zf = world
    zd = read_zkey(zf)
    assert zd.mpc is not None and len(zd.mpc.contributions) == 3
    assert zd.mpc.contributions[0].name == "alice" and zd.mpc.contributions[1].name == "bob"
    assert zd.mpc.contributions[2].kind == 1 and zd.mpc.contributions[2].beacon_iter_exp == 6
    out = str(tmp_path / "again.zkey")
    write_zkey_data(out, zd)
    assert same_bytes(out, zf)


def test_foreign_mpc_section_imports_as_none():
    garbage = b"\x00" * 64 + (3).to_bytes(4, "little") + b"\x17" * 200
    assert _mpc_from_bytes(garbage) is None
    huge_count = b"\x00" * 64 + (2**31).to_bytes(4, "little")
    assert _mpc_from_bytes(huge_count) is None
    empty = _mpc_from_bytes(b"\x00" * 64 + (0).to_bytes(4, "little"))
    assert empty.cs_hash == b"\x00" * 64 and empty.contributions == []


def rejected(z0, zd, tmp_path, name):
    bad = str(tmp_path / f"{name}.zkey")
    write_zkey_data(bad, zd)
    return ceremony.verify_chain(z0, bad, device="cpu")


def test_forged_delta_rejected(world, tmp_path):
    _, z0, _, _, zf = world
    zd = read_zkey(zf)
    ok, log = rejected(z0, replace(zd, delta_1=g1_mul(zd.delta_1, 3), delta_2=g2_mul(zd.delta_2, 3)), tmp_path,
                       "forged")
    assert not ok and "chain head" in log[-1]


def test_tampered_query_rejected(world, tmp_path):
    """One C query point moved by the generator, the deltas untouched."""
    _, z0, _, _, zf = world
    zd = read_zkey(zf)
    x, y = (c.copy() for c in zd.c_query)
    i = int(np.flatnonzero(x.any(axis=1) | y.any(axis=1))[0])
    moved = g1_add((FQ.from_mont_host(x[i]), FQ.from_mont_host(y[i])), G1_GENERATOR)
    (x[i],), (y[i],) = g1_limbs([moved])
    ok, log = rejected(z0, replace(zd, c_query=(x, y)), tmp_path, "backdoor")
    assert not ok and "C query" in log[-1]


def test_tampered_transcript_rejected(world, tmp_path):
    _, z0, _, _, zf = world
    zd = read_zkey(zf)
    c0 = replace(zd.mpc.contributions[0], transcript=bytes(64))
    ok, log = rejected(z0, replace(zd, mpc=replace(zd.mpc, contributions=[c0] + zd.mpc.contributions[1:])),
                       tmp_path, "transcript")
    assert not ok and "transcript hash mismatch" in log[-1]


def test_beacon_value_is_binding(world, tmp_path):
    _, z0, _, _, zf = world
    zd = read_zkey(zf)
    last = replace(zd.mpc.contributions[-1], beacon_hash=hashlib.sha256(b"rigged").digest())
    ok, log = rejected(z0, replace(zd, mpc=replace(zd.mpc, contributions=zd.mpc.contributions[:-1] + [last])),
                       tmp_path, "rigged")
    assert not ok


def test_offcurve_pok_point_rejected(world, tmp_path):
    _, z0, _, _, zf = world
    zd = read_zkey(zf)
    c0 = replace(zd.mpc.contributions[0], pok_g2_spx=(Fq2(1, 2), Fq2(3, 4)))  # not on the twist
    ok, log = rejected(z0, replace(zd, mpc=replace(zd.mpc, contributions=[c0] + zd.mpc.contributions[1:])),
                       tmp_path, "offcurve")
    assert not ok and "off-curve" in log[-1]


def test_huge_beacon_iter_exp_rejected_fast(world, tmp_path):
    _, z0, _, _, zf = world
    zd = read_zkey(zf)
    last = replace(zd.mpc.contributions[-1], beacon_iter_exp=63)
    t0 = time.time()
    ok, log = rejected(z0, replace(zd, mpc=replace(zd.mpc, contributions=zd.mpc.contributions[:-1] + [last])),
                       tmp_path, "dos")
    assert not ok and time.time() - t0 < 30
    assert any("over cap" in line for line in log)
    with pytest.raises(ValueError, match="iter_exp"):
        ceremony.beacon(z0, str(tmp_path / "never.zkey"), BEACON, iter_exp=33, device="cpu")
    assert not (tmp_path / "never.zkey").exists()


def test_truncated_h_query_rejected(world, tmp_path):
    """A final key whose H section is two points short fails, as a file
    the port writes and as one the reference writes."""
    from zkp2p_tpu.formats.zkey import write_zkey_data as ref_write_zkey_data

    _, z0, _, _, zf = world
    zd = read_zkey(zf)
    ok, log = rejected(z0, replace(zd, h_query=tuple(c[:-2] for c in zd.h_query)), tmp_path, "short_h")
    assert not ok and log[-1].startswith("FAIL")
    rd = ref_read_zkey(zf)
    bad = str(tmp_path / "ref_short_h.zkey")
    ref_write_zkey_data(bad, replace(rd, h_query=rd.h_query[:-2]))
    assert not ceremony.verify_chain(z0, bad, device="cpu")[0]
    assert not ref.verify_chain(z0, bad)[0]


@pytest.mark.parametrize("edit", ["short", "hole"])
def test_combination_hole_rules(world, edit):
    """verify_zkeys on parsed keys: a C query two points short (in memory,
    where no reader stops it) or with a hole on the final side only fails
    the scaling check."""
    _, z0, _, _, zf = world
    zi, zd = read_zkey(z0), read_zkey(zf)
    if edit == "short":
        c = tuple(q[:-2] for q in zd.c_query)
    else:
        c = tuple(q.copy() for q in zd.c_query)
        i = int(np.flatnonzero(c[0].any(axis=1) | c[1].any(axis=1))[0])
        c[0][i] = c[1][i] = 0
    ok, log = ceremony.verify_zkeys(zi, replace(zd, c_query=c), device="cpu")
    assert not ok and "C query" in log[-1]
