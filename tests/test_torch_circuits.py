"""The port's circuit builders, gadgets, inputs and audit
(zkp2p_tpu_torch.snark.r1cs, gadgets/, regexc/, models/, inputs/,
snark.analysis) against the reference's, on the CPU.

Each case builds the same circuit with both packages and compares it
field by field: the wire and public counts, every constraint's a/b/c
terms (in their order) and tag, the wire widths, labels, waivers, width
demands, input wires and the hook program's shape; then the witness for
the same inputs (values and the u64 rows it carries), and the port's
witness_batch against its witness.  The synthetic emails and the inputs
made from them are equal byte for byte; the audit reports are equal,
timings aside.  Tolerance: none (equal ints, equal bytes).  The venmo
circuit, the largest, is in test_torch_circuit_venmo.py."""

import argparse
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import zkp2p_tpu.gadgets.base64 as ref_b64
import zkp2p_tpu.gadgets.bigint as ref_bigint
import zkp2p_tpu.gadgets.core as ref_core
import zkp2p_tpu.gadgets.poseidon as ref_poseidon
import zkp2p_tpu.gadgets.poseidon_params as ref_pp
import zkp2p_tpu.gadgets.regex as ref_regex
import zkp2p_tpu.inputs.email as ref_email
import zkp2p_tpu.inputs.sha_host as ref_sha_host
import zkp2p_tpu.models.amount_demo as ref_amount
import zkp2p_tpu.models.email_verify as ref_ev
import zkp2p_tpu.regexc.compiler as ref_regexc
import zkp2p_tpu.snark.analysis as ref_analysis
import zkp2p_tpu.snark.r1cs as ref_r1cs
from zkp2p_tpu.pipeline import cli as ref_cli

import zkp2p_tpu_torch.gadgets.base64 as port_b64
import zkp2p_tpu_torch.gadgets.bigint as port_bigint
import zkp2p_tpu_torch.gadgets.core as port_core
import zkp2p_tpu_torch.gadgets.poseidon as port_poseidon
import zkp2p_tpu_torch.gadgets.poseidon_params as port_pp
import zkp2p_tpu_torch.gadgets.regex as port_regex
import zkp2p_tpu_torch.inputs.email as port_email
import zkp2p_tpu_torch.inputs.sha_host as port_sha_host
import zkp2p_tpu_torch.models.amount_demo as port_amount
import zkp2p_tpu_torch.models.email_verify as port_ev
import zkp2p_tpu_torch.regexc.compiler as port_regexc
import zkp2p_tpu_torch.snark.analysis as port_analysis
import zkp2p_tpu_torch.snark.r1cs as port_r1cs
from zkp2p_tpu_torch.pipeline import cli as port_cli

REF = SimpleNamespace(b64=ref_b64, bigint=ref_bigint, core=ref_core, poseidon=ref_poseidon, pp=ref_pp,
                      regex=ref_regex, email=ref_email, sha_host=ref_sha_host, amount=ref_amount, ev=ref_ev,
                      regexc=ref_regexc, analysis=ref_analysis, r1cs=ref_r1cs, cli=ref_cli)
PORT = SimpleNamespace(b64=port_b64, bigint=port_bigint, core=port_core, poseidon=port_poseidon, pp=port_pp,
                       regex=port_regex, email=port_email, sha_host=port_sha_host, amount=port_amount, ev=port_ev,
                       regexc=port_regexc, analysis=port_analysis, r1cs=port_r1cs, cli=port_cli)


def structure(cs):
    """Everything a constraint system holds but its hook callables."""
    hooks = [(type(h).__name__, list(h.outs), list(h.ins), getattr(h, "int64", None)) for h in cs.hooks]
    return dict(name=cs.name, num_wires=cs.num_wires, num_public=cs.num_public,
                wire_width=list(cs.wire_width.items()), labels=list(cs.labels.items()),
                audit_waivers=list(cs.audit_waivers.items()), input_wires=sorted(cs.input_wires),
                width_demands=list(cs.width_demands), hooks=hooks)


def assert_same_cs(ref, port):
    assert type(port).__module__ == "zkp2p_tpu_torch.snark.r1cs"
    assert port.num_constraints == ref.num_constraints
    for i, (x, y) in enumerate(zip(ref.constraints, port.constraints)):
        if (list(x.a.items()), list(x.b.items()), list(x.c.items()), x.tag) != (
                list(y.a.items()), list(y.b.items()), list(y.c.items()), y.tag):
            raise AssertionError(f"constraint {i} differs: {x} against {y}")
    assert structure(port) == structure(ref)


def assert_same_witness(ref_w, port_w):
    assert type(port_w).__module__ == "zkp2p_tpu_torch.snark.r1cs"
    assert list(port_w) == list(ref_w)
    assert port_w.u64.dtype == np.uint64 and np.array_equal(port_w.u64, ref_w.u64)


def assert_batch_matches(cs, inputs, want):
    """witness_batch over `inputs` gives the scalar witnesses `want`,
    values and u64 rows."""
    got = cs.witness_batch(inputs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w) and np.array_equal(g.u64, w.u64)


# ------------------------------------------------------------ the circuits
# Each builder takes a package namespace and returns (cs, [(public
# inputs, private inputs), ...]) for two inputs.


def _cli_args(circuit, message):
    return argparse.Namespace(circuit=circuit, message=message, eml=None, order_id=1, claim_id=0)


def toy(P):
    cs, meta = P.cli._build_circuit("toy", 256, 192)
    x, y, _ = meta[1]
    ins = []
    for msg in (b"57", b"\xff\x02"):
        out = pow(msg[0] * msg[1], 2, port_r1cs.R)
        ins.append(([out], {x: msg[0], y: msg[1]}))
    return cs, ins


def sha256(P):
    cs, (_, msg) = P.cli._build_circuit("sha256", 64, 0)
    ins = []
    for data in (b"zkp2p", b"the smallest header"):
        padded, _ = P.sha_host.sha256_pad(data, len(msg))
        ins.append(([], dict(zip(msg, padded))))
    return cs, ins


def base64(P):
    R1 = P.r1cs
    cs = R1.ConstraintSystem("b64")
    chars = cs.new_wires(8, "c")
    cs.mark_input(chars)
    bits = P.core.assert_bytes(cs, chars, "c")
    cache = P.regex.CharClassCache(cs)
    for w, b in zip(chars, bits):
        cache.register_bits(w, b)
    P.b64.base64_decode_bits(cs, chars, cache)
    return cs, [([], dict(zip(chars, s))) for s in (b"QUJDRA==", b"+/09az==")]


def bigint(P):
    n, k = 16, 4
    cs = P.r1cs.ConstraintSystem("mulmod")
    wires = {name: P.bigint.alloc_limbs(cs, k, name) for name in "abp"}
    for name, ws in wires.items():
        P.bigint.range_check_limbs(cs, ws, n, name)
    P.bigint.big_mult_mod(cs, wires["a"], wires["b"], wires["p"], n)
    ins = []
    for a, b, p in ((12345678901, 98765432109, (1 << 63) + 29), (3, (1 << 62) + 5, (1 << 63) + 11)):
        seed = {}
        for name, v in zip("abp", (a, b, p)):
            seed.update(zip(wires[name], P.bigint.int_to_limbs_host(v, n, k)))
        ins.append(([], seed))
    return cs, ins


def regex(P):
    cs, lay = P.regexc.reveal_circuit(P.regexc.VENMO_ACTOR_ID, n_bytes=48, reveal_len=14, name="rx")
    ins = []
    for digits in (b"4499332177", b"12345678901234"):
        data = b"xx actor_id=3D" + digits + b" yy"
        data += b"\x00" * (48 - len(data))
        seed = dict(zip(lay["data"], data))
        seed[lay["idx"]] = data.find(digits)
        ins.append((P.email.pack_bytes_le(digits + b"\x00" * (14 - len(digits)), 7), seed))
    return cs, ins


def poseidon(P):
    LC = P.r1cs.LC
    cs = P.r1cs.ConstraintSystem("pos")
    out = cs.new_public("h")
    xs = cs.new_wires(3, "x")
    cs.mark_input(xs)
    h = P.poseidon.poseidon(cs, xs, "pos")
    cs.enforce_eq(LC.of(h), LC.of(out), "pos/out")
    return cs, [([P.pp.poseidon_hash(v)], dict(zip(xs, v))) for v in ([1, 2, 3], [port_r1cs.R - 1, 0, 12345])]


def registry(name):
    """The registry's small circuits with their own inputs."""
    def build(P):
        cs, pubs, seed = getattr(P.amount, name)()
        return cs, [(pubs, seed)]
    return build


CASES = {"toy": toy, "sha256": sha256, "base64": base64, "bigint": bigint, "regex": regex,
         "poseidon": poseidon, "amount_demo": registry("amount_circuit"), "dryrun_vid": registry("dryrun_circuit")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_circuit_and_witness_equal_the_reference(case):
    ref_cs, ref_ins = CASES[case](REF)
    port_cs, port_ins = CASES[case](PORT)
    assert_same_cs(ref_cs, port_cs)
    assert port_ins == ref_ins
    want = []
    for (pubs, seed) in port_ins:
        w = port_cs.witness(pubs, seed)
        assert_same_witness(ref_cs.witness(pubs, seed), w)
        port_cs.check_witness(w)
        want.append(w)
    assert_batch_matches(port_cs, port_ins, want)


def test_cli_witness_builders_equal_the_reference():
    """The CLI's toy and sha256 witness builders (--message and the
    default messages) give the reference CLI's witness and publics."""
    for circuit, header, messages in (("toy", 256, ("57", None)), ("sha256", 64, ("abc", None))):
        ref_cs, ref_meta = ref_cli._build_circuit(circuit, header, 0)
        port_cs, port_meta = port_cli._build_circuit(circuit, header, 0)
        for msg in messages:
            args = _cli_args(circuit, msg)
            rw, rp = ref_cli._witness_for(args, ref_cs, ref_meta)
            pw, pp = port_cli._witness_for(args, port_cs, port_meta)
            assert pp == rp
            assert_same_witness(rw, pw)


def test_unknown_circuit_and_unsatisfied_witness_raise_as_the_reference():
    with pytest.raises(SystemExit, match="unknown circuit 'rsa'"):
        port_cli._build_circuit("rsa", 256, 192)
    cs, ins = toy(PORT)
    bad = cs.witness([ins[0][0][0] + 1], ins[0][1])
    with pytest.raises(AssertionError, match=r"constraint 1 \(sq\) unsatisfied"):
        cs.check_witness(bad)
    with pytest.raises(ValueError, match="expected 1 public inputs, got 0"):
        cs.witness([], ins[0][1])


# ------------------------------------------------------- the audit (gate)


@pytest.mark.parametrize("case", ["toy", "sha256"])
def test_audit_reports_equal_the_reference(case):
    ref_cs, _ = CASES[case](REF)
    port_cs, _ = CASES[case](PORT)
    ref_rep = ref_analysis.audit_circuit(ref_cs, name=case, use_cache=False)
    port_rep = port_analysis.audit_circuit(port_cs, name=case, use_cache=False)
    timing = {"audit_s"}
    assert {k: v for k, v in port_rep.items() if k not in timing} == \
        {k: v for k, v in ref_rep.items() if k not in timing}
    assert port_analysis.require_clean(port_rep) is port_rep


def test_audit_refuses_an_unconstrained_wire(tmp_path):
    """The admission gate raises on the findings the reference's raises
    on, and the cache round trip keeps the report."""
    reps = []
    for P in (REF, PORT):
        cs = P.r1cs.ConstraintSystem("loose")
        out = cs.new_public("out")
        x = cs.new_wire("x")
        cs.new_wire("free")
        cs.mark_input(x)
        cs.enforce(P.r1cs.LC.of(x), P.r1cs.LC.of(x), P.r1cs.LC.of(out), "sq")
        rep = P.analysis.audit_circuit(cs, cache_dir=str(tmp_path / P.r1cs.__name__))
        with pytest.raises(P.analysis.CircuitAuditError, match="REFUSED admission"):
            P.analysis.require_clean(rep)
        again = P.analysis.audit_circuit(cs, cache_dir=str(tmp_path / P.r1cs.__name__))
        assert again["source"] == "cache" and again["findings"] == rep["findings"]
        reps.append(rep)
    assert reps[1]["findings"] == reps[0]["findings"] and reps[1]["digest"] == reps[0]["digest"]


# ------------------------------------------------------------ the inputs


@pytest.fixture(scope="module")
def keys():
    return ref_email.make_test_key(1), port_email.make_test_key(1)


def test_synthetic_emails_equal_the_reference(keys):
    rk, pk = keys
    assert (pk.n, pk.d, pk.e) == (rk.n, rk.d, rk.e)
    for kw in ({}, {"raw_id": "9876543210987654321", "amount": "1234", "body_filler": 5}):
        assert dataclasses.asdict(port_email.make_venmo_email(pk, **kw)) == \
            dataclasses.asdict(ref_email.make_venmo_email(rk, **kw))
    for kw in ({}, {"handle": "someone_else", "filler": 9}):
        assert dataclasses.asdict(port_email.make_twitter_email(pk, **kw)) == \
            dataclasses.asdict(ref_email.make_twitter_email(rk, **kw))


def test_email_verify_circuit_inputs_and_witness_equal_the_reference(keys):
    """The email_verify circuit at the smallest shape the demo email fits
    (256/128), its inputs from the synthetic twitter email, its witness
    and witness_batch."""
    rk, pk = keys
    built = []
    for P, key in ((REF, rk), (PORT, pk)):
        params = P.ev.EmailVerifyParams(max_header_bytes=256, max_body_bytes=128)
        cs, lay = P.ev.build_email_verify(params)
        ins = [P.email.generate_email_verify_inputs(P.email.make_twitter_email(key, handle=h), key.n, params, lay)
               for h in ("zk_pranker", "other_one")]
        built.append((cs, [(i.public_signals, i.seed) for i in ins]))
    (ref_cs, ref_ins), (port_cs, port_ins) = built
    assert_same_cs(ref_cs, port_cs)
    assert port_ins == ref_ins
    want = []
    for pubs, seed in port_ins:
        w = port_cs.witness(pubs, seed)
        assert_same_witness(ref_cs.witness(pubs, seed), w)
        want.append(w)
    port_cs.check_witness(want[0])
    assert_batch_matches(port_cs, port_ins, want)


def test_key_arrays_of_a_circuit_equal_the_loops():
    """On the sha256 circuit: the QAP rows' COO arrays (each distinct
    coefficient converted once and gathered), the width array and the
    witness's u64 rows (the ones it carries) equal what the per-entry
    loops give."""
    from zkp2p_tpu_torch.field.tfield import mont_limbs
    from zkp2p_tpu_torch.formats.circom_bin import scalars_to_u64
    from zkp2p_tpu_torch.prover import groth16_gpu as gp
    from zkp2p_tpu_torch.snark.groth16 import domain_size_for, qap_rows

    R = port_r1cs.R
    cs, ins = sha256(PORT)
    rows = qap_rows(cs)
    m = domain_size_for(len(rows))
    for k in range(3):
        entries = [(c % R, wire, j) for j, t in enumerate(rows) for wire, c in t[k].items()]
        got = gp._rows_to_arrays([t[k] for t in rows], m)
        want = (mont_limbs([e[0] for e in entries], R), np.array([e[1] for e in entries], np.int32),
                np.array([e[2] for e in entries], np.int32))
        assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))
    empty = gp._rows_to_arrays([{}, {}], 8)
    assert not empty[0].any() and empty[1].tolist() == [0] and empty[2].tolist() == [7]
    widths = np.full(cs.num_wires, 254, np.int32)
    for wire, bits in cs.wire_width.items():
        widths[wire] = bits
    assert np.array_equal(gp.widths_array(cs), widths)
    w = cs.witness(*ins[0])
    assert gp._as_u64(w) is w.u64 and np.array_equal(w.u64, scalars_to_u64([int(v) % R for v in w]))
    assert np.array_equal(gp._as_u64(list(w)), w.u64)
