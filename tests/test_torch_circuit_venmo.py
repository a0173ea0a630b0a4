"""The flagship circuit, P2POnrampVerify, built by the port
(zkp2p_tpu_torch.models.venmo) against the reference's builder, on the
CPU, at VenmoParams(256, 192): the smallest venmo shape the synthetic
signed email fits (499,142 constraints).  Built once a package for the
module (about 10 s each).

The constraint systems are equal field by field (see
test_torch_circuits.assert_same_cs); the inputs that generate_inputs
makes from two synthetic Venmo emails (different ids, amounts, order and
claim ids) are equal, and so are the witnesses, values and u64 rows; the
port's witness_batch over both gives its witnesses.  Tolerance: none."""

import dataclasses

import pytest

from zkp2p_tpu.inputs import email as ref_email
from zkp2p_tpu.models import venmo as ref_venmo

from test_torch_circuits import assert_batch_matches, assert_same_cs, assert_same_witness
from zkp2p_tpu_torch.inputs import email as port_email
from zkp2p_tpu_torch.models import venmo as port_venmo

EMAILS = (dict(kw={}, order_id=1, claim_id=0),
          dict(kw={"raw_id": "9876543210987654321", "amount": "42", "body_filler": 3}, order_id=7, claim_id=2))


def _built(venmo, email):
    params = venmo.VenmoParams(max_header_bytes=256, max_body_bytes=192)
    cs, lay = venmo.build_venmo_circuit(params)
    key = email.make_test_key(1)
    mails = [email.make_venmo_email(key, **e["kw"]) for e in EMAILS]
    ins = [email.generate_inputs(m, key.n, e["order_id"], e["claim_id"], params, lay) for m, e in zip(mails, EMAILS)]
    return dict(params=params, lay=lay, cs=cs, mails=mails, ins=[(i.public_signals, i.seed) for i in ins])


@pytest.fixture(scope="module")
def built():
    return _built(ref_venmo, ref_email), _built(port_venmo, port_email)


def test_venmo_circuit_equals_the_reference(built):
    ref, port = built
    assert dataclasses.asdict(port["params"]) == dataclasses.asdict(ref["params"])
    assert dataclasses.asdict(port["lay"]) == dataclasses.asdict(ref["lay"])
    assert (port["cs"].num_constraints, port["cs"].num_wires, port["cs"].num_public) == (499_142, 496_864, 26)
    assert_same_cs(ref["cs"], port["cs"])


def test_venmo_inputs_and_witnesses_equal_the_reference(built):
    ref, port = built
    assert [dataclasses.asdict(m) for m in port["mails"]] == [dataclasses.asdict(m) for m in ref["mails"]]
    assert port["ins"] == ref["ins"]
    assert port["ins"][0][0] != port["ins"][1][0]
    want = []
    for pubs, seed in port["ins"]:
        w = port["cs"].witness(pubs, seed)
        assert_same_witness(ref["cs"].witness(pubs, seed), w)
        want.append(w)
    port["cs"].check_witness(want[0])
    assert_batch_matches(port["cs"], port["ins"], want)
