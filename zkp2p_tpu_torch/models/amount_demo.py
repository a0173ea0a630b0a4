"""The amount-extraction demo circuit: a small REAL member of the model
family (the Venmo amount block of `circuit/circuit.circom:225-272`) —
byte range checks, the VenmoAmountRegex DFA scan with exact match count,
masked reveal, one-hot shift window, 7-byte packing — over a 32-byte
subject slice (~3.4k constraints).

Small enough for a 1-core host, real enough to exercise the whole
gadget stack.
"""

from __future__ import annotations

AMOUNT_LEN = 21
SUBJ_LEN = 32


def amount_circuit():
    """-> (ConstraintSystem, public signal values, witness seed)."""
    subj_len, amount_len, subj = SUBJ_LEN, AMOUNT_LEN, b"subject:$42.00\r\n"
    from ..gadgets import core
    from ..gadgets.regex import CharClassCache, dfa_scan, match_count, reveal_bytes
    from ..inputs.email import pack_bytes_le
    from ..models import common
    from ..models.venmo import _amount_reveal_states
    from ..regexc import compiler as regexc
    from ..snark.r1cs import LC, ConstraintSystem

    n_words = (amount_len + 6) // 7
    cs = ConstraintSystem("graft_amount")
    amount_words = [cs.new_public(f"amount[{i}]") for i in range(n_words)]
    subject = cs.new_wires(subj_len, "subject")
    amount_idx = cs.new_wire("amount_idx")
    cs.mark_input(subject + [amount_idx])  # the witness seed keys below
    bits = core.assert_bytes(cs, subject, "subj")
    cache = CharClassCache(cs)
    for w, b in zip(subject, bits):
        cache.register_bits(w, b)
    dfa = regexc.search_dfa(regexc.VENMO_AMOUNT)
    states = dfa_scan(cs, list(subject), dfa, cache, "amt")
    cnt = match_count(cs, states, dfa.accept, "amt.cnt")
    cs.enforce_eq(LC.of(cnt), LC.const(1), "amt/count")
    reveal = reveal_bytes(cs, subject, states, _amount_reveal_states(dfa), "amt.rev")
    onehot = core.one_hot(cs, amount_idx, subj_len - amount_len, "amt.idx")
    chars = common.shift_window(cs, reveal, onehot, amount_len, "amt.shift")
    words = core.pack_bytes(cs, chars, 7, "amt.pack")
    for w, pub in zip(words, amount_words):
        cs.enforce_eq(LC.of(w), LC.of(pub), "amt/out")

    # $ must sit inside the one-hot window (subj_len - amount_len lanes)
    subj = subj + b"\x00" * (subj_len - len(subj))
    amt_start = subj.find(b"$") + 1
    amt = subj[amt_start:subj.index(b".", amt_start) + 1]
    amt = amt + b"\x00" * (amount_len - len(amt))
    pubs = pack_bytes_le(amt, 7)
    seed = {w: b for w, b in zip(subject, subj)}
    seed[amount_idx] = amt_start
    return cs, pubs, seed


def dryrun_circuit():
    """Tiny-shape member of the flagship's gadget stack: the venmo-id
    packing + Poseidon block (models/venmo.py vid.pack / vid.pos,
    `circuit/circuit.circom:189-218`) over an 8-byte id — 319
    constraints, domain 512; the whole prove dataflow at the smallest
    faithful shape.
    -> (ConstraintSystem, public values, witness seed)"""
    from ..gadgets import core
    from ..gadgets.poseidon import poseidon
    from ..gadgets.poseidon_params import poseidon_hash
    from ..inputs.email import pack_bytes_le
    from ..snark.r1cs import LC, ConstraintSystem

    raw = b"44993321"
    cs = ConstraintSystem("graft_dryrun_vid")
    out = cs.new_public("hashed_id")
    wires = cs.new_wires(len(raw), "id")
    cs.mark_input(wires)  # the witness seed keys below
    core.assert_bytes(cs, wires, "id")
    words = core.pack_bytes(cs, wires, 7, "id.pack")
    h = poseidon(cs, words, "id.pos")
    cs.enforce_eq(LC.of(h), LC.of(out), "id/out")
    pubs = [poseidon_hash(pack_bytes_le(raw, 7))]
    seed = {w: b for w, b in zip(wires, raw)}
    return cs, pubs, seed
