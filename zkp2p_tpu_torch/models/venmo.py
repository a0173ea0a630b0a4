"""The flagship model: P2POnrampVerify — Venmo DKIM payment-receipt circuit.

Rebuild of `circuit/circuit.circom:17-310` (`P2POnrampVerify(max_header,
max_body, n, k)`), block for block:

  header SHA-256            (:67-82)   -> gadgets.sha256 (variable length)
  RSA-2048 e=65537          (:86-98)   -> gadgets.rsa
  DKIM to/from regex ==2    (:102-110) -> gadgets.regex + regexc DFA
  body-hash regex ==1       (:115-119) -> gadgets.regex
  bh= extraction + shift    (:115-132) -> one-hot shift matrix
  partial body SHA          (:137-156) -> gadgets.sha256 midstate resume
  base64(bh) == body hash   (:137-156) -> gadgets.base64
  offramper-ID regex+reveal (:162-218) -> gadgets.regex reveal + shift
  7-byte packing + Poseidon (:189-218) -> gadgets.core.pack_bytes + poseidon
  amount regex + packing    (:225-272) -> same machinery on the subject
  nullifier = sig[0:3]      (:291-294)
  order/claim binding        (:297-304)

Public signal layout (the uint[26] `contracts/Verifier.sol:360` /
`Ramp.sol:253-293` contract expects):
  [0]     Poseidon(packed venmo id)
  [1:4]   packed amount (3 x 7-byte words)
  [4:7]   nullifier (first 3 signature limbs)
  [7:24]  RSA modulus (17 x 121-bit limbs)
  [24]    order id     [25] claim id

Parameterised so CI can build a miniature instance (small max lengths)
while bench builds the production 1024/6400 shape — the reference bakes
one instantiation (`main = P2POnrampVerify(1024, 6400, 121, 17)`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..field.bn254 import R

from ..gadgets import core, rsa, sha256
from ..gadgets.poseidon import poseidon
from ..gadgets.regex import CharClassCache, dfa_scan, match_count, reveal_bytes
from ..regexc import compiler as regexc
from ..snark.r1cs import LC, ConstraintSystem
from . import common


@dataclass
class VenmoParams:
    max_header_bytes: int = 1024
    max_body_bytes: int = 6400
    n: int = 121
    k: int = 17
    bh_b64_len: int = 44  # base64(SHA-256) incl padding
    id_len: int = 28  # venmo id + soft wrap, zero padded (venmoHash.ts:3-44)
    amount_len: int = 21  # 3 packed words (Ramp.sol signals [1:4])
    dkim_match_count: int = 2  # to: and from: (circuit.circom:106)
    id_match_count: int = 1


@dataclass
class VenmoLayout:
    """Wire indices for input seeding (the circuit's `input.json` shape:
    SURVEY.md §2.3 sample input)."""

    hashed_id: int = 0
    amount_words: List[int] = field(default_factory=list)
    nullifier: List[int] = field(default_factory=list)
    modulus: List[int] = field(default_factory=list)
    order_id: int = 0
    claim_id: int = 0
    header: List[int] = field(default_factory=list)
    header_blocks: int = 0
    signature: List[int] = field(default_factory=list)
    body: List[int] = field(default_factory=list)
    body_blocks: int = 0
    midstate_bits: List[int] = field(default_factory=list)
    body_hash_idx: int = 0
    amount_idx: int = 0
    id_idx: int = 0
    order_sq: int = 0
    claim_sq: int = 0


# Shared with models.email_verify — hoisted to models.common so soundness
# fixes land in one place (see the round-2 bh= divergence).
_shift_window = common.shift_window


def build_venmo_circuit(p: VenmoParams) -> tuple[ConstraintSystem, VenmoLayout]:
    assert p.max_header_bytes % 64 == 0 and p.max_body_bytes % 64 == 0
    cs = ConstraintSystem("p2p_onramp_verify")
    lay = VenmoLayout()

    # ---- public signals, contract order (Ramp.sol:253-293)
    lay.hashed_id = cs.new_public("hashed_venmo_id")
    lay.amount_words = [cs.new_public(f"amount[{i}]") for i in range(3)]
    lay.nullifier = [cs.new_public(f"nullifier[{i}]") for i in range(3)]
    lay.modulus = [cs.new_public(f"modulus[{i}]") for i in range(p.k)]
    lay.order_id = cs.new_public("order_id")
    lay.claim_id = cs.new_public("claim_id")

    # ---- private inputs
    lay.header = cs.new_wires(p.max_header_bytes, "in_padded")
    header_blocks = cs.new_wire("in_len_blocks")
    lay.header_blocks = header_blocks
    lay.signature = cs.new_wires(p.k, "signature")
    lay.body = cs.new_wires(p.max_body_bytes, "in_body_padded")
    body_blocks = cs.new_wire("in_body_len_blocks")
    lay.body_blocks = body_blocks
    lay.midstate_bits = cs.new_wires(256, "precomputed_sha")
    lay.body_hash_idx = cs.new_wire("body_hash_idx")
    lay.amount_idx = cs.new_wire("venmo_amount_idx")
    lay.id_idx = cs.new_wire("venmo_offramper_id_idx")

    # prover-seeded inputs (the witness() private_inputs keys built by
    # inputs.email) — the audit's determinism sources and hook-coverage
    # exemptions (snark.analysis)
    cs.mark_input(
        lay.header + [header_blocks] + lay.signature + lay.body
        + [body_blocks] + lay.midstate_bits
        + [lay.body_hash_idx, lay.amount_idx, lay.id_idx]
    )

    header_bits = core.assert_bytes(cs, lay.header, "hdr")
    body_bits = core.assert_bytes(cs, lay.body, "body")
    for w in lay.midstate_bits:
        cs.enforce_bool(w, "midstate")

    # ---- header hash + RSA (circuit.circom:67-98)
    digest_bits = sha256.sha256_blocks(cs, header_bits, header_blocks, tag="sha_hdr")
    rsa.rsa_verify_65537(cs, lay.signature, lay.modulus, digest_bits, p.n, p.k, "rsa")

    # ---- header regexes (circuit.circom:102-132)
    cache = CharClassCache(cs)
    for w, bits in zip(lay.header, header_bits):
        cache.register_bits(w, bits)
    for w, bits in zip(lay.body, body_bits):
        cache.register_bits(w, bits)
    common.dkim_header_match(cs, lay.header, cache, p.dkim_match_count)

    # ---- bh= extraction + body hash equality (circuit.circom:115-156)
    # Shared soundness-critical block: see models.common.constrain_body_hash.
    common.constrain_body_hash(
        cs,
        lay.header,
        body_bits,
        body_blocks,
        lay.midstate_bits,
        lay.body_hash_idx,
        cache,
        p.max_header_bytes,
        p.bh_b64_len,
    )

    # ---- offramper id regex + reveal + hash (circuit.circom:162-218)
    # The `+`-terminated pattern re-accepts on every id char, so the match
    # count is data-length-dependent; like the reference (which only logs
    # it, circuit.circom:168-173) we rely on the reveal mask + the claim's
    # on-chain hash equality for soundness, not on an exact count.
    id_dfa = regexc.search_dfa(regexc.VENMO_OFFRAMPER_ID)
    id_states = dfa_scan(cs, list(lay.body), id_dfa, cache, "vid")
    id_reveal = reveal_bytes(cs, lay.body, id_states, sorted(id_dfa.accept), "vid.rev")

    id_onehot = core.one_hot(cs, lay.id_idx, p.max_body_bytes - p.id_len, "vid.idx")
    id_chars = _shift_window(cs, id_reveal, id_onehot, p.id_len, "vid.shift")
    # The window must anchor on a real revealed char: with an all-zero
    # reveal mask (no DFA match anywhere in the body) every shift window
    # is zero and a forged email could claim Poseidon(0..0).  x·x⁻¹ = 1
    # forces id_chars[0] != 0 — strictly stronger than the reference,
    # which only console-logs the match count (circuit.circom:168-173).
    id_inv = cs.new_wire("venmo_id_first_inv")
    cs.compute(id_inv, lambda v: pow(v, R - 2, R) if v else 0, [id_chars[0]])
    cs.enforce(LC.of(id_chars[0]), LC.of(id_inv), LC.const(1), "vid/nonzero")
    id_words = core.pack_bytes(cs, id_chars, 7, "vid.pack")
    hashed = poseidon(cs, id_words, "vid.pos")
    cs.enforce_eq(LC.of(hashed), LC.of(lay.hashed_id), "vid/out")

    # ---- amount regex on the subject line (circuit.circom:225-272)
    amt_dfa = regexc.search_dfa(regexc.VENMO_AMOUNT)
    amt_states = dfa_scan(cs, list(lay.header), amt_dfa, cache, "amt")
    amt_cnt = match_count(cs, amt_states, amt_dfa.accept, "amt.cnt")
    cs.enforce_eq(LC.of(amt_cnt), LC.const(1), "amt/count")
    amt_reveal = reveal_bytes(cs, lay.header, amt_states, _amount_reveal_states(amt_dfa), "amt.rev")
    amt_onehot = core.one_hot(cs, lay.amount_idx, p.max_header_bytes - p.amount_len, "amt.idx")
    amt_chars = _shift_window(cs, amt_reveal, amt_onehot, p.amount_len, "amt.shift")
    amt_words = core.pack_bytes(cs, amt_chars, 7, "amt.pack")
    for w, pub in zip(amt_words, lay.amount_words):
        cs.enforce_eq(LC.of(w), LC.of(pub), "amt/out")

    # ---- nullifier + order/claim binding (circuit.circom:291-304)
    for i in range(3):
        cs.enforce_eq(LC.of(lay.signature[i]), LC.of(lay.nullifier[i]), "null/eq")
    lay.order_sq = cs.new_wire("order_sq")
    cs.enforce(LC.of(lay.order_id), LC.of(lay.order_id), LC.of(lay.order_sq), "order/sq")
    cs.compute(lay.order_sq, lambda v: v * v % R, [lay.order_id])
    lay.claim_sq = cs.new_wire("claim_sq")
    cs.enforce(LC.of(lay.claim_id), LC.of(lay.claim_id), LC.of(lay.claim_sq), "claim/sq")
    cs.compute(lay.claim_sq, lambda v: v * v % R, [lay.claim_id])

    return cs, lay


def _amount_reveal_states(dfa) -> List[int]:
    """States reached after the '$' — everything except the roaming start
    component (state 0 and states only reachable without consuming '$')."""
    searching = {0}
    frontier = [0]
    while frontier:
        s = frontier.pop()
        for c in range(256):
            if c == ord("$"):
                continue
            d = int(dfa.next[s, c])
            if d != -1 and d not in searching:
                searching.add(d)
                frontier.append(d)
    return [s for s in range(dfa.n_states) if s not in searching]
