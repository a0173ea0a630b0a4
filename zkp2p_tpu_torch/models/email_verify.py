"""EmailVerify — the generic DKIM email circuit family.

Rebuild of `zk-email-verify-circuits/email.circom:15-222`
(`EmailVerify(max_header_bytes, max_body_bytes, n, k)`) — the
architectural ancestor of the Venmo circuit: header SHA-256 + RSA-2048 +
DKIM to/from regex + bh= extraction + partial body SHA + base64 check,
WITHOUT the Venmo-specific extraction; plus an optional body regex with
packed reveal output (instantiated here with `TwitterResetRegex`
semantics, `twitter_reset_regex.circom:5`, to complete the family).

Public signal layout: [modulus (k) | reveal words (n_reveal_words)] —
matching EmailVerify's `public [modulus]` + packed reveal outputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..gadgets import core, rsa, sha256
from ..gadgets.regex import CharClassCache, dfa_scan, reveal_bytes
from ..regexc import compiler as regexc
from ..snark.r1cs import LC, ConstraintSystem
from . import common


@dataclass
class EmailVerifyParams:
    max_header_bytes: int = 1024
    max_body_bytes: int = 1536
    n: int = 121
    k: int = 17
    bh_b64_len: int = 44
    # optional body extraction (None = header/bh/body-hash checks only)
    body_regex: Optional[str] = regexc.TWITTER_RESET
    reveal_len: int = 21  # bytes -> 3 packed words
    dkim_match_count: int = 2


@dataclass
class EmailVerifyLayout:
    modulus: List[int] = field(default_factory=list)
    reveal_words: List[int] = field(default_factory=list)
    header: List[int] = field(default_factory=list)
    header_blocks: int = 0
    signature: List[int] = field(default_factory=list)
    body: List[int] = field(default_factory=list)
    body_blocks: int = 0
    midstate_bits: List[int] = field(default_factory=list)
    body_hash_idx: int = 0
    reveal_idx: int = 0


def build_email_verify(p: EmailVerifyParams):
    assert p.max_header_bytes % 64 == 0 and p.max_body_bytes % 64 == 0
    cs = ConstraintSystem("email_verify")
    lay = EmailVerifyLayout()

    lay.modulus = [cs.new_public(f"modulus[{i}]") for i in range(p.k)]
    n_words = (p.reveal_len + 6) // 7 if p.body_regex else 0
    lay.reveal_words = [cs.new_public(f"reveal[{i}]") for i in range(n_words)]

    lay.header = cs.new_wires(p.max_header_bytes, "in_padded")
    lay.header_blocks = cs.new_wire("in_len_blocks")
    lay.signature = cs.new_wires(p.k, "signature")
    lay.body = cs.new_wires(p.max_body_bytes, "in_body_padded")
    lay.body_blocks = cs.new_wire("in_body_len_blocks")
    lay.midstate_bits = cs.new_wires(256, "precomputed_sha")
    lay.body_hash_idx = cs.new_wire("body_hash_idx")
    if p.body_regex:
        lay.reveal_idx = cs.new_wire("reveal_idx")

    # prover-seeded inputs (inputs.email email_verify seed keys): the
    # audit's determinism sources + hook-coverage exemptions
    cs.mark_input(
        lay.header + [lay.header_blocks] + lay.signature + lay.body
        + [lay.body_blocks] + lay.midstate_bits + [lay.body_hash_idx]
        + ([lay.reveal_idx] if p.body_regex else [])
    )

    header_bits = core.assert_bytes(cs, lay.header, "hdr")
    body_bits = core.assert_bytes(cs, lay.body, "body")
    for w in lay.midstate_bits:
        cs.enforce_bool(w, "midstate")

    digest_bits = sha256.sha256_blocks(cs, header_bits, lay.header_blocks, tag="sha_hdr")
    rsa.rsa_verify_65537(cs, lay.signature, lay.modulus, digest_bits, p.n, p.k, "rsa")

    cache = CharClassCache(cs)
    for w, bits in zip(lay.header, header_bits):
        cache.register_bits(w, bits)
    for w, bits in zip(lay.body, body_bits):
        cache.register_bits(w, bits)

    common.dkim_header_match(cs, lay.header, cache, p.dkim_match_count)

    # bh= extraction + body hash equality — shared soundness-critical block
    # (shifts the regex-masked reveal, NOT the raw header; the round-2 bug
    # here was shifting lay.header directly, letting a prover point
    # body_hash_idx at arbitrary base64-alphabet bytes of the signed
    # header).  See models.common.constrain_body_hash.
    common.constrain_body_hash(
        cs,
        lay.header,
        body_bits,
        lay.body_blocks,
        lay.midstate_bits,
        lay.body_hash_idx,
        cache,
        p.max_header_bytes,
        p.bh_b64_len,
    )

    if p.body_regex:
        dfa = regexc.search_dfa(p.body_regex)
        states = dfa_scan(cs, list(lay.body), dfa, cache, "brx")
        reveal = reveal_bytes(cs, lay.body, states, sorted(dfa.accept), "brx.rev")
        onehot = core.one_hot(cs, lay.reveal_idx, p.max_body_bytes - p.reveal_len, "brx.idx")
        chars = common.shift_window(cs, reveal, onehot, p.reveal_len, "brx.shift")
        words = core.pack_bytes(cs, chars, 7, "brx.pack")
        for w, pub in zip(words, lay.reveal_words):
            cs.enforce_eq(LC.of(w), LC.of(pub), "brx/out")

    return cs, lay
