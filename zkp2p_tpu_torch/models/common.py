"""Shared DKIM-circuit building blocks used by both model families.

The venmo (`circuit/circuit.circom:17-310`) and EmailVerify
(`zk-email-verify-circuits/email.circom:15-222`) circuits share the whole
header-to-body-hash spine: reveal-shift extraction windows and the
bh= base64 / partial-SHA body-hash equality block
(`circuit.circom:115-156`).  Hoisted here so a soundness fix lands in one
place for every model (the round-2 bh= bug existed precisely because this
block was duplicated).
"""

from __future__ import annotations

from typing import List, Sequence

from ..gadgets import base64 as b64
from ..gadgets import core, sha256
from ..gadgets.regex import CharClassCache, dfa_scan, match_count, reveal_bytes
from ..regexc import compiler as regexc
from ..snark.r1cs import LC, ConstraintSystem


def shift_window(
    cs: ConstraintSystem,
    data: Sequence[int],
    idx_onehot: Sequence[int],
    width: int,
    tag: str,
) -> List[int]:
    """out[j] = Σ_i onehot[i] · data[i+j] — the reveal-shift matrix
    (`circuit.circom:115-132,189-194`): O(len·width) products, which in the
    JAX witness tracer becomes a windowed gather (SURVEY.md §3.5).  All
    products and sums witnessed by ONE BlockHook (r1cs.witness_batch)."""
    import numpy as np

    out = []
    L = len(data)
    n_one = len(idx_onehot)
    for ind in idx_onehot:  # window soundness: exactly-one-hot 0/1 lanes
        cs.require_width(ind, 1, f"{tag}/shift.lane")
    block_outs: List[int] = []
    rows: List[tuple] = []  # (j, i) per product, in creation order
    for j in range(width):
        prods = []
        for i, ind in enumerate(idx_onehot):
            if i + j >= L:
                continue
            p = cs.new_wire(f"{tag}.p{j}.{i}.out")
            cs.enforce(LC.of(ind), LC.of(data[i + j]), LC.of(p), f"{tag}.p{j}.{i}")
            # one-hot lane x data byte: bounded by the data wire's width
            cs.set_width(p, cs.wire_width.get(data[i + j], 254))
            prods.append(p)
            block_outs.append(p)
            rows.append((j, i))
        w = cs.new_wire(f"{tag}.out{j}")
        cs.enforce_eq(core.lc_sum(prods), LC.of(w), f"{tag}/sum{j}")
        cs.set_width(w, max((cs.wire_width.get(q, 254) for q in prods), default=254))
        block_outs.append(w)
        out.append(w)

    j_arr = np.asarray([j for j, _ in rows])
    i_arr = np.asarray([i for _, i in rows])
    # output-row mapping: products in order, then the sum wire after each
    # j's run — rebuild positions once here.
    order: List[int] = []
    prod_pos: List[int] = []
    k = 0
    for j in range(width):
        n_p = int((i_arr[j_arr == j]).shape[0])
        prod_pos.extend(range(k, k + n_p))
        order.append(k + n_p)
        k += n_p + 1

    def vfn(m, j_arr=j_arr, i_arr=i_arr, n_one=n_one, prod_pos=prod_pos, sum_pos=order, width=width, k_total=k):
        ind = m[0:n_one]
        dat = m[n_one:]
        pv = ind[i_arr] * dat[i_arr + j_arr]  # (n_prods, K)
        res = np.empty((k_total, m.shape[1]), dtype=m.dtype)
        res[prod_pos] = pv
        sums = np.zeros((width, m.shape[1]), dtype=m.dtype)
        np.add.at(sums, j_arr, pv)
        res[sum_pos] = sums
        return res

    cs.compute_block(block_outs, vfn, list(idx_onehot) + list(data))
    return out


def bh_value_states(dfa) -> List[int]:
    """States inside the bh= base64 value of the BODY_HASH DFA: exactly
    those from which ';' then ' ' completes the match.  Only the value
    component of `...bh=[0-9A-Za-z+/=]+; ` can end the match this way (the
    inner `[a-z]+=[^;]+; ` tag-value loop continues to more tags, never to
    accept), so the reveal mask is 1 precisely on the matched b64 chars —
    verified against a canonical relaxed-canonicalized header in tests."""
    out = []
    for s in range(dfa.n_states):
        z = int(dfa.next[s, ord(";")])
        if z != -1 and int(dfa.next[z, ord(" ")]) in dfa.accept:
            out.append(s)
    assert out, "BODY_HASH DFA has no value states"
    return out


def constrain_body_hash(
    cs: ConstraintSystem,
    header: Sequence[int],
    body_bits: Sequence[Sequence[int]],
    body_blocks: int,
    midstate_bits: Sequence[int],
    body_hash_idx: int,
    cache: CharClassCache,
    max_header_bytes: int,
    bh_b64_len: int,
) -> None:
    """The bh= extraction + body-hash equality block
    (`circuit.circom:115-156`): scan the signed header for the DKIM bh=
    tag (exactly one match), reveal ONLY the regex-masked value chars
    (soundness: a prover must not be able to point body_hash_idx at
    arbitrary base64-alphabet header bytes — the shift consumes the reveal
    mask, zero outside the match), shift them to a fixed window,
    base64-decode, and constrain equal to the midstate-resumed partial
    SHA-256 of the body."""
    bh_dfa = regexc.search_dfa(regexc.BODY_HASH)
    bh_states = dfa_scan(cs, list(header), bh_dfa, cache, "bh")
    bh_cnt = match_count(cs, bh_states, bh_dfa.accept, "bh.cnt")
    cs.enforce_eq(LC.of(bh_cnt), LC.const(1), "bh/count")

    bh_reveal = reveal_bytes(cs, header, bh_states, bh_value_states(bh_dfa), "bh.rev")
    bh_onehot = core.one_hot(cs, body_hash_idx, max_header_bytes - bh_b64_len, "bh.idx")
    bh_chars = shift_window(cs, bh_reveal, bh_onehot, bh_b64_len, "bh.shift")
    decoded = b64.base64_decode_bits(cs, bh_chars, cache, "bh.dec")

    mid_words = [list(midstate_bits[32 * i : 32 * i + 32]) for i in range(8)]
    body_digest = sha256.sha256_blocks(cs, body_bits, body_blocks, init_state=mid_words, tag="sha_body")
    # body digest: 8 words x 32 LE bits; decoded: per-byte LE bits.
    # digest byte 4w+b (big-endian in word) = word bits [8*(3-b) .. +8)
    for byte_i in range(32):
        wrd, b_in_w = divmod(byte_i, 4)
        for bit in range(8):
            cs.enforce_eq(
                LC.of(decoded[byte_i][bit]),
                LC.of(body_digest[32 * wrd + 8 * (3 - b_in_w) + bit]),
                "bh/eq",
            )


def dkim_header_match(
    cs: ConstraintSystem,
    header: Sequence[int],
    cache: CharClassCache,
    match_count_required: int,
) -> None:
    """DKIM to/from regex over [\\x80] + header with the required exact
    match count (`circuit.circom:102-110`; sentinel
    `dkim_header_regex.circom:11-14`)."""
    sentinel = cs.new_wire("sentinel80")
    cs.enforce_eq(LC.of(sentinel), LC.const(0x80), "sentinel")
    cs.compute(sentinel, lambda: 0x80, [])
    dkim_dfa = regexc.search_dfa(regexc.DKIM_HEADER)
    dkim_states = dfa_scan(cs, [sentinel] + list(header), dkim_dfa, cache, "dkim")
    dkim_cnt = match_count(cs, dkim_states, dkim_dfa.accept, "dkim.cnt")
    cs.enforce_eq(LC.of(dkim_cnt), LC.const(match_count_required), "dkim/count")
