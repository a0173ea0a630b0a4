"""SHA-256 as R1CS gadgets: compression, variable-length, midstate resume.

Our rebuild of the reference's SHA stack (`zk-email-verify-circuits/
sha.circom:7,30`, `sha256general.circom:9`, `sha256partial.circom:9`,
circomlib `sha256compression`): byte wires in, 256 output bit wires out,
with the two tricks the reference's scaling depends on (SURVEY.md §5
long-context):

  - variable length via output selection at block index `len/64`
    (`sha256general.circom:110-118` QuinSelector semantics), keeping the
    actual message length a private input;
  - midstate resume (`Sha256Partial`): the compression chain can start
    from 256 caller-provided state bits, so the parallelisable prefix of
    the body hash lives OUTSIDE the circuit (`generate_input.ts:110-124`).

Bit convention: every 32-bit word is a little-endian list of 32 boolean
wires (index 0 = LSB), so modular addition is one LC sum + one
decomposition; rotations and shifts are pure rewiring (zero constraints).
Costs per block ≈ 30k constraints, matching the reference's annotated
506,670 for 16 header blocks (`circuit/circuit.circom:62`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..field.bn254 import R
from ..snark.r1cs import LC, ConstraintSystem
from .core import lc_sum, num2bits, one_hot

# FIPS 180-4 constants.
K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

# A "word" is 32 bit entries; an entry is a wire int or None (constant 0,
# produced by logical right shifts).
Word = List[Optional[int]]


def _rotr(w: Word, r: int) -> Word:
    return [w[(i + r) % 32] for i in range(32)]


def _shr(w: Word, r: int) -> Word:
    return [w[i + r] if i + r < 32 else None for i in range(32)]


def _xor2_bit(cs: ConstraintSystem, x: int, y: int, tag: str) -> int:
    out = cs.new_wire(tag)
    # out = x + y - 2xy  <=>  (2x) * y = x + y - out
    cs.enforce(LC.of(x, 2), LC.of(y), LC.of(x) + LC.of(y) - LC.of(out), tag)
    cs.compute(out, lambda a, b: a ^ b, [x, y])
    cs.set_width(out, 1)  # xor of bool wires is bool
    return out


def _xor_bits(cs: ConstraintSystem, bits: Sequence[Optional[int]], tag: str) -> Optional[int]:
    live = [b for b in bits if b is not None]
    if not live:
        return None
    acc = live[0]
    for j, b in enumerate(live[1:]):
        acc = _xor2_bit(cs, acc, b, f"{tag}.x{j}")
    return acc


def _xor_words(cs: ConstraintSystem, words: Sequence[Word], tag: str) -> Word:
    """Bitwise XOR of up to 3 words: per position a chain of 2-input xor
    constraints; ALL chain wires witnessed by ONE BlockHook (a padded
    bitwise_xor.accumulate over (positions, chain) — the per-bit hook
    tier was ~half the SHA witness cost, r1cs.witness_batch)."""
    import numpy as np

    out: Word = []
    ins: List[int] = []
    idx_rows: List[List[int]] = []  # per multi-live position: indices into ins (padded later)
    chain_wires: List[int] = []
    sel_rows: List[int] = []
    sel_cols: List[int] = []
    for i in range(32):
        live = [w[i] for w in words if w[i] is not None]
        if not live:
            out.append(None)
            continue
        if len(live) == 1:
            out.append(live[0])
            continue
        row = len(idx_rows)
        base = len(ins)
        ins.extend(live)
        idx_rows.append(list(range(base, base + len(live))))
        acc = live[0]
        for j, b in enumerate(live[1:]):
            o = cs.new_wire(f"{tag}.{i}.x{j}")
            cs.enforce(LC.of(acc, 2), LC.of(b), LC.of(acc) + LC.of(b) - LC.of(o), f"{tag}.{i}")
            cs.set_width(o, 1)  # xor chain over bool wires
            chain_wires.append(o)
            sel_rows.append(row)
            sel_cols.append(j + 1)
            acc = o
        out.append(acc)
    if chain_wires:
        max_l = max(len(r) for r in idx_rows)
        pad = len(ins)  # index of the zero row appended by the vfn
        idx = np.asarray([r + [pad] * (max_l - len(r)) for r in idx_rows])
        rows = np.asarray(sel_rows)
        cols = np.asarray(sel_cols)

        def vfn(m, idx=idx, rows=rows, cols=cols):
            ext = np.vstack([m, np.zeros((1, m.shape[1]), dtype=m.dtype)])
            acc = np.bitwise_xor.accumulate(ext[idx], axis=1)
            return acc[rows, cols]

        cs.compute_block(chain_wires, vfn, ins)
    return out


def _add_mod32(cs: ConstraintSystem, words: Sequence[Word], const_extra: int, n_terms: int, tag: str) -> Word:
    """word-wise sum of `words` (+ a constant) mod 2^32: one LC-sum wire,
    one 32+log2(n_terms)-bit decomposition, low 32 bits returned."""
    extra = max(1, (n_terms - 1).bit_length())
    terms: dict = {}
    ins: List[int] = []
    weights: List[int] = []
    for w in words:
        for i, b in enumerate(w):
            if b is None:
                continue
            terms[b] = (terms.get(b, 0) + (1 << i)) % R
            ins.append(b)
            weights.append(1 << i)
    total = cs.new_wire(f"{tag}.sum")
    cs.enforce_eq(LC(terms) + const_extra, LC.of(total), f"{tag}/sum")
    import numpy as np

    bits = num2bits(cs, total, 32 + extra, f"{tag}.bits", hook=False)
    w_arr = np.asarray(weights, dtype=np.int64)  # sum < n_terms * 2^32: int64-safe
    nb = 32 + extra

    def vfn(m, w=w_arr, ce=const_extra, nb=nb):
        tot = (w @ m + ce)[None, :]
        return np.concatenate([tot, (tot >> np.arange(nb)[:, None]) & 1], axis=0)

    cs.compute_block([total] + bits, vfn, ins)
    return bits[:32]


def _ch(cs: ConstraintSystem, e: Word, f: Word, g: Word, tag: str) -> Word:
    """ch = g + e*(f - g), bitwise (1 constraint/bit); one BlockHook for
    all 32 bits."""
    out: Word = []
    for i in range(32):
        o = cs.new_wire(f"{tag}.{i}")
        cs.enforce(LC.of(e[i]), LC.of(f[i]) - LC.of(g[i]), LC.of(o) - LC.of(g[i]), f"{tag}/ch")
        cs.set_width(o, 1)  # mux of bool wires is bool
        out.append(o)

    def vfn(m):
        ev, fv, gv = m[0:32], m[32:64], m[64:96]
        return gv + ev * (fv - gv)

    cs.compute_block(out, vfn, list(e) + list(f) + list(g))
    return out


def _maj(cs: ConstraintSystem, a: Word, b: Word, c: Word, tag: str) -> Word:
    """maj = t + c*(a + b - 2t), t = a*b (2 constraints/bit); one
    BlockHook for all 64 wires."""
    import numpy as np

    ts: Word = []
    out: Word = []
    for i in range(32):
        t = cs.new_wire(f"{tag}.t{i}")
        cs.enforce(LC.of(a[i]), LC.of(b[i]), LC.of(t), f"{tag}/t")
        o = cs.new_wire(f"{tag}.{i}")
        cs.enforce(LC.of(c[i]), LC.of(a[i]) + LC.of(b[i]) - LC.of(t, 2), LC.of(o) - LC.of(t), f"{tag}/maj")
        cs.set_width(t, 1)  # and / majority of bool wires are bool
        cs.set_width(o, 1)
        ts.append(t)
        out.append(o)

    def vfn(m):
        av, bv, cv = m[0:32], m[32:64], m[64:96]
        tv = av * bv
        return np.vstack([tv, tv + cv * (av + bv - 2 * tv)])

    cs.compute_block(ts + out, vfn, list(a) + list(b) + list(c))
    return out


def sha256_compression(cs: ConstraintSystem, state: List[Word], block: List[Word], tag: str = "sha") -> List[Word]:
    """One compression round chain: state (8 words) x block (16 words) ->
    new state (8 words).  The R1CS twin of circomlib sha256compression."""
    w: List[Word] = list(block)
    for t in range(16, 64):
        s0 = _xor_words(cs, [_rotr(w[t - 15], 7), _rotr(w[t - 15], 18), _shr(w[t - 15], 3)], f"{tag}.s0.{t}")
        s1 = _xor_words(cs, [_rotr(w[t - 2], 17), _rotr(w[t - 2], 19), _shr(w[t - 2], 10)], f"{tag}.s1.{t}")
        w.append(_add_mod32(cs, [s1, w[t - 7], s0, w[t - 16]], 0, 4, f"{tag}.w{t}"))

    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _xor_words(cs, [_rotr(e, 6), _rotr(e, 11), _rotr(e, 25)], f"{tag}.S1.{t}")
        ch = _ch(cs, e, f, g, f"{tag}.ch.{t}")
        S0 = _xor_words(cs, [_rotr(a, 2), _rotr(a, 13), _rotr(a, 22)], f"{tag}.S0.{t}")
        mj = _maj(cs, a, b, c, f"{tag}.mj.{t}")
        # t1 = h + S1 + ch + K[t] + w[t];  t2 = S0 + maj
        t1_words = [h, S1, ch, w[t]]
        new_e = _add_mod32(cs, t1_words + [d], K[t], 6, f"{tag}.e.{t}")
        new_a = _add_mod32(cs, t1_words + [S0, mj], K[t], 7, f"{tag}.a.{t}")
        a, b, c, d, e, f, g, h = new_a, a, b, c, new_e, e, f, g

    return [
        _add_mod32(cs, [sw, rw], 0, 2, f"{tag}.fin{i}")
        for i, (sw, rw) in enumerate(zip(state, [a, b, c, d, e, f, g, h]))
    ]


def bytes_to_words(cs: ConstraintSystem, byte_bits: List[List[int]]) -> List[Word]:
    """Byte bit-decompositions (little-endian per byte) -> big-endian words.
    word = b0<<24 | b1<<16 | b2<<8 | b3; word bit i = byte[3 - i//8], bit i%8."""
    words: List[Word] = []
    for w0 in range(0, len(byte_bits), 4):
        group = byte_bits[w0 : w0 + 4]
        words.append([group[3 - i // 8][i % 8] for i in range(32)])
    return words


def state_words_from_const(cs: ConstraintSystem, values: Sequence[int], tag: str = "h0") -> List[Word]:
    """Allocate wires pinned to constant 32-bit values (initial SHA state)."""
    import numpy as np

    words: List[Word] = []
    flat: List[int] = []
    bits: List[int] = []
    for wi, v in enumerate(values):
        word: Word = []
        for i in range(32):
            bit = (v >> i) & 1
            wire = cs.new_wire(f"{tag}.{wi}.{i}")
            cs.enforce_eq(LC.of(wire), LC.const(bit), f"{tag}/const")
            word.append(wire)
            flat.append(wire)
            bits.append(bit)
        words.append(word)
    consts = np.asarray(bits, dtype=np.int64)
    cs.compute_block(flat, lambda m, c=consts: np.broadcast_to(c[:, None], (c.shape[0], m.shape[1])), [])
    return words


def sha256_blocks(
    cs: ConstraintSystem,
    padded_byte_bits: List[List[int]],
    n_blocks_wire: Optional[int],
    init_state: Optional[List[Word]] = None,
    tag: str = "sha256",
) -> List[int]:
    """Variable-length SHA over pre-padded bytes (mirror of Sha256General /
    Sha256Partial).

    padded_byte_bits: per-byte bit wires, len = 64 * max_blocks (padding is
    done outside the circuit, `shaHash.ts:17-36` semantics).
    n_blocks_wire: wire holding the actual block count (1..max_blocks); the
    output is the chained state AFTER block n_blocks-1, selected by one-hot.
    None = always use all blocks (fixed length).
    init_state: 8 words to resume from (midstate checkpoint); None = H0.

    Returns 256 output bit wires (little-endian within each of 8 words,
    words in h0..h7 order)."""
    assert len(padded_byte_bits) % 64 == 0
    max_blocks = len(padded_byte_bits) // 64
    # the whole compression pipeline (xor chains, ch/maj muxes, mod-2^32
    # sums) assumes boolean message bits; a wide "bit" forges the digest
    for bb in padded_byte_bits:
        for w in bb:
            cs.require_width(w, 1, f"{tag}/sha.msg_bit")
    if init_state is not None:
        for word in init_state:
            for w in word:
                if w is not None:
                    cs.require_width(w, 1, f"{tag}/sha.midstate_bit")
    state = init_state if init_state is not None else state_words_from_const(cs, H0, f"{tag}.h0")
    per_block_out: List[List[Word]] = []
    for blk in range(max_blocks):
        words = bytes_to_words(cs, padded_byte_bits[blk * 64 : (blk + 1) * 64])
        state = sha256_compression(cs, state, words, f"{tag}.b{blk}")
        per_block_out.append(state)

    if n_blocks_wire is None:
        return [b for word in state for b in word]

    # One-hot select the state after block (n_blocks - 1).  All select
    # products + sums witnessed by ONE BlockHook over (blocks, 256, K).
    import numpy as np

    inds = one_hot(cs, n_blocks_wire, max_blocks + 1, f"{tag}.sel")  # ind[k] = (n==k)
    out_bits: List[int] = []
    block_outs: List[int] = []
    for wi in range(8):
        for bi in range(32):
            o = cs.new_wire(f"{tag}.out.{wi}.{bi}")
            cs.set_width(o, 1)  # one-hot select over bool state bits
            prods = []
            for blk in range(max_blocks):
                p = cs.new_wire(f"{tag}.outp.{wi}.{bi}.{blk}")
                cs.enforce(LC.of(inds[blk + 1]), LC.of(per_block_out[blk][wi][bi]), LC.of(p), f"{tag}/selmul")
                cs.set_width(p, 1)
                prods.append(p)
            cs.enforce_eq(lc_sum(prods), LC.of(o), f"{tag}/selsum")
            block_outs.extend(prods)
            block_outs.append(o)
            out_bits.append(o)

    def vfn(m, nb=max_blocks):
        sel = m[0:nb]  # (blocks, K)
        vals = m[nb:].reshape(256, nb, -1)  # (256, blocks, K)
        p = sel[None, :, :] * vals
        o = p.sum(axis=1, keepdims=True)
        return np.concatenate([p, o], axis=1).reshape(-1, m.shape[1])

    sel_ins = [inds[blk + 1] for blk in range(max_blocks)]
    val_ins = [
        per_block_out[blk][wi][bi]
        for wi in range(8)
        for bi in range(32)
        for blk in range(max_blocks)
    ]
    cs.compute_block(block_outs, vfn, sel_ins + val_ins)
    return out_bits
