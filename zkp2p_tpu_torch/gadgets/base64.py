"""Base64 decoding in R1CS (the `bh=` body-hash check).

Rebuild of `zk-email-verify-circuits/base64.circom`: `Base64Lookup`
(:6-57, range-arithmetic char -> 6-bit value) and `Base64Decode`
(:59-108, 4 chars -> 3 bytes).  The main circuit uses it to compare the
44-char base64 `bh=` value from the DKIM header against the partial-SHA
body hash (`circuit.circom:137-156`).

Outputs are little-endian bit wires per decoded byte so they compare
directly against the SHA gadget's output bits (no repacking constraints).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..snark.r1cs import LC, ConstraintSystem
from .core import lc_sum, num2bits
from .regex import CharClassCache


def base64_lookup(cs: ConstraintSystem, c: int, cache: CharClassCache, tag: str = "b64") -> Tuple[int, List[int]]:
    """char wire -> (6-bit value wire, its bits).  Valid alphabet enforced
    (A-Z a-z 0-9 + / and '=' padding -> 0)."""
    cs.require_width(c, 8, f"{tag}/b64.char")  # raw c feeds the value LC
    ind_AZ = cache.in_range(c, 65, 90)
    ind_az = cache.in_range(c, 97, 122)
    ind_09 = cache.in_range(c, 48, 57)
    ind_pl = cache.eq_const(c, 43)
    ind_sl = cache.eq_const(c, 47)
    ind_eq = cache.eq_const(c, 61)
    inds = [ind_AZ, ind_az, ind_09, ind_pl, ind_sl, ind_eq]
    cs.enforce_eq(lc_sum(inds), LC.const(1), f"{tag}/valid")

    # v = AZ*(c-65) + az*(c-71) + 09*(c+4) + 62*pl + 63*sl + 0*eq
    v = cs.new_wire(f"{tag}.v")
    t1 = cs.new_wire(f"{tag}.t1")
    cs.enforce(LC.of(ind_AZ), LC.of(c) - 65, LC.of(t1), f"{tag}/az")
    cs.compute(t1, lambda i, cc: i * (cc - 65), [ind_AZ, c])
    t2 = cs.new_wire(f"{tag}.t2")
    cs.enforce(LC.of(ind_az), LC.of(c) - 71, LC.of(t2), f"{tag}/lz")
    cs.compute(t2, lambda i, cc: i * (cc - 71), [ind_az, c])
    t3 = cs.new_wire(f"{tag}.t3")
    cs.enforce(LC.of(ind_09), LC.of(c) + 4, LC.of(t3), f"{tag}/dg")
    cs.compute(t3, lambda i, cc: i * (cc + 4), [ind_09, c])
    cs.enforce_eq(
        LC.of(t1) + LC.of(t2) + LC.of(t3) + LC.of(ind_pl, 62) + LC.of(ind_sl, 63),
        LC.of(v),
        f"{tag}/v",
    )
    cs.compute(v, lambda a, b, d, p, s: a + b + d + 62 * p + 63 * s, [t1, t2, t3, ind_pl, ind_sl])
    bits = num2bits(cs, v, 6, f"{tag}.bits")
    return v, bits


def base64_decode_bits(
    cs: ConstraintSystem, char_wires: Sequence[int], cache: CharClassCache | None = None, tag: str = "b64d"
) -> List[List[int]]:
    """Base64 chars -> decoded bytes as per-byte little-endian bit lists.
    len(char_wires) must be a multiple of 4; output has 3 bytes per group
    (padding '=' decodes to zero bits, matching Base64Decode)."""
    assert len(char_wires) % 4 == 0
    cache = cache or CharClassCache(cs)
    out: List[List[int]] = []
    for g in range(0, len(char_wires), 4):
        vals = [base64_lookup(cs, c, cache, f"{tag}.{g + i}")[1] for i, c in enumerate(char_wires[g : g + 4])]
        # 4x6 bits (little-endian per value) -> 24-bit group, MSB-first chars:
        # group = v0<<18 | v1<<12 | v2<<6 | v3; bytes big-endian within group.
        group_bits = []  # little-endian bit index 0..23
        for vi, shift in ((3, 0), (2, 6), (1, 12), (0, 18)):
            group_bits.extend(vals[vi])
        byte0 = group_bits[16:24]  # bits 23..16 -> first byte
        byte1 = group_bits[8:16]
        byte2 = group_bits[0:8]
        out.extend([byte0, byte1, byte2])
    return out
