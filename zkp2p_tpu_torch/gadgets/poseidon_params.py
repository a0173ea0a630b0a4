"""Poseidon parameter generation (Grain LFSR), circomlib-compatible.

The reference hashes the payee Venmo ID with circomlib Poseidon
(`app/src/helpers/poseidonHash.ts:5-24`, in-circuit `circuit.circom:210`
via circomlib poseidon.circom).  circomlib's constants come from the
official `generate_params_poseidon.sage 1 0 254 t R_F R_P` procedure
(Grain LFSR stream, x^5 S-box, BN254 prime); this module reproduces that
stream in pure Python so no constants are copied from anywhere — they are
re-derived from the public algorithm and validated against the canonical
circomlib test vector (poseidon([1,2]), see tests).

R_P table per t follows circomlib's POSEIDON_NROUNDSP (security-level 128
choices for alpha=5, n=254).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

from ..field.bn254 import R as P  # BN254 scalar field prime (circomlib's "p")

R_F = 8
# circomlib poseidon.circom N_ROUNDS_P for t = 2..17.
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]


class _Grain:
    def __init__(self, t: int, r_f: int, r_p: int, n: int = 254, field: int = 1, sbox: int = 0):
        bits: List[int] = []
        for value, width in ((field, 2), (sbox, 4), (n, 12), (t, 12), (r_f, 10), (r_p, 10)):
            bits.extend(int(b) for b in bin(value)[2:].zfill(width))
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._update()

    def _update(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def _next_filtered_bit(self) -> int:
        # shrinking generator: a 1 bit passes the next bit through
        while True:
            b1 = self._update()
            b2 = self._update()
            if b1:
                return b2

    def next_field_element(self, n_bits: int = 254) -> int:
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self._next_filtered_bit()
            if v < P:
                return v


@lru_cache(maxsize=None)
def poseidon_params(t: int) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...], int, int]:
    """(round_constants, mds, R_F, R_P) for state width t (t-1 inputs)."""
    r_p = N_ROUNDS_P[t - 2]
    g = _Grain(t, R_F, r_p)
    n_consts = t * (R_F + r_p)
    consts = tuple(g.next_field_element() for _ in range(n_consts))
    # MDS: Cauchy matrix from fresh x/y vectors of the same stream.
    xs = [g.next_field_element() for _ in range(t)]
    ys = [g.next_field_element() for _ in range(t)]
    mds = tuple(
        tuple(pow((xs[i] + ys[j]) % P, P - 2, P) for j in range(t)) for i in range(t)
    )
    return consts, mds, R_F, r_p


def poseidon_hash(inputs: List[int]) -> int:
    """Host Poseidon (the circomlibjs `buildPoseidon` twin)."""
    t = len(inputs) + 1
    consts, mds, r_f, r_p = poseidon_params(t)
    state = [0] + [x % P for x in inputs]
    ci = 0
    total = r_f + r_p
    for rnd in range(total):
        state = [(s + consts[ci + i]) % P for i, s in enumerate(state)]
        ci += t
        if rnd < r_f // 2 or rnd >= total - r_f // 2:
            state = [pow(s, 5, P) for s in state]
        else:
            state[0] = pow(state[0], 5, P)
        state = [sum(mds[i][j] * state[j] for j in range(t)) % P for i in range(t)]
    return state[0]


def poseidon_k(inputs: List[int], chunk: int = 16) -> int:
    """poseidonK (poseidonHash.ts:13-24): fold wide inputs in chunks."""
    out = 0
    for i in range(0, len(inputs), chunk):
        seg = inputs[i : i + chunk]
        out = poseidon_hash(([out] if i else []) + seg) if i else poseidon_hash(seg)
    return out
