"""Poseidon hash as R1CS (x^5 S-box, BN254, circomlib parameterisation).

Rebuild of circomlib poseidon.circom as used at `circuit.circom:210-218`
(payee Venmo-ID hash) and `poseidonHash.ts`.  The linear layers (round
constants + MDS mix) are folded into LCs — they cost ZERO constraints;
only S-boxes materialise wires (3 constraints each: x2, x4, x5), the same
trick circomlib's optimized form exploits.  Cost: 3·(t·R_F + R_P)
constraints per permutation (t=3 -> 192).

Parameters come from gadgets.poseidon_params (Grain LFSR re-derivation of
the official x5_254 constants; C/M spot-pinned against the canonical
published values in tests)."""

from __future__ import annotations

from typing import List, Sequence

from ..field.bn254 import R
from ..snark.r1cs import LC, ConstraintSystem
from .poseidon_params import poseidon_params

P = R  # Poseidon runs over the BN254 scalar field


def _lc_pow5(cs: ConstraintSystem, lc: LC, tag: str) -> int:
    """x^5 of an LC value: wires for x2, x4, x5 (3 constraints), all
    witnessed by ONE object BlockHook (exact field arithmetic)."""
    import numpy as np

    ins = [w for w in lc.terms if w != 0]
    weights = np.asarray([lc.terms[w] for w in ins], dtype=object)[:, None]
    const = lc.terms.get(0, 0)

    x2 = cs.new_wire(f"{tag}.x2")
    cs.enforce(lc, lc, LC.of(x2), f"{tag}/x2")
    x4 = cs.new_wire(f"{tag}.x4")
    cs.enforce(LC.of(x2), LC.of(x2), LC.of(x4), f"{tag}/x4")
    x5 = cs.new_wire(f"{tag}.x5")
    cs.enforce(LC.of(x4), lc, LC.of(x5), f"{tag}/x5")

    def vfn(m, w=weights, c=const):
        x = ((w * m).sum(axis=0) + c) % P
        x2v = x * x % P
        x4v = x2v * x2v % P
        return np.stack([x2v, x4v, x4v * x % P])

    cs.compute_block([x2, x4, x5], vfn, ins, int64=False)
    return x5


def poseidon(cs: ConstraintSystem, inputs: Sequence[int], tag: str = "poseidon") -> int:
    """Poseidon hash of input wires -> output wire (capacity-0 sponge,
    output = state[0] after the permutation)."""
    t = len(inputs) + 1
    consts, mds, r_f, r_p = poseidon_params(t)
    state: List[LC] = [LC()] + [LC.of(w) for w in inputs]
    ci = 0
    total = r_f + r_p
    for rnd in range(total):
        state = [lc + consts[ci + i] for i, lc in enumerate(state)]
        ci += t
        full = rnd < r_f // 2 or rnd >= total - r_f // 2
        if full:
            state = [LC.of(_lc_pow5(cs, lc, f"{tag}.r{rnd}.{i}")) for i, lc in enumerate(state)]
        else:
            state[0] = LC.of(_lc_pow5(cs, state[0], f"{tag}.r{rnd}.0"))
        state = [
            sum((state[j] * mds[i][j] for j in range(t)), LC())
            for i in range(t)
        ]
    out = cs.new_wire(f"{tag}.out")
    cs.enforce_eq(state[0], LC.of(out), f"{tag}/out")
    ins = [w for w in state[0].terms if w != 0]
    weights = [state[0].terms[w] for w in ins]
    const = state[0].terms.get(0, 0)
    cs.compute(out, lambda *vs, ws=tuple(weights), c=const: (sum(v * x for v, x in zip(vs, ws)) + c) % P, ins)
    return out
