"""Groth16 over BN254 on the host: the proof and key containers, the
seeded development setup's scalars, the QAP rows of a constraint system,
the domain conventions and the verifier (snarkjs/rapidsnark conventions,
as the reference's ``snark/groth16.py``).

The verifier checks e(A, B) = e(alpha, beta) e(vk_x, gamma) e(C, delta),
the equation of contracts/Verifier.sol, with the port's own host pairing
(``pairing.pairing``)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..curve.host import (G1Point, G2Point, g1_add, g1_is_on_curve, g1_mul, g1_neg, g2_is_on_curve,
                          g2_mul)
from ..field.bn254 import R, fr_domain_root, fr_inv
from ..pairing.pairing import pairing_product_is_one


@dataclass
class Proof:
    a: G1Point
    b: G2Point
    c: G1Point


@dataclass
class ProvingKey:
    """A proving key as host points (the snarkjs .zkey's content): one
    query point a wire (c_query None for wires 0..n_public), one h point
    a domain element (the coset-Lagrange basis)."""

    n_public: int
    domain_size: int
    alpha_1: G1Point
    beta_1: G1Point
    beta_2: G2Point
    delta_1: G1Point
    delta_2: G2Point
    a_query: List[G1Point]
    b1_query: List[G1Point]
    b2_query: List[G2Point]
    c_query: List[Optional[G1Point]]
    h_query: List[G1Point]


@dataclass
class VerifyingKey:
    n_public: int
    alpha_1: G1Point
    beta_2: G2Point
    gamma_2: G2Point
    delta_2: G2Point
    ic: List[G1Point]  # [(beta A_i + alpha B_i + C_i)/gamma]1 for wires 0..n_public


def coset_gen(log_m: int) -> int:
    """Coset generator of the H evaluation domain: w_{2m}, so the
    quotient is evaluated on the odd points of the doubled domain and
    Z(g*w^j) = -2 is constant (the snarkjs `groth16 prove` convention)."""
    return fr_domain_root(log_m + 1)


def domain_size_for(n_rows: int) -> int:
    """Power-of-two domain for n_rows QAP rows (the constraints plus one
    binding row per public input and one for the constant wire)."""
    m = 1
    while m < n_rows:
        m *= 2
    return m


def _batch_inv(xs: List[int]) -> List[int]:
    """Montgomery's trick over Fr: n inverses for 3n products and one
    exponentiation."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % R
    inv_all = fr_inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * xs[i] % R
    return out


def _seeded_scalars(seed: str, n: int) -> List[int]:
    """The development setup's toxic waste (tau, alpha, beta, gamma,
    delta for n = 5), derived from `seed` by SHA-256: nonzero, below r."""
    out = []
    counter = 0
    while len(out) < n:
        h = hashlib.sha256(f"{seed}:{counter}".encode()).digest()
        v = int.from_bytes(h + hashlib.sha256(h).digest(), "big") % R
        counter += 1
        if v != 0:
            out.append(v)
    return out


def qap_rows(cs) -> List[Tuple[Dict[int, int], Dict[int, int], Dict[int, int]]]:
    """The QAP rows of a constraint system: its R1CS rows (a, b, c wire ->
    coefficient dicts), then one binding row ({i: 1}, {}, {}) for each of
    wires 0..num_public.  Duck-typed: reads cs.constraints[i].a/.b/.c and
    cs.num_public."""
    rows = [(c.a, c.b, c.c) for c in cs.constraints]
    for i in range(cs.num_public + 1):
        rows.append(({i: 1}, {}, {}))
    return rows


def verify(vk: VerifyingKey, proof: Proof, public_inputs: Sequence[int]) -> bool:
    """e(A,B) == e(alpha,beta) * e(vk_x,gamma) * e(C,delta), after the
    checks the EVM's ecPairing makes: every point on its curve and B in
    the order-r subgroup of the twist.  False, never an exception, for a
    wrong arity, a point off its curve or a failed equation."""
    if len(public_inputs) != vk.n_public:
        return False
    if not (g1_is_on_curve(proof.a) and g1_is_on_curve(proof.c)):
        return False
    if not g2_is_on_curve(proof.b):
        return False
    if proof.b is not None and g2_mul(proof.b, R) is not None:
        return False
    vk_x = vk.ic[0]
    for i, x in enumerate(public_inputs):
        vk_x = g1_add(vk_x, g1_mul(vk.ic[i + 1], x % R))
    return pairing_product_is_one(
        [
            (g1_neg(proof.a), proof.b),
            (vk.alpha_1, vk.beta_2),
            (vk_x, vk.gamma_2),
            (proof.c, vk.delta_2),
        ]
    )


def proof_bytes(proof) -> bytes:
    """Canonical bytes of a proof: A.x, A.y, B.x.c0, B.x.c1, B.y.c0,
    B.y.c1, C.x, C.y, each 32 bytes big-endian; the point at infinity is
    all zeros.  Duck-typed over G2 coordinates (anything with c0/c1)."""
    def g1(p):
        return b"\0" * 64 if p is None else p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")

    def g2(p):
        if p is None:
            return b"\0" * 128
        return b"".join(v.to_bytes(32, "big") for c in p for v in (c.c0, c.c1))

    return g1(proof.a) + g2(proof.b) + g1(proof.c)
