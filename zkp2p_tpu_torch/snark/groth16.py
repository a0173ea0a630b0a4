"""Groth16 proof container and domain conventions shared with the
reference (snarkjs/rapidsnark conventions)."""

from __future__ import annotations

from dataclasses import dataclass

from ..curve.host import G1Point, G2Point
from ..field.bn254 import fr_domain_root


@dataclass
class Proof:
    a: G1Point
    b: G2Point
    c: G1Point


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
