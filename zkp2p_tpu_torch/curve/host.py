"""Host BN254 group arithmetic on Python ints: G1 over Fq, G2 over the
Fq2 twist.  The proof assembly and the checks of device results use it.

Points are affine tuples of ints / Fq2 (None = the point at infinity);
G1 scalar multiplication runs in Jacobian coordinates internally."""

from __future__ import annotations

from typing import Optional, Tuple

from ..field.bn254 import P
from ..field.tower import XI, Fq2

G1Point = Optional[Tuple[int, int]]
G2Point = Optional[Tuple[Fq2, Fq2]]

CURVE_B = 3
# b of the D-type twist y^2 = x^3 + 3/xi over Fq2
TWIST_B = Fq2(3, 0) * XI.inv()

G1_GENERATOR: G1Point = (1, 2)
G2_GENERATOR: G2Point = (
    Fq2(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    Fq2(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


# ---------------------------------------------------------------- G1 (Fq)


def g1_is_on_curve(pt: G1Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - CURVE_B) % P == 0


def g1_neg(pt: G1Point) -> G1Point:
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_add(a: G1Point, b: G1Point) -> G1Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _jac_double(X1, Y1, Z1):
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = B * B % P
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y1 * Z1 % P
    return X3, Y3, Z3


def _jac_add(X1, Y1, Z1, X2, Y2, Z2):
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return 0, 1, 0
        return _jac_double(X1, Y1, Z1)
    H = (U2 - U1) % P
    I = (2 * H) * (2 * H) % P
    J = H * I % P
    rr = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
    return X3, Y3, Z3


def g1_jac_to_affine(X: int, Y: int, Z: int) -> G1Point:
    if Z % P == 0:
        return None
    zinv = pow(Z, P - 2, P)
    z2 = zinv * zinv % P
    return (X * z2 % P, Y * z2 % P * zinv % P)


def g1_mul(pt: G1Point, k: int) -> G1Point:
    """Scalar multiplication via Jacobian double-and-add."""
    if pt is None or k == 0:
        return None
    if k < 0:
        return g1_mul(g1_neg(pt), -k)
    X, Y, Z = pt[0], pt[1], 1
    RX, RY, RZ = 0, 1, 0
    for bit in bin(k)[2:]:
        if RZ != 0:
            RX, RY, RZ = _jac_double(RX, RY, RZ)
        if bit == "1":
            if RZ == 0:
                RX, RY, RZ = X, Y, Z
            else:
                RX, RY, RZ = _jac_add(RX, RY, RZ, X, Y, Z)
    return g1_jac_to_affine(RX, RY, RZ)


# ---------------------------------------------------------------- G2 (Fq2)


def g2_is_on_curve(pt: G2Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y.square() - x.square() * x - TWIST_B).is_zero()


def g2_neg(pt: G2Point) -> G2Point:
    if pt is None:
        return None
    return (pt[0], -pt[1])


def g2_add(a: G2Point, b: G2Point) -> G2Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (x1.square() * 3) * (y1 * 2).inv()
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_jac_to_affine(X: Fq2, Y: Fq2, Z: Fq2) -> G2Point:
    if Z.is_zero():
        return None
    zinv = Z.inv()
    zi2 = zinv * zinv
    return (X * zi2, Y * zi2 * zinv)


def g2_mul(pt: G2Point, k: int) -> G2Point:
    if pt is None or k == 0:
        return None
    if k < 0:
        return g2_mul(g2_neg(pt), -k)
    result: G2Point = None
    addend = pt
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result
