"""BN254 field parameters for the port: the moduli, the Montgomery
constants of the 16 x 16-bit limb layout, the Fr roots of unity and the
GLV endomorphism's constants with its scalar split.

A copy of what the prover needs from the reference package's host field
module; the values are recomputed here, not hard-coded twice."""

from __future__ import annotations

# Base field (Fq) and scalar field (Fr) moduli of BN254.
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

LIMB_BITS = 16
NUM_LIMBS = 16
MONT_BITS = LIMB_BITS * NUM_LIMBS  # 256
MONT_R = 1 << MONT_BITS


def fr_inv(a: int) -> int:
    if a % R == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(a, R - 2, R)


def mont_constants(modulus: int):
    """(R mod N, R^2 mod N, N' = -N^-1 mod 2^256) for R = 2^256."""
    r_mod = MONT_R % modulus
    r2 = (r_mod * r_mod) % modulus
    n_prime = (-pow(modulus, -1, MONT_R)) % MONT_R
    return r_mod, r2, n_prime


FR_TWO_ADICITY = 28


def _fr_2adic_root() -> int:
    """A primitive 2^28-th root of unity in Fr (the first generator
    candidate whose odd-part power has full 2-power order)."""
    odd = (R - 1) >> FR_TWO_ADICITY
    for g in range(2, 100):
        w = pow(g, odd, R)
        if pow(w, 1 << (FR_TWO_ADICITY - 1), R) != 1:
            return w
    raise RuntimeError("no 2^28 root of unity found")


FR_ROOT_OF_UNITY = _fr_2adic_root()


def fr_domain_root(log_size: int) -> int:
    """Primitive 2^log_size-th root of unity in Fr."""
    if log_size > FR_TWO_ADICITY:
        raise ValueError(f"domain 2^{log_size} exceeds Fr 2-adicity {FR_TWO_ADICITY}")
    w = FR_ROOT_OF_UNITY
    for _ in range(FR_TWO_ADICITY - log_size):
        w = (w * w) % R
    return w


# The BN curve parameter u and the optimal ate pairing's loop count 6u + 2.
BN_U = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_U + 2


# ---------------------------------------------------------------------------
# GLV endomorphism: BN254 has j-invariant 0, so phi(x, y) = (beta * x, y)
# with beta a cube root of unity in Fq acts on G1 as the scalar lambda, a
# cube root of unity in Fr, and k * P = k1 * P + k2 * phi(P) for k = k1 +
# k2 * lambda (mod r) with |k1|, |k2| about 2^128.  The roots, the lattice
# basis and the Barrett constants are derived here at import, and lambda *
# G must land on (beta, 2): a transcription error fails the import.

G1_GEN = (1, 2)


def _cube_root_of_unity(modulus: int) -> int:
    for g in range(2, 100):
        w = pow(g, (modulus - 1) // 3, modulus)
        if w != 1:
            return w
    raise RuntimeError("no cube root of unity found")


def _jac_mul_int(pt, k: int):
    """k * pt by Jacobian double-and-add on Python ints (the import-time
    check only: curve.host imports this module)."""
    X1, Y1 = pt
    X, Y, Z = 0, 1, 0
    for bit in bin(k)[2:]:
        if Z:
            A, B = X * X % P, Y * Y % P
            C = B * B % P
            D = 2 * ((X + B) * (X + B) - A - C) % P
            E = 3 * A % P
            X2 = (E * E - 2 * D) % P
            X, Y, Z = X2, (E * (D - X2) - 8 * C) % P, 2 * Y * Z % P
        if bit == "1":
            if not Z:
                X, Y, Z = X1, Y1, 1
            else:  # mixed add; the chain never meets P or -P
                ZZ = Z * Z % P
                H, Rr = (X1 * ZZ - X) % P, (Y1 * ZZ * Z - Y) % P
                HH = H * H % P
                HHH, V = H * HH % P, X * HH % P
                X2 = (Rr * Rr - HHH - 2 * V) % P
                X, Y, Z = X2, (Rr * (V - X2) - Y * HHH) % P, Z * H % P
    zi = pow(Z, P - 2, P)
    return X * zi * zi % P, Y * zi * zi % P * zi % P


def _glv_lattice(lam: int):
    """A short basis (a1, b1), (a2, b2) of {(x, y): x + y * lam = 0 mod r}
    by the half-extended Euclid of the GLV paper, oriented so that its
    determinant is +r."""
    sqrt_r = 1 << ((R.bit_length() + 1) // 2)
    rems = [(R, 0), (lam, 1)]  # (r_i, t_i) with r_i = s_i * r + t_i * lam
    while rems[-1][0] >= sqrt_r:
        (r0, t0), (r1, t1) = rems[-2], rems[-1]
        q = r0 // r1
        rems.append((r0 - q * r1, t0 - q * t1))
    (rl, tl), (rl1, tl1) = rems[-2], rems[-1]
    v1 = (rl1, -tl1)
    q = rl // rl1
    cand_a, cand_b = (rl, -tl), (rl - q * rl1, -(tl - q * tl1))
    v2 = cand_a if cand_a[0] ** 2 + cand_a[1] ** 2 <= cand_b[0] ** 2 + cand_b[1] ** 2 else cand_b
    det = v1[0] * v2[1] - v2[0] * v1[1]
    assert abs(det) == R, "GLV lattice determinant must be +-r"
    if det < 0:
        v2 = (-v2[0], -v2[1])
    for a, b in (v1, v2):
        assert (a + b * lam) % R == 0 and a != 0 and b != 0
    return v1, v2


def _glv_setup():
    lam = _cube_root_of_unity(R)
    q = _jac_mul_int(G1_GEN, lam)
    b = _cube_root_of_unity(P)
    assert q[1] == 2 and q[0] in (b, b * b % P), "lambda*G is not (beta, 2): GLV derivation broken"
    return lam, q[0], *_glv_lattice(lam)


GLV_LAMBDA, GLV_BETA, GLV_V1, GLV_V2 = _glv_setup()
(_GLV_A1, _GLV_B1), (_GLV_A2, _GLV_B2) = GLV_V1, GLV_V2

# floor-Barrett estimates c_i = (k * MU_i) >> 256 of k * |m_i| / r, with
# m1 = b2 and m2 = -b1: any c_i keeps k1 + k2 * lambda = k (mod r); the
# floor's error (under 2 each) only widens the bound on |k_i|
GLV_SHIFT = 256
_GLV_M1, _GLV_M2 = _GLV_B2, -_GLV_B1
GLV_MU1 = (abs(_GLV_M1) << GLV_SHIFT) // R
GLV_MU2 = (abs(_GLV_M2) << GLV_SHIFT) // R
GLV_MAX_BITS = max((2 * (abs(_GLV_A1) + abs(_GLV_A2))).bit_length(), (2 * (abs(_GLV_B1) + abs(_GLV_B2))).bit_length())


def glv_decompose(k: int):
    """k (mod r) -> signed (k1, k2) with k = k1 + k2 * lambda (mod r) and
    |k_i| < 2^GLV_MAX_BITS: the reference's floor-Barrett split, integer
    for integer."""
    k %= R
    c1 = ((k * GLV_MU1) >> GLV_SHIFT) * (1 if _GLV_M1 > 0 else -1)
    c2 = ((k * GLV_MU2) >> GLV_SHIFT) * (1 if _GLV_M2 > 0 else -1)
    return k - c1 * _GLV_A1 - c2 * _GLV_A2, -c1 * _GLV_B1 - c2 * _GLV_B2
