"""BN254 field parameters for the port: the moduli, the Montgomery
constants of the 16 x 16-bit limb layout, and the Fr roots of unity.

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
