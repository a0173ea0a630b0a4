"""Limbed bignum arithmetic in R1CS: the in-circuit side of RSA-2048.

Our rebuild of `zk-email-verify-circuits/bigint.circom` + `fp.circom`:
values are k limbs x n bits (the reference instantiates n=121, k=17 for
RSA-2048, `circuit.circom:310`, `constants.ts:17-18`).  Multiplication
correctness uses the polynomial-identity trick (`BigMultNoCarry`
`bigint.circom:179-218`): interpret limb vectors as polynomial
coefficients and enforce A(t)·B(t) = C(t) at 2k-1 constant points — each
point costs ONE constraint because A(t), B(t) are linear combinations.
Carry correctness of  a·b - (q·p + r) = 0  follows CheckCarryToZero
(`bigint.circom:536-561`): witness carry wires, range-checked, rippled
limb by limb.

The witness side (host hooks) uses Python bigints (`long_div` twin of
`bigint_func.circom:29+`).
"""

from __future__ import annotations

from typing import List, Sequence

from ..field.bn254 import R
from ..snark.r1cs import LC, ConstraintSystem
from .core import num2bits


def limbs_to_int_host(limbs: Sequence[int], n: int) -> int:
    return sum(v << (n * i) for i, v in enumerate(limbs))


def int_to_limbs_host(x: int, n: int, k: int) -> List[int]:
    return [(x >> (n * i)) & ((1 << n) - 1) for i in range(k)]


def alloc_limbs(cs: ConstraintSystem, k: int, label: str) -> List[int]:
    return cs.new_wires(k, label)


def range_check_limbs(cs: ConstraintSystem, limbs: Sequence[int], n: int, tag: str) -> None:
    for i, w in enumerate(limbs):
        num2bits(cs, w, n, f"{tag}.{i}")


def _poly_eval_lc(limbs: Sequence[int], t: int) -> LC:
    """LC for Σ limbs_i · t^i (constant point t)."""
    acc: dict = {}
    power = 1
    for w in limbs:
        acc[w] = (acc.get(w, 0) + power) % R
        power = power * t % R
    return LC(acc)


def big_mult_no_carry(
    cs: ConstraintSystem, a: Sequence[int], b: Sequence[int], tag: str = "bigmul"
) -> List[int]:
    """Unreduced limb product: c_i = Σ_j a_j·b_{i-j} (2k-1 limbs, each up
    to k·2^2n — NOT range checked).  Soundness via 2k-1 point evaluations."""
    k = len(a)
    assert len(b) == k
    c = cs.new_wires(2 * k - 1, f"{tag}.c")

    def conv(*vals):
        av, bv = vals[:k], vals[k:]
        out = [0] * (2 * k - 1)
        for i, x in enumerate(av):
            for j, y in enumerate(bv):
                out[i + j] = (out[i + j] + x * y) % R
        return out

    cs.compute(c, conv, list(a) + list(b))
    for t in range(2 * k - 1):
        cs.enforce(_poly_eval_lc(a, t), _poly_eval_lc(b, t), _poly_eval_lc(c, t), f"{tag}/pt{t}")
    return c


def check_carry_to_zero(
    cs: ConstraintSystem, x_lc: List[LC], n: int, m_bits: int, hook_ins: List[int], hook_fn, tag: str = "ccz"
) -> None:
    """Enforce that the limb vector x (given as LCs, limbs signed with
    |x_i| < 2^m_bits) represents the integer 0: ripple witness carries,
    x_i + carry_{i-1} = carry_i · 2^n, last carry 0
    (CheckCarryToZero, bigint.circom:536-561).

    hook computes the concrete limb values (signed, centered by +2^m_bits
    offset is handled here)."""
    L = len(x_lc)
    carry_bits = m_bits - n + 2
    carries = cs.new_wires(L - 1, f"{tag}.carry")

    def compute_carries(*vals):
        xs = hook_fn(*vals)  # signed ints
        out = []
        c = 0
        for i in range(L - 1):
            total = xs[i] + c
            assert total % (1 << n) == 0, "carry check failed in witness"
            c = total >> n
            out.append(c % R)
        assert xs[L - 1] + c == 0, "nonzero bignum in check_carry_to_zero"
        return out

    cs.compute(carries, compute_carries, hook_ins)
    for i in range(L - 1):
        prev = LC.of(carries[i - 1]) if i > 0 else LC()
        cs.enforce_eq(x_lc[i] + prev, LC.of(carries[i], 1 << n), f"{tag}/limb{i}")
        # range: carry + 2^carry_bits in [0, 2^(carry_bits+1))
        shifted = cs.new_wire(f"{tag}.cs{i}")
        cs.enforce_eq(LC.of(carries[i]) + (1 << carry_bits), LC.of(shifted), f"{tag}/shift{i}")
        cs.compute(shifted, lambda v: (v + (1 << carry_bits)) % R, [carries[i]])
        num2bits(cs, shifted, carry_bits + 1, f"{tag}.cb{i}")
    cs.enforce_eq(x_lc[L - 1] + LC.of(carries[L - 2]), LC(), f"{tag}/last")


def big_mult_mod(
    cs: ConstraintSystem,
    a: Sequence[int],
    b: Sequence[int],
    p: Sequence[int],
    n: int,
    tag: str = "mulmod",
) -> List[int]:
    """r = a·b mod p over k n-bit limbs (FpMul, fp.circom:26-85): witness
    (q, r) by long division, then  a·b - q·p - r = 0  by carry check.
    a, b, p limbs must already be range-checked to n bits by the caller;
    q and r are range-checked here."""
    k = len(a)
    q = cs.new_wires(k, f"{tag}.q")
    r = cs.new_wires(k, f"{tag}.r")
    # The modmul interior is deliberately NOT witness-unique (the
    # bigint.circom / zk-email FpMul design): r is range-checked to k·n
    # bits, not r < p, so (q, r) admits shifted solutions (q-j, r+j·p)
    # — and through them the conv limbs, carries and range-check bits.
    # Soundness is a congruence argument instead: the integer identity
    # a·b = q·p + r (enforced by CheckCarryToZero over range-checked
    # limbs) preserves a·b ≡ r (mod p) for EVERY admissible (q, r), and
    # the chain's final residue is equated limb-wise against a value
    # < p (rsa_verify's PKCS#1 padded digest), which pins the class to
    # its unique representative.  Callers that do not pin the final
    # residue must not rely on intermediate uniqueness.
    _why = (
        "FpMul residue-class freedom: (q, r) -> (q-j, r+j*p) all satisfy; "
        "a*b === r (mod p) is preserved and the final residue is pinned "
        "< p by the consumer (see the comment at big_mult_mod)"
    )
    for g in (f"{tag}.q[*", f"{tag}.r[*", f"{tag}.qb.*", f"{tag}.rb.*",
              f"{tag}.ab.c[*", f"{tag}.qp.c[*", f"{tag}.ccz.*"):
        cs.waive("determinism", g, _why)

    def divide(*vals):
        av = limbs_to_int_host(vals[:k], n)
        bv = limbs_to_int_host(vals[k : 2 * k], n)
        pv = limbs_to_int_host(vals[2 * k :], n)
        qq, rr = divmod(av * bv, pv)
        return int_to_limbs_host(qq, n, k) + int_to_limbs_host(rr, n, k)

    cs.compute(list(q) + list(r), divide, list(a) + list(b) + list(p))
    range_check_limbs(cs, q, n, f"{tag}.qb")
    range_check_limbs(cs, r, n, f"{tag}.rb")

    ab = big_mult_no_carry(cs, a, b, f"{tag}.ab")
    qp = big_mult_no_carry(cs, q, p, f"{tag}.qp")

    # x = ab - qp - r, limbwise (2k-1 limbs; r only spans the first k)
    x_lc = []
    for i in range(2 * k - 1):
        lc = LC.of(ab[i]) - LC.of(qp[i])
        if i < k:
            lc = lc - LC.of(r[i])
        x_lc.append(lc)

    def signed_limbs(*vals):
        abv = vals[: 2 * k - 1]
        qpv = vals[2 * k - 1 : 2 * (2 * k - 1)]
        rv = vals[2 * (2 * k - 1) :]
        out = []
        for i in range(2 * k - 1):
            v = _signed(abv[i]) - _signed(qpv[i]) - (_signed(rv[i]) if i < k else 0)
            out.append(v)
        return out

    m_bits = 2 * n + (k - 1).bit_length() + 1
    check_carry_to_zero(
        cs, x_lc, n, m_bits, list(ab) + list(qp) + list(r), signed_limbs, f"{tag}.ccz"
    )
    return list(r)


def _signed(v: int) -> int:
    """Interpret an Fr element as a (small) signed integer."""
    return v - R if v > R // 2 else v


def big_less_than(cs: ConstraintSystem, a: Sequence[int], b: Sequence[int], n: int, tag: str = "biglt") -> int:
    """a < b over k n-bit limbs (BigLessThan, bigint.circom:298): lexicographic
    fold from the most significant limb."""
    from .core import is_equal, less_than, mux2

    k = len(a)
    # Fold least -> most significant: at limb i, equality defers to the
    # lower-limb verdict, difference decides via lt_i; the outermost
    # (most significant) application dominates, as it must.
    result = less_than(cs, n, a[0], b[0], f"{tag}.lt0")
    for i in range(1, k):
        lt = less_than(cs, n, a[i], b[i], f"{tag}.lt{i}")
        eq = is_equal(cs, a[i], b[i], f"{tag}.eq{i}")
        result = mux2(cs, eq, lt, result, f"{tag}.mux{i}")
    return result


def limbs_equal(cs: ConstraintSystem, a: Sequence[int], b: Sequence[int], tag: str = "bigeq") -> None:
    for i, (x, y) in enumerate(zip(a, b)):
        cs.enforce_eq(LC.of(x), LC.of(y), f"{tag}/{i}")
