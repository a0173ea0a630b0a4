"""Core R1CS gadgets: bits, comparators, selectors, packing.

Our equivalents of the circom stdlib the reference circuits lean on —
circomlib `bitify`/`comparators`/`gates`, `zk-email-verify-circuits/
utils.circom` (`QuinSelector:20-47`, `CalculateTotal:49`, `Bytes2Packed:
120-172`) and `regex_helpers.circom` (`MultiOR:34-47`).  Each gadget
emits constraints AND registers witness hooks, so `cs.witness` stays a
complete host oracle for the vectorised JAX witness tracers.

Convention: functions take the ConstraintSystem first, wires as ints /
lists of ints, and return output wire(s).
"""

from __future__ import annotations

from typing import List, Sequence

from ..field.bn254 import R
from ..snark.r1cs import LC, ConstraintSystem


def const_mul(wire: int, k: int) -> LC:
    return LC.of(wire, k % R)


def lc_sum(wires: Sequence[int], coeffs: Sequence[int] | None = None) -> LC:
    acc = LC()
    for i, w in enumerate(wires):
        acc = acc + LC.of(w, 1 if coeffs is None else coeffs[i] % R)
    return acc


# ------------------------------------------------------------------- bits


def num2bits(cs: ConstraintSystem, x: int, n: int, tag: str = "num2bits", hook: bool = True) -> List[int]:
    """x -> n little-endian bit wires; enforces booleanity + recomposition.
    (circomlib Num2Bits; the decomposition must be unique, so n must be
    small enough that 2^n - 1 < R.)  hook=False: the caller witnesses the
    bits inside its own BlockHook (constraints are emitted regardless)."""
    assert n < 254, "ambiguous decomposition"
    bits = cs.new_wires(n, f"{tag}.b")
    for b in bits:
        cs.enforce_bool(b, f"{tag}/bool")
    cs.enforce_eq(lc_sum(bits, [1 << i for i in range(n)]), LC.of(x), f"{tag}/recompose")
    cs.set_width(x, n)  # recomposition from n bool bits bounds x < 2^n
    if not hook:
        return bits
    import numpy as np

    if n <= 62:  # int64-safe: one vectorized shift for all n bits
        cs.compute_block(bits, lambda m, n=n: (m[0] >> np.arange(n)[:, None]) & 1, [x])
    else:
        # Wide decompositions (bigint limbs): bytes + unpackbits — one
        # to_bytes per element then a C-speed bit explode (the object-int
        # shift matrix was ~0.1 ms per call, the top residual cost of the
        # batch witness tier).
        nb = (n + 7) // 8

        def vfn(m, n=n, nb=nb):
            buf = b"".join(int(v).to_bytes(nb, "little") for v in m[0])
            by = np.frombuffer(buf, dtype=np.uint8).reshape(m.shape[1], nb)
            # object result: the consumers (bigint limb hooks) live on the
            # object matrix — an int64 result would migrate back per hook
            return np.unpackbits(by, axis=1, bitorder="little")[:, :n].T.astype(object)

        cs.compute_block(bits, vfn, [x], int64=False)
    return bits


def bits2num(cs: ConstraintSystem, bits: Sequence[int], tag: str = "bits2num") -> int:
    """Little-endian bit wires -> one wire (no booleanity re-check)."""
    out = cs.new_wire(f"{tag}.out")
    cs.enforce_eq(lc_sum(bits, [1 << i for i in range(len(bits))]), LC.of(out), tag)
    if all(cs.wire_width.get(b, 254) == 1 for b in bits):
        cs.set_width(out, len(bits))
    import numpy as np

    if len(bits) <= 62:
        w = np.asarray([1 << i for i in range(len(bits))], dtype=np.int64)
        cs.compute_block([out], lambda m, w=w: (w @ m)[None, :], list(bits))
    else:
        w = np.asarray([1 << i for i in range(len(bits))], dtype=object)[:, None]
        cs.compute_block(
            [out], lambda m, w=w: ((w * m).sum(axis=0) % R)[None, :], list(bits), int64=False
        )
    return out


def range_check(cs: ConstraintSystem, x: int, n: int, tag: str = "range") -> None:
    """x < 2^n via throwaway bit decomposition."""
    num2bits(cs, x, n, tag)


# ------------------------------------------------------------- comparators


def is_zero(cs: ConstraintSystem, x: int, tag: str = "iszero") -> int:
    """out = 1 iff x == 0 (circomlib IsZero: out = -x*inv + 1, x*out = 0)."""
    inv = cs.new_wire(f"{tag}.inv")
    out = cs.new_wire(f"{tag}.out")
    cs.enforce(LC.of(x), LC.of(inv), LC.const(1) - LC.of(out), f"{tag}/inv")
    cs.enforce(LC.of(x), LC.of(out), LC(), f"{tag}/zero")
    # out is bool for EVERY satisfying witness by case analysis (x=0
    # forces out=1 via the inv row; x!=0 forces out=0 via the zero row)
    cs.set_width(out, 1)
    cs.waive(
        "determinism", f"{tag}.inv",
        "IsZero inverse: unconstrained exactly when x == 0 (then "
        "x*inv = 0 = 1-out holds for every inv); out is still forced "
        "by the case pair, and inv occurs in no other constraint, so "
        "its freedom reaches no other wire",
    )
    cs.compute(inv, lambda v: pow(v, R - 2, R) if v else 0, [x])
    cs.compute(out, lambda v: 0 if v else 1, [x])
    return out


def is_equal(cs: ConstraintSystem, x: int, y: int, tag: str = "iseq") -> int:
    diff = cs.new_wire(f"{tag}.diff")
    cs.enforce_eq(LC.of(x) - LC.of(y), LC.of(diff), f"{tag}/diff")
    cs.compute(diff, lambda a, b: (a - b) % R, [x, y])
    return is_zero(cs, diff, tag)


def is_equal_const(cs: ConstraintSystem, x: int, k: int, tag: str = "iseqc") -> int:
    """x == constant k, without a diff wire."""
    inv = cs.new_wire(f"{tag}.inv")
    out = cs.new_wire(f"{tag}.out")
    cs.enforce(LC.of(x) - k, LC.of(inv), LC.const(1) - LC.of(out), f"{tag}/inv")
    cs.enforce(LC.of(x) - k, LC.of(out), LC(), f"{tag}/zero")
    cs.set_width(out, 1)  # bool by the IsZero case pair
    cs.waive(
        "determinism", f"{tag}.inv",
        "IsZero inverse (x==k case): free only when the difference is "
        "zero, where out is already forced; occurs in no other constraint",
    )
    cs.compute(inv, lambda v: pow((v - k) % R, R - 2, R) if (v - k) % R else 0, [x])
    cs.compute(out, lambda v: 1 if v == k % R else 0, [x])
    return out


def less_than(cs: ConstraintSystem, n: int, a: int, b: int, tag: str = "lt") -> int:
    """a < b for a, b < 2^n (circomlib LessThan: top bit of a - b + 2^n)."""
    assert n < 252
    # soundness REQUIRES a, b < 2^n: an unbounded operand wraps the
    # shifted difference and flips the verdict — the classic circom
    # comparator forgery.  The static auditor checks the demand.
    cs.require_width(a, n, f"{tag}/less_than.a")
    cs.require_width(b, n, f"{tag}/less_than.b")
    shifted = cs.new_wire(f"{tag}.shift")
    cs.enforce_eq(LC.of(a) - LC.of(b) + (1 << n), LC.of(shifted), f"{tag}/shift")
    cs.compute(shifted, lambda x, y: (x - y + (1 << n)) % R, [a, b])
    bits = num2bits(cs, shifted, n + 1, f"{tag}.bits")
    out = cs.new_wire(f"{tag}.out")
    cs.enforce_eq(LC.const(1) - LC.of(bits[n]), LC.of(out), f"{tag}/out")
    cs.set_width(out, 1)  # 1 - (bool bit)
    cs.compute(out, lambda top: 1 - top, [bits[n]])
    return out


# ---------------------------------------------------------------- boolean


def and_gate(cs: ConstraintSystem, a: int, b: int, tag: str = "and") -> int:
    cs.require_width(a, 1, f"{tag}/and.a")  # product == AND only for bools
    cs.require_width(b, 1, f"{tag}/and.b")
    out = cs.new_wire(f"{tag}.out")
    cs.enforce(LC.of(a), LC.of(b), LC.of(out), tag)
    cs.set_width(out, 1)
    cs.compute(out, lambda x, y: x * y % R, [a, b])
    return out


def multi_or(cs: ConstraintSystem, bits: Sequence[int], tag: str = "or") -> int:
    """OR of boolean wires as NOT(sum == 0) (regex_helpers MultiOR:34-47)."""
    for i, w in enumerate(bits):
        cs.require_width(w, 1, f"{tag}/or.in{i}")  # field sum of bools
    total = cs.new_wire(f"{tag}.sum")
    cs.enforce_eq(lc_sum(bits), LC.of(total), f"{tag}/sum")
    cs.set_width(total, max(1, len(list(bits)).bit_length()))
    cs.compute(total, lambda *bs: sum(bs) % R, list(bits))
    z = is_zero(cs, total, f"{tag}.z")
    out = cs.new_wire(f"{tag}.out")
    cs.enforce_eq(LC.const(1) - LC.of(z), LC.of(out), f"{tag}/not")
    cs.set_width(out, 1)
    cs.compute(out, lambda v: 1 - v, [z])
    return out


def mux2(cs: ConstraintSystem, sel: int, a: int, b: int, tag: str = "mux") -> int:
    """sel ? b : a  (sel boolean)."""
    cs.require_width(sel, 1, f"{tag}/mux.sel")  # sel=2 would leak a-2b+2out
    out = cs.new_wire(f"{tag}.out")
    cs.enforce(LC.of(sel), LC.of(b) - LC.of(a), LC.of(out) - LC.of(a), tag)
    # branch-free (x + s*(y-x)): columnar-safe for the batch witness tier
    cs.compute(out, lambda s, x, y: x + s * (y - x), [sel, a, b])
    return out


# ---------------------------------------------------------------- selectors


def one_hot(cs: ConstraintSystem, idx: int, n: int, tag: str = "onehot") -> List[int]:
    """Indicator wires ind[i] = (idx == i) with Σ ind = 1 and Σ i·ind = idx.

    The two closing sums make the decomposition sound without per-lane
    IsEqual inverses being trusted blindly.  All lane inverses come from
    ONE BlockHook via Montgomery batch inversion — one exponentiation per
    call instead of n per witness (the per-lane pow hooks were the
    dominant fallback cost of the batch witness tier)."""
    import numpy as np

    invs: List[int] = []
    inds: List[int] = []
    for i in range(n):
        inv = cs.new_wire(f"{tag}.{i}.inv")
        out = cs.new_wire(f"{tag}.{i}.out")
        cs.enforce(LC.of(idx) - i, LC.of(inv), LC.const(1) - LC.of(out), f"{tag}.{i}/inv")
        cs.enforce(LC.of(idx) - i, LC.of(out), LC(), f"{tag}.{i}/zero")
        invs.append(inv)
        inds.append(out)
        # ind*(idx-i)=0 with sum(ind)=1 and sum(i*ind)=idx makes each
        # lane 0/1 for satisfying witnesses (invs stay full-width)
        cs.set_width(out, 1)
    cs.waive(
        "determinism", f"{tag}.*.inv",
        "one-hot lane inverse: unconstrained exactly on the selected "
        "lane (idx == i), where the lane output is forced by the case "
        "pair and the two closing sums; each inv occurs in no other "
        "constraint, so its freedom reaches no other wire",
    )
    cs.enforce_eq(lc_sum(inds), LC.const(1), f"{tag}/onehot")
    cs.enforce_eq(lc_sum(inds, list(range(n))), LC.of(idx), f"{tag}/index")
    cs.set_width(idx, max(1, (n - 1).bit_length()))

    def vfn(m, n=n):
        v = m[0]  # (K,) object
        diffs = (v[None, :] - np.arange(n, dtype=object)[:, None]) % R  # (n, K)
        flat = diffs.reshape(-1)
        nz = np.flatnonzero(flat)
        xs = [int(flat[j]) for j in nz]
        # Montgomery trick: len(xs) inverses for 3 muls each + one pow.
        prefix = [1] * (len(xs) + 1)
        for j, x in enumerate(xs):
            prefix[j + 1] = prefix[j] * x % R
        inv_run = pow(prefix[-1], R - 2, R)
        inv_flat = np.zeros_like(flat)
        for j in range(len(xs) - 1, -1, -1):
            inv_flat[nz[j]] = prefix[j] * inv_run % R
            inv_run = inv_run * xs[j] % R
        invs_m = inv_flat.reshape(n, -1)
        outs_m = np.asarray(flat == 0, dtype=object).reshape(n, -1) * 1
        # creation order: inv, out, inv, out, ...
        return np.stack([invs_m, outs_m], axis=1).reshape(2 * n, -1)

    wires = [w for pair in zip(invs, inds) for w in pair]
    cs.compute_block(wires, vfn, [idx], int64=False)
    return inds


def quin_selector(cs: ConstraintSystem, idx: int, options: Sequence[int], tag: str = "quin") -> int:
    """out = options[idx] (utils.circom QuinSelector:20-47): one-hot dot.

    The select products are emitted directly rather than through
    and_gate: options are arbitrary field values, and and_gate's bool
    demand on both operands (correct for AND) was the first bool-width
    finding of the circuit auditor — a select is a mul, not an AND."""
    inds = one_hot(cs, idx, len(options), tag)
    out = cs.new_wire(f"{tag}.out")
    prods = []
    for i, (ind, opt) in enumerate(zip(inds, options)):
        p = cs.new_wire(f"{tag}.p{i}.out")
        cs.enforce(LC.of(ind), LC.of(opt), LC.of(p), f"{tag}.p{i}")
        cs.set_width(p, cs.wire_width.get(opt, 254))  # bool lane x option
        cs.compute(p, lambda s, v: s * v % R, [ind, opt])
        prods.append(p)
    cs.enforce_eq(lc_sum(prods), LC.of(out), f"{tag}/sum")
    cs.set_width(out, max((cs.wire_width.get(p, 254) for p in prods), default=254))
    cs.compute(out, lambda *ps: sum(ps) % R, prods)
    return out


# ----------------------------------------------------------------- packing


def pack_bytes(cs: ConstraintSystem, byte_wires: Sequence[int], n_per: int = 7, tag: str = "pack") -> List[int]:
    """Pack byte wires into little-endian n_per-byte field words
    (utils.circom Bytes2Packed:120-172; 7 bytes/signal keeps values < 2^56).
    Bytes must already be range-checked to 8 bits by the producer (the
    static auditor enforces the demand: an unbounded byte forges the
    packed word)."""
    for i, w in enumerate(byte_wires):
        cs.require_width(w, 8, f"{tag}/pack.byte{i}")
    out = []
    for chunk_i in range(0, len(byte_wires), n_per):
        chunk = byte_wires[chunk_i : chunk_i + n_per]
        w = cs.new_wire(f"{tag}.word{chunk_i // n_per}")
        cs.enforce_eq(lc_sum(chunk, [1 << (8 * j) for j in range(len(chunk))]), LC.of(w), f"{tag}/word")
        cs.compute(w, lambda *bs: sum(b << (8 * j) for j, b in enumerate(bs)) % R, list(chunk))
        out.append(w)
    return out


def assert_bytes(cs: ConstraintSystem, wires: Sequence[int], tag: str = "byte") -> List[List[int]]:
    """Range-check wires to 8 bits; returns the bit decompositions."""
    return [num2bits(cs, w, 8, f"{tag}.{i}") for i, w in enumerate(wires)]
