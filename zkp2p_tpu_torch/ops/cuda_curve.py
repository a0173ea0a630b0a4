"""BN254 point operations: the CUDA kernels K2-K4 and their plain versions.

Replaces the reference's fused Pallas point kernels
(``ops/pallas_curve.py``: ``g1_add``, ``g1_add_mixed``, ``g1_double``,
``g2_add``, ``g2_add_mixed``, ``g2_double``).  Points are Jacobian triples
of limb tensors: G1 coordinates ``(..., 16)``, G2 coordinates
``(..., 2, 16)``, int32, Montgomery form.  Jacobian infinity is Z = 0;
the affine infinity sentinel is (0, 0).

Each wrapper launches its kernel (``csrc/point_ops.cu``, one template
over the field type) for CUDA tensors and runs the plain version for CPU
tensors.  The plain versions are the reference's point math
(dbl-2009-l, add-2007-bl with its case selects in the same order),
written once over a field-ops object and computed branch-free in int64
torch ops; independent field products are stacked into one batched
product.  They equal the kernels bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..field.tfield import FQ
from . import cuda_build
from .cuda_mont import NUM_LIMBS, add_mod, check_cuda_operand, field_consts, mont_mul_plain64, sub_mod


# ---------------------------------------------------------- plain versions


class _FqPlain:
    """Fq ops on int64 limb tensors (..., 16)."""

    elem_dims = 1

    def __init__(self, device):
        self.n, self.nprime, self.negn, self.one = (FQ.const(k, device) for k in ("n", "nprime", "negn", "one"))

    def mul(self, *pairs):
        """Products of independent (a, b) pairs, stacked into one batch."""
        shape = torch.broadcast_shapes(*(x.shape for pr in pairs for x in pr))
        a = torch.stack([x.expand(shape) for x, _ in pairs])
        b = torch.stack([y.expand(shape) for _, y in pairs])
        return mont_mul_plain64(a, b, self.n, self.nprime, self.negn).unbind(0)

    def add(self, a, b):
        return add_mod(a, b, self.negn)

    def sub(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return sub_mod(a, b, self.n)

    def is_zero(self, a):
        return (a == 0).flatten(-self.elem_dims).all(dim=-1)

    def sel(self, cond, a, b):
        return torch.where(cond.reshape(cond.shape + (1,) * self.elem_dims), a, b)

    def one_like(self, a):
        return self.one.expand_as(a)


class _Fq2Plain(_FqPlain):
    """Fq2 = Fq[u]/(u^2 + 1) on (..., 2, 16); Karatsuba product.  add and
    sub act limb-wise on both components at once."""

    elem_dims = 2

    def mul(self, *pairs):
        prods = []
        for a, b in pairs:
            a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
            prods += [(a0, b0), (a1, b1), (self.add(a0, a1), self.add(b0, b1))]
        flat = super().mul(*prods)
        out = []
        for k in range(len(pairs)):
            v0, v1, s = flat[3 * k : 3 * k + 3]
            out.append(torch.stack([self.sub(v0, v1), self.sub(s, self.add(v0, v1))], dim=-2))
        return out

    def one_like(self, a):
        one = self.one.expand_as(a[..., 0, :])
        return torch.stack([one, torch.zeros_like(one)], dim=-2)


def _psel(f, cond, p, q):
    return tuple(f.sel(cond, x, y) for x, y in zip(p, q))


def _double_math(f, X1, Y1, Z1):
    A, B, YZ = f.mul((X1, X1), (Y1, Y1), (Y1, Z1))
    XB = f.add(X1, B)
    C, XB2 = f.mul((B, B), (XB, XB))
    t = f.sub(f.sub(XB2, A), C)
    D = f.add(t, t)
    E = f.add(f.add(A, A), A)
    (Fv,) = f.mul((E, E))
    X3 = f.sub(Fv, f.add(D, D))
    C8 = f.add(C, C)
    C8 = f.add(C8, C8)
    C8 = f.add(C8, C8)
    (EDX,) = f.mul((E, f.sub(D, X3)))
    Y3 = f.sub(EDX, C8)
    Z3 = f.add(YZ, YZ)
    return X3, Y3, Z3


def _add_core_math(f, p, q, U1, U2, S1, S2, Z1Z2):
    H = f.sub(U2, U1)
    Rr = f.sub(S2, S1)
    HH, R2 = f.mul((H, H), (Rr, Rr))
    HHH, V = f.mul((H, HH), (U1, HH))
    X3 = f.sub(f.sub(R2, HHH), f.add(V, V))
    RV, SH, Z3 = f.mul((Rr, f.sub(V, X3)), (S1, HHH), (Z1Z2, H))
    res = (X3, f.sub(RV, SH), Z3)

    same_x = f.is_zero(H)
    same_y = f.is_zero(Rr)
    dbl = same_x & same_y
    # on the CPU, as the kernels branch, the doubling only when a lane
    # needs it; elsewhere always (no host sync)
    if dbl.device.type != "cpu" or bool(dbl.any()):
        res = _psel(f, dbl, _double_math(f, *p), res)
    zero = torch.zeros_like(res[0])
    res = _psel(f, same_x & ~same_y, (zero, zero, zero), res)
    res = _psel(f, f.is_zero(p[2]), q, res)
    res = _psel(f, f.is_zero(q[2]), p, res)
    return res


def _add_math(f, p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2, YZ1, YZ2, Z1Z2 = f.mul((Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1), (Z1, Z2))
    U1, U2, S1, S2 = f.mul((X1, Z2Z2), (X2, Z1Z1), (YZ1, Z2Z2), (YZ2, Z1Z1))
    return _add_core_math(f, p, q, U1, U2, S1, S2, Z1Z2)


def _add_mixed_math(f, p, a):
    X1, Y1, Z1 = p
    X2, Y2 = a
    (Z1Z1,) = f.mul((Z1, Z1))
    U2, Z1c = f.mul((X2, Z1Z1), (Z1, Z1Z1))
    (S2,) = f.mul((Y2, Z1c))
    # q = from_affine(a): (0, 0) -> Z = 0, else Z = Montgomery one
    a_inf = f.is_zero(X2) & f.is_zero(Y2)
    zq = f.sel(a_inf, torch.zeros_like(X2), f.one_like(X2))
    return _add_core_math(f, p, (X2, Y2, zq), X1, U2, Y1, S2, Z1)


def point_op_plain(op: str, g2: bool, *coords: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of one point kernel on int32 limb tensors, any
    device: op in ("add", "add_mixed", "double"); coords are (X, Y, Z) of
    p followed by q's (X, Y, Z) for add or a's (X, Y) for add_mixed."""
    f = (_Fq2Plain if g2 else _FqPlain)(coords[0].device)
    cs = [c.long() for c in coords]
    if op == "add":
        out = _add_math(f, tuple(cs[:3]), tuple(cs[3:6]))
    elif op == "add_mixed":
        out = _add_mixed_math(f, tuple(cs[:3]), tuple(cs[3:5]))
    else:
        out = _double_math(f, *cs[:3])
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    return tuple(o.expand(shape).to(torch.int32) for o in out)


# ------------------------------------------------------------------ wrappers


def _run(op: str, g2: bool, coords) -> Tuple[torch.Tensor, ...]:
    dev = coords[0].device
    if all(c.device.type == "cpu" for c in coords):
        return point_op_plain(op, g2, *coords)
    if dev.type != "cuda" or any(c.device != dev for c in coords):
        raise ValueError(f"{op}: operands on {sorted({str(c.device) for c in coords})}; expected one cuda device")
    elem = (2, NUM_LIMBS) if g2 else (NUM_LIMBS,)
    nd = len(elem)
    for c in coords:
        if tuple(c.shape[-nd:]) != elem:
            raise ValueError(f"{op}: coordinate shape {tuple(c.shape)} does not end in {elem}")
    shape = coords[0].shape
    if any(c.shape != shape for c in coords):
        shape = torch.broadcast_shapes(*(c.shape for c in coords))
        coords = [c.expand(shape) for c in coords]
    ins = [c if c.is_contiguous() else c.contiguous() for c in coords]
    for k, c in enumerate(ins):
        check_cuda_operand(c, f"{op} operand {k}")
    outs = [torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(3)]
    n = math.prod(shape[:-nd])
    if n:
        name = f"zk_{'g2' if g2 else 'g1'}_{op}"
        cuda_build.launch(
            "point_ops", name,
            *(c.data_ptr() for c in ins), *(o.data_ptr() for o in outs), n,
            field_consts(FQ).ctypes.data,
        )
    return tuple(outs)


def g1_add(p, q):
    """Complete Jacobian + Jacobian over Fq (K2)."""
    return _run("add", False, (*p, *q))


def g1_add_mixed(p, a):
    """Jacobian + affine over Fq, (0, 0) = infinity (K3)."""
    return _run("add_mixed", False, (*p, *a))


def g1_double(p):
    """Jacobian doubling over Fq (K4)."""
    return _run("double", False, tuple(p))


def g2_add(p, q):
    """G2 Jacobian + Jacobian over Fq2 (K2); coordinates (..., 2, 16)."""
    return _run("add", True, (*p, *q))


def g2_add_mixed(p, a):
    return _run("add_mixed", True, (*p, *a))


def g2_double(p):
    return _run("double", True, tuple(p))
