"""The batch-affine arm's kernels: K15 (batch inversion, Jacobian -> affine;
``csrc/batch_inv.cu``) and K16 (the complete affine add and the windowed
affine accumulate, G1 and G2; ``csrc/affine_add.cu``).

Replaces, on the batch-affine arm, the reference's Fermat inversion
``mont_pow`` (``ops/pallas_mont.py``) with the ``mont_mul`` products and
plain XLA around it in ``ops/msm_affine.py`` and ``ops/msm_bucket.py``.
Each block of a launch inverts its own elements' values with one
inversion (``csrc/affine.cuh``); the inverse of a nonzero element is
unique, so the outputs equal the plain route's, which inverts the whole
batch at once.

These wrappers launch their kernels and take CUDA tensors only; the
dispatching entries, which run the plain versions for CPU tensors, are in
``ops/msm_affine.py`` (``batch_inverse``, ``jac_to_affine_batch``,
``affine_add_complete``, ``affine_accumulate``), beside the plain
versions themselves.

Layouts: int32 limbs in Montgomery form, an element ``(16,)`` over Fq and
Fr, ``(2, 16)`` over Fq2; affine triples (x, y, inf) with a bool inf and
(0, 0) coordinates at infinity.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..field.tfield import FQ
from . import cuda_build
from .cuda_mont import NUM_LIMBS, check_cuda_operand, field_consts

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_R3 = {}


def inv_consts(field) -> np.ndarray:
    """The kernels' InvConst block: R^3 mod N (8 words), R = 2^256."""
    got = _R3.get(field.modulus)
    if got is None:
        r3 = pow(2, 768, field.modulus)
        got = _R3[field.modulus] = np.array([(r3 >> (32 * i)) & 0xFFFFFFFF for i in range(8)], dtype=np.uint32)
    return got


def _cuda(name: str, tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: operands on {sorted(str(d) for d in devs)}; the kernel takes one CUDA device")
    return next(iter(devs))


def batch_inverse(field, x: torch.Tensor, deg: int) -> torch.Tensor:
    """x^-1 of every element of x, (..., 16) over `field` (deg 1) or
    (..., 2, 16) over Fq2 (deg 2); 0 -> 0.  One launch of K15."""
    _cuda("batch_inverse", (x,))
    elem = (NUM_LIMBS,) if deg == 1 else (2, NUM_LIMBS)
    if tuple(x.shape[x.dim() - len(elem):]) != elem or (deg == 2 and field is not FQ):
        raise ValueError(f"batch_inverse: limbs {tuple(x.shape)} over {field.name}, deg {deg}")
    x = x if x.is_contiguous() else x.contiguous()
    check_cuda_operand(x, "batch_inverse x")
    out = torch.empty_like(x)
    n = x.numel() // math.prod(elem)
    if n:
        cuda_build.launch("batch_inv", "zk_batch_inverse", x.data_ptr(), out.data_ptr(), n, deg,
                          field_consts(field).ctypes.data, inv_consts(field).ctypes.data)
    return out


def jac_to_affine(pts: Triple, deg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobian (X, Y, Z) -> affine (X / Z^2, Y / Z^3) over Fq (deg 1) or
    Fq2 (deg 2), any batch shape; Z = 0 -> (0, 0).  One launch of K15."""
    _cuda("jac_to_affine", pts)
    elem = (NUM_LIMBS,) if deg == 1 else (2, NUM_LIMBS)
    shape = pts[0].shape
    if any(c.shape != shape for c in pts) or tuple(shape[len(shape) - len(elem):]) != elem:
        raise ValueError(f"jac_to_affine: coordinates {[tuple(c.shape) for c in pts]}, deg {deg}")
    X, Y, Z = (c if c.is_contiguous() else c.contiguous() for c in pts)
    for c in (X, Y, Z):
        check_cuda_operand(c, "jac_to_affine coordinate")
    ox, oy = torch.empty_like(X), torch.empty_like(X)
    n = X.numel() // math.prod(elem)
    if n:
        cuda_build.launch("batch_inv", "zk_jac_to_affine", X.data_ptr(), Y.data_ptr(), Z.data_ptr(),
                          ox.data_ptr(), oy.data_ptr(), n, deg, field_consts(FQ).ctypes.data,
                          inv_consts(FQ).ctypes.data)
    return ox, oy


def _rows(t: torch.Tensor, tail: int, name: str) -> Tuple[torch.Tensor, int]:
    """t with its dims after the first contiguous (copied if not), and its
    row stride in units of the `tail` trailing dims' elements."""
    if t.dtype != (torch.int32 if tail else torch.bool):
        raise TypeError(f"{name}: dtype {t.dtype}")
    if t.shape[0] <= 1:  # one row: its stride is never used
        return t.contiguous(), 0
    unit = math.prod(t.shape[t.dim() - tail:]) if tail else 1
    if not t[0].is_contiguous() or t.stride(0) % unit or (tail and t.data_ptr() % 16):
        t = t.contiguous()
    return t, t.stride(0) // unit


def affine_add(g2: bool, a: Triple, b: Triple) -> Triple:
    """a + b for affine triples over G1 (x, y (rows, *inner, 16)) or G2
    ((rows, *inner, 2, 16)), inf (rows, *inner): one launch of K16.  Each
    operand may be a view with any row stride (a slice with a step, a row
    broadcast at stride 0) whose dims after the first are contiguous; the
    result is contiguous."""
    name = f"{'g2' if g2 else 'g1'}_affine_add"
    _cuda(name, (*a, *b))
    nd = 2 if g2 else 1
    shape = a[2].shape
    if a[2].dim() < 1 or b[2].shape != shape or any(
            c.shape != shape + ((2, NUM_LIMBS) if g2 else (NUM_LIMBS,)) for c in (*a[:2], *b[:2])):
        raise ValueError(f"{name}: operands {[tuple(c.shape) for c in (*a, *b)]}")
    if any(c.dtype != torch.bool for c in (a[2], b[2])):
        raise TypeError(f"{name}: the infinity flags must be bool")
    rows, inner = shape[0], math.prod(shape[1:])
    ops = []
    for x, y, inf in (a, b):
        x, xs = _rows(x, nd, name)
        y, ys = _rows(y, nd, name)
        if xs != ys:
            x, y = x.contiguous(), y.contiguous()
            xs = ys = inner
        inf, fs = _rows(inf, 0, name)
        ops += [x.data_ptr(), y.data_ptr(), inf.data_ptr(), xs, fs]
    dev = a[0].device
    elem = (2, NUM_LIMBS) if g2 else (NUM_LIMBS,)
    ox = torch.empty(shape + elem, dtype=torch.int32, device=dev)
    oy = torch.empty_like(ox)
    oinf = torch.empty(shape, dtype=torch.bool, device=dev)
    if rows * inner:
        cuda_build.launch("affine_add", "zk_" + name, *ops, ox.data_ptr(), oy.data_ptr(), oinf.data_ptr(),
                          rows, inner, field_consts(FQ).ctypes.data, inv_consts(FQ).ctypes.data)
    return ox, oy, oinf


def affine_accumulate(g2: bool, acc: Triple, table: Tuple[torch.Tensor, torch.Tensor], mags: torch.Tensor,
                      negs: torch.Tensor, s0: int) -> Triple:
    """The affine partials acc (n_digits, lanes) plus, for each step t of
    the affine table (T, n_table, lanes), the entry its digit selects (Y
    negated for a negative digit; digit 0 adds nothing): digit planes
    (n_digits, steps, lanes) read at steps s0 .. s0+T-1 in place at their
    strides.  One launch of K16; acc is not written."""
    name = f"{'g2' if g2 else 'g1'}_affine_accumulate"
    _cuda(name, (*acc, *table, mags, negs))
    elem = (2, NUM_LIMBS) if g2 else (NUM_LIMBS,)
    if mags.dim() != 3 or negs.shape != mags.shape or negs.dtype != torch.bool or mags.dtype != torch.int32:
        raise ValueError(f"{name}: planes {tuple(mags.shape)} {mags.dtype} / {tuple(negs.shape)} {negs.dtype}")
    n_digits, steps, lanes = mags.shape
    T, n_table = table[0].shape[:2]
    if not 0 <= s0 <= s0 + T <= steps:
        raise ValueError(f"{name}: steps {s0}..{s0 + T} of {steps}")
    want = {"acc": (n_digits, lanes) + elem, "table": (T, n_table, lanes) + elem}
    ins = []
    for what, cs in (("acc", acc[:2]), ("table", table)):
        for c in cs:
            if tuple(c.shape) != want[what]:
                raise ValueError(f"{name}: {what} {tuple(c.shape)}, expected {want[what]}")
            c = c if c.is_contiguous() else c.contiguous()
            check_cuda_operand(c, f"{name} {what}")
            ins.append(c)
    ainf = acc[2]
    if tuple(ainf.shape) != (n_digits, lanes) or ainf.dtype != torch.bool:
        raise ValueError(f"{name}: acc inf {tuple(ainf.shape)} {ainf.dtype}")
    ainf = ainf.contiguous()
    if not (n_digits and lanes and T):
        return ins[0], ins[1], ainf
    ox, oy = torch.empty_like(ins[0]), torch.empty_like(ins[0])
    oinf = torch.empty_like(ainf)
    cuda_build.launch(
        "affine_add", "zk_" + name,
        ins[0].data_ptr(), ins[1].data_ptr(), ainf.data_ptr(), ins[2].data_ptr(), ins[3].data_ptr(),
        mags.data_ptr(), negs.data_ptr(), ox.data_ptr(), oy.data_ptr(), oinf.data_ptr(),
        n_digits, lanes, n_table, T, s0, *mags.stride(), *negs.stride(),
        field_consts(FQ).ctypes.data, inv_consts(FQ).ctypes.data,
    )
    return ox, oy, oinf


def inv_model(a: int, modulus: int):
    """K15's inversion (``csrc/affine.cuh``: fe_inv) step for step over
    Python ints: the Montgomery form a = xR in, (x^-1 R, rounds) out, 0 ->
    (0, 0); rounds counts the subtractions, whose number sets the kernel's
    time."""
    if a == 0:
        return 0, 0
    n0 = -pow(modulus, -1, 1 << 32) % (1 << 32)

    def make_odd(u, x):
        while not u & 1:
            low = u & 0xFFFFFFFF
            k = (low & -low).bit_length() - 1 if low else 31
            m = (x * n0) & ((1 << k) - 1)
            u, x = u >> k, (x + m * modulus) >> k
            assert x < modulus
        return u, x

    u, v, x1, x2 = a, modulus, 1, 0
    u, x1 = make_odd(u, x1)
    rounds = 0
    while u != v:
        rounds += 1
        if u > v:
            u, x1 = make_odd(u - v, (x1 - x2) % modulus)
        else:
            v, x2 = make_odd(v - u, (x2 - x1) % modulus)
    assert u == 1 and a * x1 % modulus == 1
    r3 = pow(2, 768, modulus)
    return x1 * r3 * pow(2, -256, modulus) % modulus, rounds  # the Montgomery product by R^3
