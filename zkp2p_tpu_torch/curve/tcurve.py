"""BN254 group arithmetic on torch limb tensors (port of the reference's
``curve/jcurve.py``): G1 over Fq, G2 over Fq2.

Points are Jacobian triples of Montgomery limb tensors, int32: G1
coordinates ``(..., 16)``, G2 ``(..., 2, 16)``.  Jacobian infinity is
Z = 0; the affine infinity sentinel is (0, 0), which is on neither curve.
double/add/add_mixed are the kernels K2-K4 (``ops.cuda_curve``) on CUDA
tensors and their plain versions on CPU tensors.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..field.bn254 import P
from ..field.tfield import FQ, FQ2, NUM_LIMBS
from ..field.tower import Fq2
from ..ops import cuda_curve
from .host import G1Point, G2Point, g1_jac_to_affine, g2_jac_to_affine

JacPoint = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
AffPoint = Tuple[torch.Tensor, torch.Tensor]


class TCurve:
    """Short-Weierstrass a = 0 curve ops over a vectorised field."""

    def __init__(self, field, g2: bool):
        self.F = field
        self.g2 = g2
        self.elem = (2, NUM_LIMBS) if g2 else (NUM_LIMBS,)
        self._double = cuda_curve.g2_double if g2 else cuda_curve.g1_double
        self._add = cuda_curve.g2_add if g2 else cuda_curve.g1_add
        self._add_mixed = cuda_curve.g2_add_mixed if g2 else cuda_curve.g1_add_mixed

    def infinity(self, batch_shape: Tuple[int, ...], device) -> JacPoint:
        z = torch.zeros(tuple(batch_shape) + self.elem, dtype=torch.int32, device=device)
        return (z, z, z)

    def is_inf(self, p: JacPoint) -> torch.Tensor:
        return self.F.is_zero(p[2])

    def is_inf_affine(self, a: AffPoint) -> torch.Tensor:
        return self.F.is_zero(a[0]) & self.F.is_zero(a[1])

    def from_affine(self, a: AffPoint) -> JacPoint:
        """Affine -> Jacobian; the (0, 0) sentinel maps to Z = 0."""
        one = self.F.one_like(a[0])
        z = self.F.select(self.is_inf_affine(a), torch.zeros_like(a[0]), one)
        return (a[0], a[1], z)

    def neg(self, p: JacPoint) -> JacPoint:
        return (p[0], self.F.neg(p[1]), p[2])

    def select(self, cond: torch.Tensor, p: JacPoint, q: JacPoint) -> JacPoint:
        F = self.F
        return tuple(F.select(cond, x, y) for x, y in zip(p, q))

    def double(self, p: JacPoint) -> JacPoint:
        """dbl-2009-l (K4); infinity -> infinity."""
        return self._double(p)

    def add(self, p: JacPoint, q: JacPoint) -> JacPoint:
        """Complete Jacobian add (K2): infinity, equal and negated lanes."""
        return self._add(p, q)

    def add_mixed(self, p: JacPoint, a: AffPoint) -> JacPoint:
        """p (Jacobian) + a (affine, (0, 0) = infinity) (K3)."""
        return self._add_mixed(p, a)


G1C = TCurve(FQ, g2=False)
G2C = TCurve(FQ2, g2=True)


# ------------------------------------------------- host <-> device bridges


def g1_to_affine_arrays(points: Sequence[G1Point], device) -> AffPoint:
    """Host affine G1 -> (n, 16) Montgomery limb tensors; None -> (0, 0)."""
    n = len(points)
    xs = np.zeros((n, NUM_LIMBS), dtype=np.int32)
    ys = np.zeros((n, NUM_LIMBS), dtype=np.int32)
    for i, pt in enumerate(points):
        if pt is None:
            continue
        xs[i] = FQ.to_mont_host(pt[0])
        ys[i] = FQ.to_mont_host(pt[1])
    return torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)


def g2_to_affine_arrays(points: Sequence[G2Point], device) -> AffPoint:
    """Host affine G2 -> (n, 2, 16) Montgomery limb tensors."""
    n = len(points)
    xs = np.zeros((n, 2, NUM_LIMBS), dtype=np.int32)
    ys = np.zeros((n, 2, NUM_LIMBS), dtype=np.int32)
    for i, pt in enumerate(points):
        if pt is None:
            continue
        x, y = pt
        xs[i, 0], xs[i, 1] = FQ.to_mont_host(x.c0), FQ.to_mont_host(x.c1)
        ys[i, 0], ys[i, 1] = FQ.to_mont_host(y.c0), FQ.to_mont_host(y.c1)
    return torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)


def _fq(limbs) -> int:
    return FQ.from_mont_host(limbs)


def g1_jac_to_host(p: JacPoint) -> List[G1Point]:
    """Jacobian batch -> host affine points (results only)."""
    X, Y, Z = (c.detach().cpu().numpy().reshape(-1, NUM_LIMBS) for c in p)
    return [g1_jac_to_affine(_fq(X[i]), _fq(Y[i]), _fq(Z[i]) % P) for i in range(X.shape[0])]


def g2_jac_to_host(p: JacPoint) -> List[G2Point]:
    X, Y, Z = (c.detach().cpu().numpy().reshape(-1, 2, NUM_LIMBS) for c in p)
    out: List[G2Point] = []
    for i in range(X.shape[0]):
        x, y, z = (Fq2(_fq(C[i, 0]), _fq(C[i, 1])) for C in (X, Y, Z))
        out.append(g2_jac_to_affine(x, y, z))
    return out
