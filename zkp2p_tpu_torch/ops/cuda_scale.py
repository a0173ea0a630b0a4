"""n affine G1 points scaled by one shared scalar in one launch of kernel
K19 (``csrc/scale.cu``): the phase-2 ceremony's rescale of the C and H
queries by 1/delta' (``snark/ceremony.py``).

No Pallas counterpart: the reference runs it in its native C++ library
(``csrc/zkp2p_native.cpp``, ``g1_scale_batch``), else one host ``g1_mul``
a point.  As the native code, the scalar's width-2 NAF is computed once
(``naf_digits``, the native rule: least significant digit first, an odd
remainder r gives -1 where r = 3 mod 4, else 1) and every point runs a
left-to-right double-and-add over it from acc = P at the top digit,
adding P or -P (y negated as 0 - y) at a nonzero digit.  A (0, 0) hole,
or the scalar 0, gives the Jacobian (0, 0, 0).

``g1_scale`` launches K19 for CUDA tensors and runs ``g1_scale_plain``
for CPU tensors; a tensor on any other device raises.  Both give Jacobian
points; the plain version runs the same digits with the same formulas
(``ops.cuda_curve.point_op_plain``: the K4 doubling, the K3 mixed add), so
the kernel equals it bit for bit.  ``ops.msm_affine.jac_to_affine_batch``
(K15) makes them affine limbs, which are unique, so they equal the
reference's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..curve.tcurve import AffPoint, JacPoint
from ..field.tfield import FQ
from . import cuda_build
from .cuda_curve import point_op_plain
from .cuda_mont import NUM_LIMBS, check_cuda_operand, field_consts

MAX_DIGITS = 264  # csrc/scale.cu's SCALE_MAX_DIGITS; a 256-bit scalar has at most 257


def naf_digits(k: int) -> List[int]:
    """The width-2 NAF of 0 <= k < 2^256, least significant digit first,
    each -1, 0 or 1, the top one 1 ([] for 0): the native code's rule."""
    if not 0 <= k < 1 << 256:
        raise ValueError(f"naf_digits: scalar {k} outside [0, 2^256)")
    out = []
    while k:
        if k & 1:
            d = -1 if k & 3 == 3 else 1
            k -= d
        else:
            d = 0
        out.append(d)
        k >>= 1
    return out


def digit_block(k: int) -> np.ndarray:
    """csrc/scale.cu's ScaleDigits for `k`: the digit count (int32), then
    MAX_DIGITS signed bytes."""
    digits = naf_digits(k)
    buf = np.zeros(4 + MAX_DIGITS, dtype=np.uint8)
    buf[:4] = np.frombuffer(np.int32(len(digits)).tobytes(), np.uint8)
    buf[4:4 + len(digits)] = np.array(digits, dtype=np.int8).view(np.uint8)
    return buf


def g1_scale_plain(points: AffPoint, k: int) -> JacPoint:
    """Plain torch version of K19, any device: one plain doubling and, at
    a nonzero digit, one plain mixed add over every point a digit; the
    holes' outputs then set to (0, 0, 0)."""
    x, y = points
    zero = torch.zeros_like(x)
    digits = naf_digits(k)
    if not digits:
        return zero, zero, zero
    one = FQ.const("one", x.device).int().expand_as(x)
    neg_y = FQ.neg(y)
    acc = (x, y, one)
    for d in reversed(digits[:-1]):
        acc = point_op_plain("double", False, *acc)
        if d:
            acc = point_op_plain("add_mixed", False, *acc, x, y if d > 0 else neg_y)
    hole = ((x == 0) & (y == 0)).all(dim=-1, keepdim=True)
    return tuple(torch.where(hole, zero, c) for c in acc)


def g1_scale(points: AffPoint, k: int) -> JacPoint:
    """k * P_i for affine G1 points ((n, 16) int32 Montgomery limbs of x and
    y, (0, 0) = a hole) and one scalar 0 <= k < 2^256: Jacobian (X, Y, Z)
    limbs, (n, 16) each.  One launch of K19 for CUDA tensors; the plain
    version for CPU tensors."""
    x, y = points
    if x.dim() != 2 or x.shape[1] != NUM_LIMBS or y.shape != x.shape:
        raise ValueError(f"g1_scale: points {tuple(x.shape)} / {tuple(y.shape)}, expected (n, 16) each")
    block = digit_block(k)  # checks the scalar's range on every device
    if x.device.type == "cpu" and y.device.type == "cpu":
        return g1_scale_plain(points, k)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"g1_scale: points on {x.device} and {y.device}; K19 takes one CUDA device")
    x, y = (c if c.is_contiguous() else c.contiguous() for c in (x, y))
    check_cuda_operand(x, "g1_scale x")
    check_cuda_operand(y, "g1_scale y")
    out: Tuple[torch.Tensor, ...] = tuple(torch.empty_like(x) for _ in range(3))
    n = x.shape[0]
    if n:
        cuda_build.launch("scale", "zk_g1_scale", x.data_ptr(), y.data_ptr(), *(c.data_ptr() for c in out), n,
                          block.ctypes.data, field_consts(FQ).ctypes.data)
    return out
