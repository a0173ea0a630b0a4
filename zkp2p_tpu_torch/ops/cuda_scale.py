"""n affine G1 points scaled by one shared scalar in one launch of kernel
K19 (``csrc/scale.cu``): the phase-2 ceremony's rescale of the C and H
queries by 1/delta' (``snark/ceremony.py``).

No Pallas counterpart: the reference runs it in its native C++ library
(``csrc/zkp2p_native.cpp``, ``g1_scale_batch``), else one host ``g1_mul``
a point; both compute k * P by the group law through P over the whole k.
K19 computes the same function by two ladders, chosen a point by the
curve test y^2 = x^3 + 3 (in Montgomery form):

- on the curve, the GLV ladder: k mod r = k1 + k2 * lambda
  (``field.bn254.glv_decompose``), k * P = k1 * P + k2 * phi(P) with
  phi(x, y) = (beta * x, y): one doubling a digit position of the two
  half-scalars' width-2 NAFs and a mixed add of (x, +-y) or
  (beta * x, +-y) at each nonzero digit (``glv_ops``);
- off the curve, the full-scalar NAF ladder over k itself (``naf_ops``,
  over ``naf_digits``, the native rule), which is k * P on the curve that
  the point does lie on, as the reference computes it.

Both ladders are streams of ops computed here once a launch: 0 a
doubling, +-1 a mixed add of (x, +-y), +-2 of (beta * x, +-y), from the
point at infinity.  A (0, 0) hole, or k = 0, gives (0, 0, 0).

``g1_scale`` launches K19 for CUDA tensors and runs ``g1_scale_plain``
for CPU tensors; a tensor on any other device raises.  Both give Jacobian
points; the plain version runs the same test, streams and formulas
(``ops.cuda_curve.point_op_plain``: the K4 doubling, the K3 mixed add),
so the kernel equals it bit for bit.  ``ops.msm_affine.jac_to_affine_batch``
(K15) makes them affine limbs, which are unique, so they equal the
reference's.  ``digit_block`` is the NAF digits' block of the comparator
entry that ``csrc/scale.cu`` keeps beside the kernel.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..curve.tcurve import AffPoint, JacPoint
from ..field.bn254 import GLV_BETA, glv_decompose
from ..field.tfield import FQ
from . import cuda_build
from .cuda_curve import point_op_plain
from .cuda_mont import NUM_LIMBS, add_mod, check_cuda_operand, field_consts, mont_mul_plain64

MAX_DIGITS = 264  # csrc/scale.cu's SCALE_MAX_DIGITS; a 256-bit scalar has at most 257
MAX_OPS = 768  # csrc/scale.cu's SCALE_MAX_OPS: a GLV stream has at most ~260, a NAF stream 385


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


def naf_ops(k: int) -> List[int]:
    """The full-scalar ladder's ops for 0 <= k < 2^256: the top digit's add
    of P, then a doubling a lower digit and the digit's add of +-P."""
    ops = []
    for d in reversed(naf_digits(k)):
        if ops:
            ops.append(0)
        if d:
            ops.append(d)
    return ops


def glv_ops(k: int) -> List[int]:
    """The GLV ladder's ops for k mod r = k1 + k2 * lambda: over the digit
    positions of the signed half-scalars' NAFs from the top, a doubling
    (none at the top), then +-1 at a nonzero k1 digit and +-2 at a nonzero
    k2 digit (the signs of k1 and k2 folded into the digits)."""
    halves = []
    for h in glv_decompose(k):
        sign = -1 if h < 0 else 1
        halves.append([sign * d for d in naf_digits(abs(h))])
    top = max(len(d) for d in halves)
    ops = []
    for b in reversed(range(top)):
        if b < top - 1:
            ops.append(0)
        for scale, digits in zip((1, 2), halves):
            if b < len(digits) and digits[b]:
                ops.append(scale * digits[b])
    return ops


def op_block(k: int) -> np.ndarray:
    """csrc/scale.cu's ScaleOps for `k`: beta in Montgomery form (8 words),
    the GLV stream's and the NAF stream's lengths (int32 each), then
    MAX_OPS signed bytes, the GLV stream followed by the NAF stream."""
    naf = naf_ops(k)  # checks the scalar's range
    glv = glv_ops(k)
    buf = np.zeros(32 + 8 + MAX_OPS, dtype=np.uint8)
    buf[:32] = np.frombuffer(((GLV_BETA << 256) % FQ.modulus).to_bytes(32, "little"), np.uint8)
    buf[32:40] = np.array([len(glv), len(naf)], dtype=np.int32).view(np.uint8)
    buf[40:40 + len(glv) + len(naf)] = np.array(glv + naf, dtype=np.int8).view(np.uint8)
    return buf


def _ladder_plain(x: torch.Tensor, y: torch.Tensor, phix: torch.Tensor, ops: List[int]) -> JacPoint:
    """One op stream over every point from the point at infinity, with
    point_op_plain's doubling and mixed add (whose selects put (x2, y2, 1)
    for the infinity, as the kernel's add does)."""
    zero = torch.zeros_like(x)
    neg_y = FQ.neg(y)
    acc = (zero, zero, zero)
    for op in ops:
        if op == 0:
            acc = point_op_plain("double", False, *acc)
        else:
            acc = point_op_plain("add_mixed", False, *acc, x if op & 1 else phix, y if op > 0 else neg_y)
    return acc


def g1_scale_plain(points: AffPoint, k: int) -> JacPoint:
    """Plain torch version of K19, any device: the curve test, the GLV
    stream over the points on the curve and the NAF stream over the rest,
    with the kernel's formulas; the holes' outputs (0, 0, 0)."""
    x, y = points
    zero = torch.zeros_like(x)
    n, nprime, negn, one = (FQ.const(c, x.device) for c in ("n", "nprime", "negn", "one"))

    def mul(a, b):
        return mont_mul_plain64(a.long(), b.long(), n, nprime, negn)

    three = add_mod(add_mod(one, one, negn), one, negn)
    rhs = add_mod(mul(mul(x, x), x), three.expand(x.shape), negn)
    on = (mul(y, y) == rhs).all(dim=-1)
    hole = ((x == 0) & (y == 0)).all(dim=-1)
    beta = torch.tensor(FQ.to_mont_host(GLV_BETA), dtype=torch.int64, device=x.device)
    phix = mul(beta.expand(x.shape), x).int()
    out = [zero.clone() for _ in range(3)]
    for sel, ops in ((on, glv_ops(k)), (~on & ~hole, naf_ops(k))):
        idx = sel.nonzero().flatten()
        if ops and idx.numel():
            for o, c in zip(out, _ladder_plain(x[idx], y[idx], phix[idx], ops)):
                o[idx] = c
    return tuple(out)


def g1_scale(points: AffPoint, k: int) -> JacPoint:
    """k * P_i for affine G1 points ((n, 16) int32 Montgomery limbs of x and
    y, (0, 0) = a hole) and one scalar 0 <= k < 2^256: Jacobian (X, Y, Z)
    limbs, (n, 16) each.  One launch of K19 for CUDA tensors; the plain
    version for CPU tensors."""
    x, y = points
    if x.dim() != 2 or x.shape[1] != NUM_LIMBS or y.shape != x.shape:
        raise ValueError(f"g1_scale: points {tuple(x.shape)} / {tuple(y.shape)}, expected (n, 16) each")
    block = op_block(k)  # checks the scalar's range on every device
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
