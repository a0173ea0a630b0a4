"""Fixed-base batches k_i * G over G1 and G2 in one launch of kernel K17
(``csrc/fixed_base.cu``): the trusted setup's query points.

No Pallas counterpart: the reference's setup runs these in its native
C++ library (``csrc/zkp2p_native.cpp``, ``g1_fixed_base_batch_mont`` and
``g2_fixed_base_batch_mont``, an 8-bit comb of 32 windows x 255
multiples).  K17 runs an 8-bit comb of 32 windows with signed digits:
the scalar's bytes recoded to digits in [-127, 128] (K14's rule, the top
window absorbing the last carry since Fr < 2^254), one mixed addition
(``csrc/point.cuh``: the K3 formulas, over ``csrc/mont_cc.cuh``'s PTX
product) of the table entry 2^(8w) * |d| * G, y negated for a negative
digit, for each nonzero digit d, windows in order from the least
significant.  A block walks the windows in lockstep and stages each
window's rows in shared memory.

The table (``fixed_base_table``): the 32 x 128 affine multiples of the
base, (4096, 16) int32 Montgomery limbs per coordinate for G1 and
(4096, 2, 16) for G2, row w * 128 + |d| - 1; built once per base and
device with the host curve and kept on the device.

``fixed_base`` launches K17 for CUDA tensors and runs
``fixed_base_plain`` for CPU tensors; a tensor on any other device
raises.  Both give Jacobian points (Z = 0 for the scalar 0); the plain
version recodes with ``ops.msm.signed_digit_planes_from_limbs`` and adds
the same entries in the same order with the same complete add, so the
kernel equals it bit for bit.  ``ops.msm_affine.jac_to_affine_batch``
(K15) makes them the key's affine limbs, which are unique, so they equal
the reference's.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from ..curve.tcurve import JacPoint, g1_to_affine_arrays, g2_to_affine_arrays
from ..field.bn254 import P
from ..field.tfield import FQ
from ..field.tower import Fq2
from . import cuda_build
from .cuda_curve import point_op_plain
from .cuda_mont import NUM_LIMBS, check_cuda_operand, field_consts
from .msm import signed_digit_planes_from_limbs

WINDOWS = 32
WINDOW_BITS = 8
ROWS = 1 << (WINDOW_BITS - 1)  # 128 multiples a window: |d| = 1..128

_tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_lock = threading.Lock()


def _affine_adds(g2: bool, ps, qs):
    """p_i + q_i for affine host points with p_i != -q_i, neither at
    infinity: the lambdas' denominators inverted together (Montgomery's
    trick, one field inversion).  G1 coordinates are ints mod P, G2's
    Fq2 (reduced by its own operators)."""
    def red(v):
        return v if g2 else v % P

    dens, nums = [], []
    for (x1, y1), (x2, y2) in zip(ps, qs):
        if x1 == x2:  # p == q: the tangent
            nums.append(x1 * x1 * 3)
            dens.append(y1 + y1)
        else:
            nums.append(y2 - y1)
            dens.append(x2 - x1)
    prefix = [Fq2.one() if g2 else 1]
    for d in dens:
        prefix.append(red(prefix[-1] * d))
    acc = prefix[-1].inv() if g2 else pow(prefix[-1], P - 2, P)
    out = [None] * len(dens)
    for i in range(len(dens) - 1, -1, -1):
        dinv = red(prefix[i] * acc)
        acc = red(acc * dens[i])
        (x1, y1), (x2, _) = ps[i], qs[i]
        lam = red(nums[i] * dinv)
        x3 = red(lam * lam - x1 - x2)
        out[i] = (x3, red(lam * (x1 - x3) - y1))
    return out


def table_points(g2: bool, base):
    """The table's host points, row w * 128 + d - 1 = 2^(8w) * d * base:
    the 32 window bases by doublings, then the multiples of all windows
    a digit at a time (one batched inversion a digit)."""
    bases = [base]
    for _ in range(WINDOWS - 1):
        pw = bases[-1]
        for _ in range(WINDOW_BITS):
            pw = _affine_adds(g2, [pw], [pw])[0]
        bases.append(pw)
    cols = [bases]
    for _ in range(ROWS - 1):
        cols.append(_affine_adds(g2, cols[-1], bases))
    return [cols[d][w] for w in range(WINDOWS) for d in range(ROWS)]


def fixed_base_table(g2: bool, base, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The affine multiples table of `base` (a host G1 or G2 point) on
    `device`, built on first use and cached per (group, base, device)."""
    device = torch.device(device)
    key = (g2, base, str(device))
    with _lock:
        got = _tables.get(key)
        if got is None:
            arrays = g2_to_affine_arrays if g2 else g1_to_affine_arrays
            got = _tables[key] = arrays(table_points(g2, base), device)
        return got


def signed_windows(scalars: torch.Tensor):
    """The signed 8-bit digits of standard-form scalars (n, 16): (mags,
    negs), each (32, n), least significant window first; |d| in [0,
    128], negs where d < 0."""
    mags, negs = signed_digit_planes_from_limbs(scalars, WINDOW_BITS)
    return mags.flip(0), negs.flip(0)


def fixed_base_plain(g2: bool, table: Tuple[torch.Tensor, torch.Tensor], scalars: torch.Tensor) -> JacPoint:
    """Plain torch version of K17, any device: the same signed comb, one
    plain K3 step (``point_op_plain``) a window over every scalar, y
    negated as 0 - y for a negative digit, a zero digit adding the (0, 0)
    sentinel."""
    elem = (2, NUM_LIMBS) if g2 else (NUM_LIMBS,)
    n = scalars.shape[0]
    zero = torch.zeros((n,) + elem, dtype=torch.int32, device=scalars.device)
    acc = (zero, zero, zero)
    mags, negs = signed_windows(scalars)
    shape = (n,) + (1,) * len(elem)
    for w in range(WINDOWS):
        d = mags[w].long()
        if not bool(d.any()):
            continue
        idx = (w * ROWS + d - 1).clamp(min=0)
        live = (d > 0).reshape(shape)
        ax = torch.where(live, table[0].index_select(0, idx), zero)
        ty = table[1].index_select(0, idx)
        ay = torch.where(live, torch.where(negs[w].reshape(shape), FQ.neg(ty), ty), zero)
        acc = point_op_plain("add_mixed", g2, *acc, ax, ay)
    return acc


def _check(g2: bool, table, scalars: torch.Tensor) -> None:
    elem = (2, NUM_LIMBS) if g2 else (NUM_LIMBS,)
    if scalars.dim() != 2 or scalars.shape[1] != NUM_LIMBS:
        raise ValueError(f"fixed_base: scalars {tuple(scalars.shape)}, expected (n, 16) limbs")
    want = (WINDOWS * ROWS,) + elem
    if any(tuple(c.shape) != want for c in table):
        raise ValueError(f"fixed_base: table {[tuple(c.shape) for c in table]}, expected {want}")


def fixed_base(g2: bool, table: Tuple[torch.Tensor, torch.Tensor], scalars: torch.Tensor) -> JacPoint:
    """k_i * G for the standard-form scalars (n, 16) int32 16-bit limbs,
    canonical (< r), against the table of G (``fixed_base_table``):
    Jacobian (X, Y, Z) Montgomery limbs, (n, 16) over G1 or (n, 2, 16)
    over G2.  One launch of K17 for CUDA tensors; the plain version for
    CPU tensors."""
    _check(g2, table, scalars)
    devs = {t.device for t in (*table, scalars)}
    if all(d.type == "cpu" for d in devs):
        return fixed_base_plain(g2, table, scalars)
    if len(devs) != 1 or scalars.device.type != "cuda":
        raise ValueError(f"fixed_base: operands on {sorted(str(d) for d in devs)}; K17 takes one CUDA device")
    tx, ty = (c if c.is_contiguous() else c.contiguous() for c in table)
    k = scalars if scalars.is_contiguous() else scalars.contiguous()
    for t, name in ((tx, "table x"), (ty, "table y"), (k, "scalars")):
        check_cuda_operand(t, f"fixed_base {name}")
    n = k.shape[0]
    elem = (2, NUM_LIMBS) if g2 else (NUM_LIMBS,)
    out = tuple(torch.empty((n,) + elem, dtype=torch.int32, device=k.device) for _ in range(3))
    if n:
        cuda_build.launch("fixed_base", f"zk_{'g2' if g2 else 'g1'}_fixed_base", tx.data_ptr(), ty.data_ptr(),
                          k.data_ptr(), *(c.data_ptr() for c in out), n, field_consts(FQ).ctypes.data)
    return out
