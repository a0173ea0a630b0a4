"""The lane tree of a windowed MSM, the sum of the lane partials by
pairwise halving, in one launch of kernel K18 a tree (``csrc/lane_tree.cu``:
``zk_g1_lane_tree`` over Fq, ``zk_g2_lane_tree`` over Fq2), every witness
of a batch in the same launch.

Replaces the reference's ``tree_reduce`` (``ops/msm.py``), one Pallas
``g1_add`` / ``g2_add`` (``ops/pallas_curve.py``) a level.  A level of n
points, padded with one infinity at its end when n is odd, becomes the
ceil(n/2) sums ``lo[i] + hi[i]``; the kernel keeps that pairing and
point.cuh's complete add, so its Jacobian limbs equal the loop's.

``lane_tree`` launches K18 for CUDA tensors and runs ``lane_tree_plain``
for CPU tensors; a tensor on any other device raises.  The plain version
is the level loop (``tree_steps``) over ``point_op_plain("add")`` and
runs on any device; ``ops.msm.tree_reduce_steps`` is the same loop over
the curve's add (K2 a level on the card), the comparator the tests and
``chip_smoke.py`` hold K18 against.

Layouts (int32 limbs, Montgomery form; an element is ``(16,)`` for G1 and
``(2, 16)`` for G2): points ``(*batch, lanes, *elem)`` per coordinate,
the sum ``(*batch, *elem)``.

``tree_plan`` is the launch's plan: a tree of at most ``CAP`` lanes runs
in one block a witness; a larger one runs its first ``levels_a`` levels
in ``blocks`` blocks a witness of ``per_block`` outputs each into a
scratch buffer of ``n_a`` points a witness, and its last ``levels_b`` in
the witness's last block (``csrc/lane_tree.cu`` says how).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..field.tfield import FQ
from . import cuda_build
from .cuda_curve import point_op_plain
from .cuda_mont import field_consts
from .cuda_msm_window import Coords, _device_of, _elem, _limbs

# points in a block's shared memory (csrc/lane_tree.cu: LT_CAP)
CAP = 256


class TreePlan(NamedTuple):
    levels_a: int  # levels of stage A (the whole tree when levels_b < 0)
    per_block: int  # stage A's outputs a block
    blocks: int  # stage A's blocks a witness
    n_a: int  # stage A's outputs a witness: the scratch buffer's points
    levels_b: int  # levels of stage B, -1 for a one-stage tree


def levels_of(n: int) -> int:
    """Levels of a tree of n lanes: ceil(log2 n), 0 for one lane."""
    return (n - 1).bit_length()


def tree_plan(lanes: int) -> TreePlan:
    if lanes < 1:
        raise ValueError(f"lane_tree: {lanes} lanes")
    if lanes <= CAP:
        return TreePlan(levels_of(lanes), 1, 1, 1, -1)
    levels_a = levels_of(-(-lanes // CAP))  # the fewest levels that leave at most CAP points
    if (1 << levels_a) > CAP:
        raise ValueError(f"lane_tree: {lanes} lanes, above the {CAP * CAP} that two stages take")
    per_block = CAP >> levels_a
    n_a = -(-lanes >> levels_a)
    return TreePlan(levels_a, per_block, -(-n_a // per_block), n_a, levels_of(n_a))


# ----------------------------------------------------------- plain version


def tree_steps(add, pts: Coords, n: int, elem_dims: int) -> Coords:
    """Sum n points along the last batch axis (the axis before the
    element's `elem_dims`) by pairwise halving, one add(lo, hi) a level;
    an odd level pads one infinity (zero) lane at its end."""
    ax = pts[0].dim() - 1 - elem_dims
    while n > 1:
        if n % 2:
            pad = [0, 0] * elem_dims + [0, 1]
            pts = tuple(F.pad(c, pad) for c in pts)
            n += 1
        lo = tuple(c.narrow(ax, 0, n // 2) for c in pts)
        hi = tuple(c.narrow(ax, n // 2, n // 2) for c in pts)
        pts = add(lo, hi)
        n //= 2
    return tuple(c.squeeze(ax) for c in pts)


def lane_tree_plain(g2: bool, pts: Coords) -> Coords:
    """Plain torch version of K18, any device."""
    nd = len(_elem(g2))
    n = pts[0].shape[-1 - nd]
    return tree_steps(lambda p, q: point_op_plain("add", g2, *p, *q), tuple(pts), n, nd)


# ------------------------------------------------------------------ wrapper


def lane_tree(g2: bool, pts: Coords) -> Coords:
    """The sum of points (*batch, lanes, *elem) x3 over the lanes axis:
    (*batch, *elem) x3.  One launch of K18 for CUDA tensors; the plain
    version for CPU tensors."""
    name = f"{'g2' if g2 else 'g1'}_lane_tree"
    dev = _device_of(name, pts)
    if dev.type == "cpu":
        return lane_tree_plain(g2, pts)
    elem = _elem(g2)
    shape = tuple(pts[0].shape)
    if len(shape) < 1 + len(elem) or shape[-len(elem):] != elem:
        raise ValueError(f"{name}: points {shape}, expected (*batch, lanes, {', '.join(map(str, elem))})")
    batch, lanes = shape[:-1 - len(elem)], shape[-1 - len(elem)]
    ins = [_limbs(c, shape, f"{name} points") for c in pts]
    out = tuple(torch.empty(batch + elem, dtype=torch.int32, device=dev) for _ in range(3))
    b = math.prod(batch)
    if not b:
        return out
    plan = tree_plan(lanes)
    if plan.levels_b < 0:
        scratch, counters = (None, None, None), None
    else:
        scratch = tuple(torch.empty((b, plan.n_a) + elem, dtype=torch.int32, device=dev) for _ in range(3))
        counters = torch.zeros(b, dtype=torch.int32, device=dev)
    cuda_build.launch(
        "lane_tree", "zk_" + name,
        *(c.data_ptr() for c in ins), *(None if s is None else s.data_ptr() for s in scratch),
        None if counters is None else counters.data_ptr(), *(o.data_ptr() for o in out),
        b, lanes, plan.levels_a, plan.per_block, plan.blocks, plan.levels_b, field_consts(FQ).ctypes.data,
    )
    return out
