"""Multi-scalar multiplication on limb tensors (port of the signed
windowed path of the reference's ``ops/msm.py``).

Signed base-2^w digit planes (most significant first) select from a
per-chunk multiples table [inf, 1P, ..., 2^(w-1)P]; a negative digit
takes the table entry with Y negated.  The base axis is consumed `lanes`
points per step, accumulating into an (n_digits, lanes) batch of
Jacobian partials; a Horner fold (acc = 2^w * acc + plane) then reduces
the planes and a pairwise tree the lanes.  The reference's `lax.scan`
over lane steps is, for G1 and G2 alike, two kernels a chunk of steps
(``_accumulate_chunked``: K6/K8 build the chunk's tables, K7/K9
accumulate them; ``ops.cuda_msm_window``), and its `lax.scan` over
planes one kernel a fold (``horner_fold_planes``: K10 for G1, K11 for
G2; ``ops.cuda_msm_fold``).  The step loops over point kernels
(``_accumulate_steps``, ``_fold_steps``) remain as the comparators that
the tests and ``chip_smoke.py`` hold the kernels against.  The planes
come from ``signed_digit_planes``: one launch of K14
(``ops.cuda_recode``) on a CUDA tensor, the Kogge-Stone recode
``signed_digit_planes_from_limbs`` (its comparator) on a CPU tensor."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..curve.tcurve import AffPoint, JacPoint, TCurve
from .cuda_msm_fold import g1_horner_fold, g2_horner_fold
from .cuda_msm_window import (chunk_steps, g1_window_accumulate, g1_window_table, g2_window_accumulate,
                               g2_window_table)
from .cuda_recode import signed_recode


def tree_reduce(curve: TCurve, pts: JacPoint, axis_len: int) -> JacPoint:
    """Sum `axis_len` points along the last batch axis by pairwise
    halving; an odd count pads one infinity (zero) lane."""
    n = axis_len
    ax = pts[0].dim() - 1 - len(curve.elem)
    while n > 1:
        if n % 2:
            pad = [0, 0] * len(curve.elem) + [0, 1]
            pts = tuple(F.pad(c, pad) for c in pts)
            n += 1
        lo = tuple(c.narrow(ax, 0, n // 2) for c in pts)
        hi = tuple(c.narrow(ax, n // 2, n // 2) for c in pts)
        pts = curve.add(lo, hi)
        n //= 2
    return tuple(c.squeeze(ax) for c in pts)


def horner_fold_planes(curve: TCurve, init: JacPoint, planes_stacked: JacPoint, window: int) -> JacPoint:
    """MSB-first Horner fold over stacked plane partials (leading axis =
    planes): acc = 2^window * acc + plane, in one kernel (K10 for G1, K11
    for G2)."""
    fold = g2_horner_fold if curve.g2 else g1_horner_fold
    return fold(init, planes_stacked, window)


def _fold_steps(curve: TCurve, init: JacPoint, planes_stacked: JacPoint, window: int) -> JacPoint:
    """horner_fold_planes one point kernel a step (K4 doublings, K2 adds):
    the same result, bit for bit."""
    acc = init
    for p in range(planes_stacked[0].shape[0]):
        for _ in range(window):
            acc = curve.double(acc)
        acc = curve.add(acc, tuple(c[p] for c in planes_stacked))
    return acc


def digit_planes_from_limbs(limbs: torch.Tensor, window: int = 4) -> torch.Tensor:
    """Standard-form scalar limbs (..., n, 16) -> (256/window, ..., n)
    base-2^window digit planes, most significant first (int32)."""
    assert 16 % window == 0
    per_limb = 16 // window
    shifts = torch.arange(per_limb, dtype=torch.int32, device=limbs.device) * window
    digits = (limbs.int().unsqueeze(-1) >> shifts) & ((1 << window) - 1)
    flat = digits.reshape(*limbs.shape[:-1], 16 * per_limb).flip(-1)
    return flat.movedim(-1, 0)


def signed_digit_planes_from_limbs(limbs: torch.Tensor, window: int = 4):
    """Standard-form scalar limbs (..., n, 16) -> (mags, negs), signed
    base-2^window digits most significant first: mags
    (256/window, ..., n) int32 in [0, 2^(window-1)], negs a bool mask of
    negated digits.

    Recoding (LSB first): a digit d + carry above 2^(w-1) becomes
    d + carry - 2^w and carries one into the next digit.  The carries
    resolve by a Kogge-Stone pass over the digit axis (generate
    d > half, propagate d == half).  The top digit absorbs the last carry
    because Fr scalars are < 2^254."""
    assert 16 % window == 0
    n_digits = 256 // window
    half = 1 << (window - 1)
    full = 1 << window
    d = digit_planes_from_limbs(limbs, window).flip(0)  # LSB first
    gg = d > half
    pp = d == half
    k = 1
    while k < n_digits:
        gg = gg | (pp & F.pad(gg, [0, 0] * (gg.dim() - 1) + [k, 0])[:n_digits])
        pp = pp & F.pad(pp, [0, 0] * (pp.dim() - 1) + [k, 0])[:n_digits]
        k *= 2
    carry_in = F.pad(gg, [0, 0] * (gg.dim() - 1) + [1, 0])[:n_digits]
    e = d + carry_in.int()
    neg = e > half
    mag = torch.where(neg, full - e, e)
    return mag.flip(0), neg.flip(0)


def signed_digit_planes(limbs: torch.Tensor, window: int = 4):
    """signed_digit_planes_from_limbs in one launch of K14
    (``ops.cuda_recode``) for a CUDA tensor; the Kogge-Stone pass above
    for a CPU tensor.  The same (mags, negs), in the same layout."""
    if limbs.device.type == "cpu":
        return signed_digit_planes_from_limbs(limbs, window)
    if limbs.device.type != "cuda":
        raise ValueError(f"signed_digit_planes: limbs on {limbs.device}")
    return signed_recode(limbs, window)


def default_lanes(n: int, cap: int = 4096) -> int:
    """Lane width for an n-point MSM: wide steps, but at least 16 steps
    to amortise the per-step multiples table."""
    return max(64, min(cap, n // 16))


def _accumulate_steps(curve: TCurve, pts: AffPoint, planes: torch.Tensor, neg_t: torch.Tensor,
                      window: int) -> JacPoint:
    """The (n_digits, lanes) partials, one lane step at a time: the step's
    multiples table by from_affine and chained add_mixed (K3), its signed
    entries gathered, one add (K2).  pts (steps, lanes, *elem) x2, planes
    and neg_t (n_digits, steps, lanes)."""
    n_digits, steps, lanes = planes.shape
    n_table = 1 << (window - 1)  # signed digits reach 2^(w-1)
    lane_ix = torch.arange(lanes, device=planes.device)[None, :]
    acc = curve.infinity((n_digits, lanes), planes.device)
    for s in range(steps):
        pt = (pts[0][s], pts[1][s])
        entry = curve.from_affine(pt)
        table = [entry]
        for _ in range(n_table - 1):
            entry = curve.add_mixed(entry, pt)
            table.append(entry)
        # rows 0..n_table: infinity (Z = 0), 1P .. n_table*P; rows
        # n_table+1.. repeat them with Y negated (F.neg keeps -0 = 0, so
        # the infinity row stays (0, 0, 0))
        inf = torch.zeros_like(pt[0])
        rows = [(inf, inf, inf)] + table
        signed = tuple(torch.stack([r[i] for r in rows] * 2) for i in range(3))
        signed[1][n_table + 1:] = curve.F.neg(signed[1][n_table + 1:])
        idx = planes[:, s].long() + neg_t[:, s].long() * (n_table + 1)
        acc = curve.add(acc, tuple(c[idx, lane_ix] for c in signed))
    return acc


def _accumulate_chunked(curve: TCurve, pts: AffPoint, planes: torch.Tensor, neg_t: torch.Tensor,
                        window: int) -> JacPoint:
    """_accumulate_steps in chunks of steps: one table launch (K6 for G1,
    K8 for G2) builds a chunk's tables, one accumulate launch (K7, K9)
    adds them into the partials.  The same partials, bit for bit."""
    n_digits, steps, lanes = planes.shape
    n_table = 1 << (window - 1)
    table_of, accumulate = ((g2_window_table, g2_window_accumulate) if curve.g2
                            else (g1_window_table, g1_window_accumulate))
    chunk = chunk_steps(lanes, n_table, math.prod(curve.elem))
    acc = curve.infinity((n_digits, lanes), planes.device)
    for s0 in range(0, steps, chunk):
        table = table_of((pts[0][s0:s0 + chunk], pts[1][s0:s0 + chunk]), n_table)
        acc = accumulate(acc, table, planes, neg_t, s0)
    return acc


def _lane_partials(curve: TCurve, bases: AffPoint, mags: torch.Tensor, negs: torch.Tensor, lanes: int,
                   window: int, accumulate) -> JacPoint:
    """The (n_digits, lanes) partials of an MSM: the bases padded with
    (0, 0) to whole lane steps, accumulated by `accumulate`."""
    n_digits = mags.shape[0]
    n = bases[0].shape[0]
    device = bases[0].device
    lanes = min(lanes, n)
    pad = (-n) % lanes
    elem_pad = [0, 0] * len(curve.elem)
    if pad:
        bases = tuple(F.pad(c, elem_pad + [0, pad]) for c in bases)
        mags = F.pad(mags, [0, pad])
        negs = F.pad(negs, [0, pad])
    steps = (n + pad) // lanes
    pts = tuple(c.reshape((steps, lanes) + curve.elem) for c in bases)
    return accumulate(curve, pts, mags.reshape(n_digits, steps, lanes), negs.reshape(n_digits, steps, lanes), window)


def _windowed(curve: TCurve, bases: AffPoint, mags: torch.Tensor, negs: torch.Tensor, lanes: int, window: int,
              accumulate) -> JacPoint:
    acc = _lane_partials(curve, bases, mags, negs, lanes, window, accumulate)
    lanes = acc[0].shape[1]
    per_lane = horner_fold_planes(curve, curve.infinity((lanes,), bases[0].device), acc, window)
    return tree_reduce(curve, per_lane, lanes)


def msm_windowed_signed(
    curve: TCurve,
    bases: AffPoint,
    mags: torch.Tensor,
    negs: torch.Tensor,
    lanes: int = 64,
    window: int = 4,
) -> JacPoint:
    """sum_i k_i * P_i for affine bases ((0, 0) = infinity) and signed
    digit planes (mags, negs) of shape (n_digits, n): one Jacobian point.
    G1 and G2 accumulate a chunk of steps a kernel pair (K6/K7, K8/K9)
    and fold the planes in one kernel (K10, K11).  The lanes fold by the pairwise tree, for G1 and G2 alike (the
    reference's fold_lanes_per_curve takes the tree whenever its point
    kernels are in use)."""
    return _windowed(curve, bases, mags, negs, lanes, window, _accumulate_chunked)
