"""Batch-affine windowed MSM: the accumulate tier in affine coordinates
(port of the reference's ``ops/msm_affine.py``).

An affine + affine add costs 4 field products plus a share of one batched
inversion, against 16 for the Jacobian add of ``ops.msm``.  The
accumulators live in affine (x, y, is_inf), and every (digit, lane)
denominator of a step is inverted together.

On CUDA each of these is a kernel (``ops.cuda_affine``): a chunk of lane
steps' multiples tables is built by K6 (G1) or K8 (G2) in Jacobian and
normalised to affine by one K15 launch (``jac_to_affine_batch``); the
chunk's steps then run in one K16 accumulate launch
(``affine_accumulate``), each step one block-local batch inversion and
one apply inside the kernel.  ``batch_inverse`` and
``affine_add_complete`` are K15 and K16 too.  Each block of those kernels
inverts its own elements' values; the inverse of a nonzero element is
unique, so the outputs equal the plain route's, which inverts the whole
batch with one inversion.

The plain route, which CPU tensors take and the kernels are held
against, is the reference's: exclusive prefix and suffix products by
reshape-halving, one Fermat inversion of the total
(``TPrimeField.inv_fused``), then the two phases of the complete add
(``_affine_add_den``, ``_affine_add_apply``) with branch-free selects for
the exceptional lanes (accumulator at infinity, addend at infinity,
equal-x doubling, P + (-P)).  On a CUDA tensor it runs its products on
K1 and its inversion on K5: ``_batch_inverse_steps``,
``_jac_to_affine_steps``, ``_affine_add_steps`` and ``_affine_steps``
(the step loop with K3 tables) are the old routes, kept as the
comparators.  ``plain_ops`` gives a field whose products and inversion
are plain torch on any device, for holding the kernels against plain
versions on the card; ``batch_inverse_blocked`` groups the elements as
the kernels do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F_

from ..curve.tcurve import AffPoint, JacPoint, TCurve
from ..field.tfield import TFq2Ops
from . import cuda_affine
from .cuda_mont import mont_mul_plain, mont_pow_plain
from .cuda_msm_window import chunk_steps, g1_window_table, g2_window_table
from .msm import horner_fold_planes, tree_reduce


class _PlainField:
    """A prime field whose products and Fermat inversion are the plain
    torch versions of K1 and K5 on any device; the rest is the field's."""

    def __init__(self, F):
        self._F = F

    def __getattr__(self, name):
        return getattr(self._F, name)

    def mul(self, a, b):
        return mont_mul_plain(self._F, a, b)

    def square(self, a):
        return self.mul(a, a)

    def inv_fused(self, a):
        return mont_pow_plain(self._F, a, self._F.modulus - 2)


def plain_ops(F):
    """F (a prime field or Fq2) with plain torch products on any device."""
    fq = getattr(F, "fq", None)
    return TFq2Ops(_PlainField(fq)) if fq is not None else _PlainField(F)


def _is_fq2(F) -> bool:
    return getattr(F, "fq", None) is not None


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def excl_prefix_mul(F, x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix products along axis 0 (power-of-2 length),
    seeded: out[i] = seed * x[0] * ... * x[i-1].

    Reshape-halving: each level pairs adjacent elements, recurses on the
    n/2 pair products, then fills the odd positions with one more
    product -- 2n products in all, log depth."""
    n = x.shape[0]
    assert n & (n - 1) == 0, "excl_prefix_mul needs a power-of-2 length"
    if n == 1:
        return seed.expand_as(x)
    evens = x[0::2]
    pp = excl_prefix_mul(F, F.mul(evens, x[1::2]), seed)
    odd = F.mul(pp, evens)
    return torch.stack((pp, odd), dim=1).reshape(x.shape)


def _batch_inverse_steps(F, x: torch.Tensor) -> torch.Tensor:
    """Invert every element of x (axis 0 = batch) with ONE field
    inversion: inv(x_i) = prefix_excl_i * (total^-1 * suffix_excl_i); the
    suffix sweep is seeded with total^-1.  Products by F.mul (K1 on a
    CUDA tensor), the inversion by F.inv_fused (K5).

    Fq2 (F has a .fq base field) takes the norm route:
    inv(a + bu) = (a - bu) * (a^2 + b^2)^-1, one Fq batch inversion of
    the norms.  A count that is not a power of 2 (the 3-plane narrow
    class) pads with ones.

    Zero elements are mapped to 1 inside the products so they cannot zero
    the total; their output slots are garbage, and callers select around
    them."""
    fq = getattr(F, "fq", None)
    if fq is not None:
        a, b = x[..., 0, :], x[..., 1, :]
        norm = fq.add(fq.square(a), fq.square(b))
        ninv = _batch_inverse_steps(fq, norm)
        return torch.stack([fq.mul(a, ninv), fq.neg(fq.mul(b, ninv))], dim=-2)
    n = x.shape[0]
    if n & (n - 1):
        pad = (1 << n.bit_length()) - n
        ones = F.one_like(x[:1]).expand((pad,) + tuple(x.shape[1:]))
        return _batch_inverse_steps(F, torch.cat([x, ones]))[:n]
    safe = F.select(F.is_zero(x), F.one_like(x), x)
    one = F.const("one", x.device).int()
    pe = excl_prefix_mul(F, safe, one)
    total = F.mul(pe[-1], safe[-1])
    tinv = F.inv_fused(total)
    sfx = torch.flip(excl_prefix_mul(F, torch.flip(safe, [0]), tinv), [0])
    return F.mul(pe, sfx)


def batch_inverse(F, x: torch.Tensor) -> torch.Tensor:
    """Invert every element of x, Fq or Fr (..., 16) or Fq2 (..., 2, 16):
    one launch of K15 on a CUDA tensor (zero -> 0), ``_batch_inverse_steps``
    on a CPU tensor (zero slots garbage).  Nonzero slots are equal."""
    if _on_cpu(x):
        return _batch_inverse_steps(F, x)
    return cuda_affine.batch_inverse(F.fq if _is_fq2(F) else F, x, 2 if _is_fq2(F) else 1)


def batch_inverse_blocked(F, x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """The kernels' grouping in plain torch, any device: the flattened
    elements in consecutive groups of `block` (K15's and the G1 K16 add's
    1,024; the G2 add's 512; the accumulates' 256 and 128), each padded
    with ones to a power of 2, a product tree a group, one
    Fermat inversion of each root, the inverses back down the tree
    (inv(left) = inv(parent) * right).  Zero -> 0; Fq2 by the norm route."""
    assert block > 0, "block must be positive"
    P = plain_ops(F)
    fq = getattr(P, "fq", None)
    if fq is not None:
        a, b = x[..., 0, :], x[..., 1, :]
        ninv = batch_inverse_blocked(F.fq, fq.add(fq.square(a), fq.square(b)), block)
        return torch.stack([fq.mul(a, ninv), fq.neg(fq.mul(b, ninv))], dim=-2)
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    groups = -(-n // block)
    zero = P.is_zero(flat)
    safe = P.select(zero, P.one_like(flat), flat)
    safe = torch.cat([safe, P.one_like(safe[:1]).expand(groups * block - n, -1)])
    width = 1 << (block - 1).bit_length()
    level = safe.reshape(groups, block, -1)
    level = torch.cat([level, P.one_like(level[:, :1]).expand(-1, width - block, -1)], dim=1)
    levels = []
    while level.shape[1] > 1:
        levels.append(level)
        level = P.mul(level[:, 0::2], level[:, 1::2])
    inv = P.inv_fused(level)
    for lv in reversed(levels):
        inv = torch.stack([P.mul(inv, lv[:, 1::2]), P.mul(inv, lv[:, 0::2])], dim=2).reshape(lv.shape)
    out = inv[:, :block].reshape(groups * block, -1)[:n]
    return torch.where(zero[:, None], torch.zeros_like(out), out).reshape(x.shape)


def _jac_to_affine_steps(F, pts: JacPoint) -> AffPoint:
    """Jacobian (X, Y, Z), any batch shape -> affine (X/Z^2, Y/Z^3);
    infinity (Z = 0) -> the (0, 0) sentinel.  One ``_batch_inverse_steps``
    over the flattened batch, the rest by F.mul."""
    X, Y, Z = pts
    elem = F.elem
    inf = F.is_zero(Z)
    zinv = _batch_inverse_steps(F, Z.reshape((-1,) + elem)).reshape(Z.shape)
    zi2 = F.square(zinv)
    x = F.mul(X, zi2)
    y = F.mul(Y, F.mul(zi2, zinv))
    zero = torch.zeros_like(x)
    return F.select(inf, zero, x), F.select(inf, zero, y)


def jac_to_affine_batch(F, pts: JacPoint) -> AffPoint:
    """Jacobian -> affine with (0, 0) at infinity, any batch shape: one
    launch of K15 on CUDA tensors, ``_jac_to_affine_steps`` on CPU ones."""
    if _on_cpu(*pts):
        return _jac_to_affine_steps(F, pts)
    return cuda_affine.jac_to_affine(pts, 2 if _is_fq2(F) else 1)


def _affine_add_den(F, a, b) -> tuple:
    """Phase 1 of the complete affine add: the denominator every lane
    gives the batch inversion, and the case flags.  a, b are
    (x, y, is_inf) triples; exceptional lanes get denominator 1 so the
    batch product stays invertible."""
    ax, ay, ainf = a
    bx, by, binf = b
    live = ~ainf & ~binf
    x_eq = F.eq(ax, bx)
    y_eq = F.eq(ay, by)
    dbl = x_eq & y_eq & live
    # P + (-P), and doubling a 2-torsion point (y = 0): both -> infinity
    res_inf = (x_eq & ~y_eq & live) | (dbl & F.is_zero(ay))
    den = F.select(dbl, F.add(ay, ay), F.sub(bx, ax))
    den = F.select(res_inf | ~live, F.one_like(den), den)
    return den, (dbl, res_inf)


def _affine_add_apply(F, a, b, dinv: torch.Tensor, flags) -> tuple:
    """Phase 2: complete the add with the batch-inverted denominators
    (4 products a lane: x1^2, lambda, lambda^2, y3)."""
    ax, ay, ainf = a
    bx, by, binf = b
    dbl, res_inf = flags
    axsq = F.square(ax)
    num = F.select(dbl, F.add(F.add(axsq, axsq), axsq), F.sub(by, ay))
    lam = F.mul(num, dinv)
    x3 = F.sub(F.sub(F.square(lam), ax), bx)
    y3 = F.sub(F.mul(lam, F.sub(ax, x3)), ay)
    zero = torch.zeros_like(ax)
    rx = F.select(res_inf, zero, x3)
    ry = F.select(res_inf, zero, y3)
    rinf = res_inf
    # addend at infinity -> keep the accumulator; accumulator at infinity
    # -> take the addend (second, so a double-infinity lane stays at
    # infinity with (0, 0) coordinates)
    rx = F.select(binf, ax, rx)
    ry = F.select(binf, ay, ry)
    rinf = torch.where(binf, ainf, rinf)
    rx = F.select(ainf, bx, rx)
    ry = F.select(ainf, by, ry)
    rinf = torch.where(ainf, binf, rinf)
    return rx, ry, rinf


def _affine_add_steps(F, a, b):
    """Complete affine add of two (x, y, is_inf) triples with any leading
    batch shape: the phase-1 denominators are batch-inverted over the
    whole flattened batch by ``_batch_inverse_steps``, then phase 2
    completes."""
    elem = F.elem
    den, flags = _affine_add_den(F, a, b)
    bshape = den.shape[: den.dim() - len(elem)]
    d = den.reshape((math.prod(bshape),) + elem)
    dinv = _batch_inverse_steps(F, d).reshape(den.shape)
    return _affine_add_apply(F, a, b, dinv, flags)


def affine_add_complete(F, a, b):
    """Complete affine add of two (x, y, is_inf) triples with any batch
    shape: one launch of K16 (G1 over Fq, G2 over Fq2) on CUDA tensors,
    ``_affine_add_steps`` on CPU ones.  On CUDA the operands may be views
    with any stride on their first axis (see ``cuda_affine.affine_add``)."""
    if _on_cpu(*a, *b):
        return _affine_add_steps(F, a, b)
    return cuda_affine.affine_add(_is_fq2(F), a, b)


def _signed_entries(F, tx, ty, digits, neg, lane_ix):
    """The affine table entries the digits select, Y negated for negative
    digits (F.neg: -0 = 0), digit 0 at infinity (0, 0): tx, ty (n_table,
    lanes, *elem), digits and neg (n_digits, lanes)."""
    zero = digits == 0
    idx = (digits - 1).clamp(min=0)
    z = torch.zeros((), dtype=tx.dtype, device=tx.device)
    sx = F.select(zero, z, tx[idx, lane_ix])
    sy = F.select(zero, z, ty[idx, lane_ix])
    sy = F.select(neg, F.neg(sy), sy)
    return sx, sy, F.is_zero(sx) & F.is_zero(sy)


def _affine_accumulate_steps(F, acc, table, mags: torch.Tensor, negs: torch.Tensor, s0: int):
    """Plain version of the K16 accumulate: for each step t of the affine
    table (T, n_table, lanes, *elem) x2, the signed entries of the digit
    planes (n_digits, steps, lanes) at step s0 + t added into the affine
    partials acc (n_digits, lanes) by ``_affine_add_steps``."""
    tx, ty = table
    lane_ix = torch.arange(mags.shape[-1], device=mags.device)[None, :]
    for t in range(tx.shape[0]):
        addend = _signed_entries(F, tx[t], ty[t], mags[:, s0 + t].long(), negs[:, s0 + t], lane_ix)
        acc = _affine_add_steps(F, acc, addend)
    return acc


def affine_accumulate(curve: TCurve, acc, table, mags: torch.Tensor, negs: torch.Tensor, s0: int):
    """acc (n_digits, lanes) affine partials plus the chunk's T steps of the
    affine table (T, n_table, lanes, *elem) x2, digits read from the planes
    (n_digits, steps, lanes) at steps s0 .. s0+T-1: one launch of K16 on
    CUDA tensors, ``_affine_accumulate_steps`` on CPU ones."""
    if _on_cpu(*acc, *table, mags, negs):
        return _affine_accumulate_steps(curve.F, acc, table, mags, negs, s0)
    return cuda_affine.affine_accumulate(curve.g2, acc, table, mags, negs, s0)


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def _affine_infinity(curve: TCurve, shape, device):
    zero = torch.zeros(tuple(shape) + curve.elem, dtype=torch.int32, device=device)
    return zero, zero, torch.ones(tuple(shape), dtype=torch.bool, device=device)


def _affine_steps(curve: TCurve, pts: AffPoint, planes: torch.Tensor, neg_t: torch.Tensor, window: int):
    """The old route of the affine partials, one lane step at a time: the
    step's multiples by from_affine and chained add_mixed (K3), one
    ``_jac_to_affine_steps``, the signed entries, one ``_affine_add_steps``
    (K1 products, K5 inversions).  pts (steps, lanes, *elem) x2, planes and
    neg_t (n_digits, steps, lanes)."""
    F = curve.F
    n_digits, steps, lanes = planes.shape
    n_table = 1 << (window - 1)  # signed digits reach 2^(w-1)
    lane_ix = torch.arange(lanes, device=planes.device)[None, :]
    acc = _affine_infinity(curve, (n_digits, lanes), planes.device)
    for s in range(steps):
        pt = (pts[0][s], pts[1][s])
        entry = curve.from_affine(pt)
        table = [entry]
        for _ in range(n_table - 1):
            entry = curve.add_mixed(entry, pt)
            table.append(entry)
        tx, ty = _jac_to_affine_steps(F, tuple(torch.stack([e[i] for e in table]) for i in range(3)))
        addend = _signed_entries(F, tx, ty, planes[:, s].long(), neg_t[:, s], lane_ix)
        acc = _affine_add_steps(F, acc, addend)
    return acc


def _affine_chunked(curve: TCurve, pts: AffPoint, planes: torch.Tensor, neg_t: torch.Tensor, window: int):
    """_affine_steps a chunk of lane steps at a time (as many as
    ``cuda_msm_window.chunk_steps`` holds): the chunk's Jacobian tables by
    K6 (G1) or K8 (G2), one ``jac_to_affine_batch`` (K15), one
    ``affine_accumulate`` (K16).  The same partials, bit for bit."""
    F = curve.F
    n_digits, steps, lanes = planes.shape
    n_table = 1 << (window - 1)
    table_of = g2_window_table if curve.g2 else g1_window_table
    chunk = chunk_steps(lanes, n_table, math.prod(curve.elem))
    acc = _affine_infinity(curve, (n_digits, lanes), planes.device)
    for s0 in range(0, steps, chunk):
        table = jac_to_affine_batch(F, table_of((pts[0][s0:s0 + chunk], pts[1][s0:s0 + chunk]), n_table))
        acc = affine_accumulate(curve, acc, table, planes, neg_t, s0)
    return acc


def _windowed_affine(curve: TCurve, bases: AffPoint, mags: torch.Tensor, negs: torch.Tensor, lanes: int,
                     window: int, accumulate) -> JacPoint:
    F = curve.F
    elem = F.elem
    n_digits = mags.shape[0]
    n = bases[0].shape[0]
    device = bases[0].device
    lanes = _pow2_floor(min(lanes, n))
    pad = (-n) % lanes
    if pad:
        elem_pad = [0, 0] * len(elem)
        bases = tuple(F_.pad(c, elem_pad + [0, pad]) for c in bases)
        mags = F_.pad(mags, [0, pad])
        negs = F_.pad(negs, [0, pad])
    steps = (n + pad) // lanes
    pts = tuple(c.reshape((steps, lanes) + elem) for c in bases)
    acc = accumulate(curve, pts, mags.reshape(n_digits, steps, lanes), negs.reshape(n_digits, steps, lanes),
                     window)
    # infinity lanes carry (0, 0) by construction: from_affine's sentinel
    partials = curve.from_affine(acc[:2])
    per_lane = horner_fold_planes(curve, curve.infinity((lanes,), device), partials, window)
    return tree_reduce(curve, per_lane, lanes)


def msm_windowed_affine(
    curve: TCurve,
    bases: AffPoint,
    mags: torch.Tensor,
    negs: torch.Tensor,
    lanes: int = 64,
    window: int = 4,
) -> JacPoint:
    """``ops.msm.msm_windowed_signed`` with the accumulate tier in batch
    affine: the same signed digit planes in, the same point out (as a
    Jacobian triple whose limbs differ from the Jacobian tier's; compare
    through the host conversion).  G1 and G2 (Fq2 inverts by the norm
    route).  `lanes` rounds down to a power of 2, as in the reference.
    A chunk of lane steps a table launch (K6/K8), a normalisation (K15)
    and an accumulate launch (K16); ``_affine_steps`` is the old route."""
    return _windowed_affine(curve, bases, mags, negs, lanes, window, _affine_chunked)
