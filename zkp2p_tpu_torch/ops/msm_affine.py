"""Batch-affine windowed MSM: the accumulate tier in affine coordinates
(port of the reference's ``ops/msm_affine.py``).

An affine + affine add costs 4 field products plus a share of one batched
inversion (about 5 products a lane), against 16 for the Jacobian add of
``ops.msm``.  Per lane step the multiples table is built in Jacobian
(K3) and normalised to affine with one batched inversion; the
accumulators live in affine (x, y, is_inf) and every (digit, lane)
denominator of a step is inverted together.

Batch inversion: exclusive prefix and suffix products by reshape-halving
(2 products an element a direction), then one Fermat inversion of the
total, ``TPrimeField.inv_fused`` (kernel K5 on CUDA).  Exceptional lanes
ride branch-free selects: accumulator at infinity, addend at infinity,
equal-x doubling and P + (-P).

The products are K1 on CUDA; the adds, subtracts and selects are plain
torch, as they are plain XLA in the reference.  The reference's
``lax.scan`` over lane steps is a Python loop here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F_

from ..curve.tcurve import AffPoint, JacPoint, TCurve
from .msm import horner_fold_planes, tree_reduce


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


def batch_inverse(F, x: torch.Tensor) -> torch.Tensor:
    """Invert every element of x (axis 0 = batch) with ONE field
    inversion: inv(x_i) = prefix_excl_i * (total^-1 * suffix_excl_i); the
    suffix sweep is seeded with total^-1.

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
        ninv = batch_inverse(fq, norm)
        return torch.stack([fq.mul(a, ninv), fq.neg(fq.mul(b, ninv))], dim=-2)
    n = x.shape[0]
    if n & (n - 1):
        pad = (1 << n.bit_length()) - n
        ones = F.one_like(x[:1]).expand((pad,) + tuple(x.shape[1:]))
        return batch_inverse(F, torch.cat([x, ones]))[:n]
    safe = F.select(F.is_zero(x), F.one_like(x), x)
    one = F.const("one", x.device).int()
    pe = excl_prefix_mul(F, safe, one)
    total = F.mul(pe[-1], safe[-1])
    tinv = F.inv_fused(total)
    sfx = torch.flip(excl_prefix_mul(F, torch.flip(safe, [0]), tinv), [0])
    return F.mul(pe, sfx)


def jac_to_affine_batch(F, pts: JacPoint) -> AffPoint:
    """Jacobian (X, Y, Z) with an axis-0 batch -> affine (X/Z^2, Y/Z^3);
    infinity (Z = 0) -> the (0, 0) sentinel.  One batched inversion."""
    X, Y, Z = pts
    inf = F.is_zero(Z)
    zinv = batch_inverse(F, Z)
    zi2 = F.square(zinv)
    x = F.mul(X, zi2)
    y = F.mul(Y, F.mul(zi2, zinv))
    zero = torch.zeros_like(x)
    return F.select(inf, zero, x), F.select(inf, zero, y)


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


def affine_add_complete(F, a, b):
    """Complete affine add of two (x, y, is_inf) triples with any leading
    batch shape: the phase-1 denominators are batch-inverted over the
    whole flattened batch (padded to a power of 2 with ones), then
    phase 2 completes."""
    elem = F.elem
    den, flags = _affine_add_den(F, a, b)
    bshape = den.shape[: den.dim() - len(elem)]
    flat = math.prod(bshape)
    n_pad = (1 << (flat - 1).bit_length()) - flat if flat > 1 else 0
    d = den.reshape((flat,) + elem)
    if n_pad:
        d = torch.cat([d, F.one_like(d[:1]).expand((n_pad,) + elem)])
    dinv = batch_inverse(F, d)[:flat].reshape(den.shape)
    return _affine_add_apply(F, a, b, dinv, flags)


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


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
    route).  `lanes` rounds down to a power of 2, so that the flattened
    table and denominator batches halve evenly."""
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
    planes = mags.reshape(n_digits, steps, lanes)
    neg_t = negs.reshape(n_digits, steps, lanes)

    n_table = 1 << (window - 1)  # signed digits reach 2^(w-1)
    lane_ix = torch.arange(lanes, device=device)[None, :]
    zero = torch.zeros((n_digits, lanes) + elem, dtype=torch.int32, device=device)
    acc = (zero, zero, torch.ones((n_digits, lanes), dtype=torch.bool, device=device))
    tshape = (n_table + 1, lanes) + elem
    for s in range(steps):
        pt = (pts[0][s], pts[1][s])
        # multiples 1..n_table in Jacobian, then one batched normalisation
        entry = curve.from_affine(pt)
        table = [entry]
        for _ in range(n_table - 1):
            entry = curve.add_mixed(entry, pt)
            table.append(entry)
        flat = tuple(torch.cat([e[i] for e in table]) for i in range(3))
        tx, ty = jac_to_affine_batch(F, flat)
        tx = torch.cat([torch.zeros_like(tx[:lanes]), tx]).reshape(tshape)
        ty = torch.cat([torch.zeros_like(ty[:lanes]), ty]).reshape(tshape)

        digits = planes[:, s, :].long()
        sx = tx[digits, lane_ix]
        sy = ty[digits, lane_ix]
        sy = F.select(neg_t[:, s, :], F.neg(sy), sy)  # -|d|P = (x, -y); -0 = 0
        # infinity: the digit-0 row and infinity bases, both (0, 0) here
        sinf = F.is_zero(sx) & F.is_zero(sy)
        addend = (sx, sy, sinf)

        den, flags = _affine_add_den(F, acc, addend)
        dinv = batch_inverse(F, den.reshape((n_digits * lanes,) + elem)).reshape(den.shape)
        acc = _affine_add_apply(F, acc, addend, dinv, flags)

    # infinity lanes carry (0, 0) by construction: from_affine's sentinel
    partials = curve.from_affine(acc[:2])
    per_lane = horner_fold_planes(curve, curve.infinity((lanes,), device), partials, window)
    return tree_reduce(curve, per_lane, lanes)
