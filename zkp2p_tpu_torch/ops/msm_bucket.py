"""Sorted-prefix bucket MSM: Pippenger-class windows with no scatter
(port of the reference's ``ops/msm_bucket.py``).

Per signed digit plane:

  1. sort the points by digit (a stable argsort) and gather them in
     that order, negated where the digit is;
  2. take inclusive prefix sums S_i of the sorted points under complete
     affine addition (``ops.msm_affine``), by reshape-halving: 2n adds;
  3. read the bucket sum off the prefixes:

         sum_i d_i P_i  =  sum_{k=0}^{K-1} (S_n - S_{c_k}),

     with c_k = #{i : d_(i) <= k} (one searchsorted) and K = 2^(w-1)
     signed buckets: K gathers, K affine subtracts and a K-leaf affine
     tree.

The reference's ``lax.scan`` over planes is a Python loop.  The plane
partials fold by Horner in one kernel (K10; ``_fold_steps`` in
``ops/msm.py`` is its comparator).  G1 only, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from ..curve.tcurve import AffPoint, JacPoint, TCurve
from .msm import horner_fold_planes
from .msm_affine import affine_add_complete


def _gather(triple, idx):
    x, y, inf = triple
    return x[idx], y[idx], inf[idx]


def affine_prefix_incl(F, pts):
    """Inclusive prefix sums along axis 0 (power-of-2 length) under
    complete affine addition: out[i] = pts[0] + ... + pts[i].

    Reshape-halving (the curve-add twin of msm_affine.excl_prefix_mul):
    pair adjacent elements (n/2 adds), recurse for the odd positions'
    prefixes, and one more layer of adds fixes the even positions -- 2n
    adds, log depth."""
    x, y, inf = pts
    n = x.shape[0]
    assert n & (n - 1) == 0, "affine_prefix_incl needs a power-of-2 length"
    if n == 1:
        return pts
    evens = (x[0::2], y[0::2], inf[0::2])
    odds = (x[1::2], y[1::2], inf[1::2])
    # S_1, S_3, S_5, ... (odd positions)
    sub = affine_prefix_incl(F, affine_add_complete(F, evens, odds))
    # S_{2k} = S_{2k-1} + x_{2k}; S_{-1} = identity
    shifted = (
        F_.pad(sub[0][:-1], (0, 0, 1, 0)),
        F_.pad(sub[1][:-1], (0, 0, 1, 0)),
        F_.pad(sub[2][:-1], (1, 0), value=True),
    )
    even_pref = affine_add_complete(F, shifted, evens)
    del shifted
    return tuple(torch.stack((e, o), dim=1).reshape(c.shape) for e, o, c in zip(even_pref, sub, pts))


def affine_tree_reduce(F, pts):
    """Sum a power-of-2 batch of affine triples along axis 0 by pairwise
    halving (log2(n) batched affine adds)."""
    x, y, inf = pts
    n = x.shape[0]
    assert n & (n - 1) == 0
    while n > 1:
        a = (x[: n // 2], y[: n // 2], inf[: n // 2])
        b = (x[n // 2 : n], y[n // 2 : n], inf[n // 2 : n])
        x, y, inf = affine_add_complete(F, a, b)
        n //= 2
    return x[0], y[0], inf[0]


def msm_bucket_affine(
    curve: TCurve,
    bases: AffPoint,
    mags: torch.Tensor,
    negs: torch.Tensor,
    window: int = 16,
) -> JacPoint:
    """MSM over signed base-2^window digit planes by sorted prefix
    buckets.  bases: affine (x, y) with (0, 0) infinity holes; mags/negs
    from ``ops.msm.signed_digit_planes_from_limbs(..., window)``.
    Returns one Jacobian point.  G1 only."""
    assert len(curve.elem) == 1, "bucket MSM is G1-only"
    F = curve.F
    device = bases[0].device
    n_planes = mags.shape[0]
    n = bases[0].shape[0]
    npad = (1 << (n - 1).bit_length()) - n
    bx, by = bases
    if npad:
        bx = F_.pad(bx, (0, 0, 0, npad))
        by = F_.pad(by, (0, 0, 0, npad))
        mags = F_.pad(mags, (0, npad))
        negs = F_.pad(negs, (0, npad))
    base_inf = F.is_zero(bx) & F.is_zero(by)
    K = 1 << (window - 1)
    keys = torch.arange(K, dtype=torch.int64, device=device)

    outs = []
    for p in range(n_planes):
        order = torch.argsort(mags[p], stable=True)
        ds = mags[p][order].long()
        px = bx[order]
        py = by[order]
        pinf = base_inf[order] | (ds == 0)
        py = F.select(negs[p][order], F.neg(py), py)
        zero = torch.zeros_like(px)
        px = F.select(pinf, zero, px)
        py = F.select(pinf, zero, py)
        del order, zero

        Sx, Sy, Sinf = affine_prefix_incl(F, (px, py, pinf))
        del px, py, pinf
        # S_ext[0] = identity, so a gather at c_k = 0 reads S_0 = O
        Sx = F_.pad(Sx, (0, 0, 1, 0))
        Sy = F_.pad(Sy, (0, 0, 1, 0))
        Sinf = F_.pad(Sinf, (1, 0), value=True)

        c = torch.searchsorted(ds, keys, right=True)
        gx, gy, ginf = _gather((Sx, Sy, Sinf), c)
        total = (Sx[-1].expand_as(gx), Sy[-1].expand_as(gy), Sinf[-1].expand_as(ginf))
        del Sx, Sy, Sinf, ds
        diff = affine_add_complete(F, total, (gx, F.neg(gy), ginf))
        outs.append(affine_tree_reduce(F, diff))

    gx, gy, ginf = (torch.stack(c) for c in zip(*outs))
    # force the (0, 0) sentinel on infinity planes before from_affine
    zero = torch.zeros_like(gx)
    planes_jac = curve.from_affine((F.select(ginf, zero, gx), F.select(ginf, zero, gy)))
    return horner_fold_planes(curve, curve.infinity((), device), planes_jac, window)
