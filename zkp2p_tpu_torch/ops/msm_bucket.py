"""Sorted-prefix bucket MSM: Pippenger-class windows with no scatter
(port of the reference's ``ops/msm_bucket.py``).

Per signed digit plane:

  1. sort the points by digit (a stable sort) and gather them in that
     order, negated where the digit is;
  2. take inclusive prefix sums S_i of the sorted points under complete
     affine addition (``ops.msm_affine``), by reshape-halving: 2n adds;
  3. read the bucket sum off the prefixes:

         sum_i d_i P_i  =  sum_{k=0}^{K-1} (S_n - S_{c_k}),

     with c_k = #{i : d_(i) <= k} (one searchsorted) and K = 2^(w-1)
     signed buckets: K gathers, K affine subtracts and a K-leaf affine
     tree.

The reference's ``lax.scan`` over planes runs them one after another.
Here a group of ``PLANE_GROUP`` planes runs its steps as one batch
(``_group_sums``): each prefix level, the differences and each tree
level is one add over the group's planes, so the group's adds wait on
one another once, not once a plane.  On CUDA every add is one launch of
K16 (``ops.cuda_affine``), which reads the prefix recursion's strided
halves in place; the argsort and searchsorted stay torch calls, as the
reference leaves them to XLA.  ``_plane_sums`` is the old route, a plane
at a time (its adds ``_affine_add_steps``: K1 products and a K5
inversion each on CUDA), kept as the comparator.  The plane partials
fold by Horner in one kernel (K10).  G1 only, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from ..curve.tcurve import AffPoint, JacPoint, TCurve
from .msm import horner_fold_planes
from .msm_affine import _affine_add_steps, affine_add_complete

# Planes whose prefix levels run as one batch: the smallest group whose
# h MSM time is within 1% of all 16 planes in one group.  A plane of 2^23
# points is 1 GiB of coordinates a copy, and the prefix recursion holds
# about three copies of its group.  On an H100 80GB HBM3 at 700 W, groups
# of 1, 2, 4, 8 and 16 planes take 0.585, 0.542, 0.521, 0.513 and 0.510 s
# at peaks of 22.4, 22.4, 25.8, 38.1 and 62.8 GiB (chip_smoke.py,
# affine_same_run): with one plane a group, the small levels at the end
# of each plane's recursion, too few adds to fill the card, run 16 times
# in sequence.
PLANE_GROUP = 8


def affine_prefix_incl(F, pts, add=affine_add_complete):
    """Inclusive prefix sums along axis 0 (power-of-2 length) under
    complete affine addition: out[i] = pts[0] + ... + pts[i]; any batch
    dims after axis 0 are independent sums.

    Reshape-halving (the curve-add twin of msm_affine.excl_prefix_mul):
    pair adjacent elements (n/2 adds), recurse for the odd positions'
    prefixes, and one more layer of adds fixes the even positions -- 2n
    adds, log depth.  `add` takes the strided halves as views."""
    x, y, inf = pts
    n = x.shape[0]
    assert n & (n - 1) == 0, "affine_prefix_incl needs a power-of-2 length"
    if n == 1:
        return pts
    evens = (x[0::2], y[0::2], inf[0::2])
    # S_1, S_3, S_5, ... (odd positions)
    sub = affine_prefix_incl(F, add(F, evens, (x[1::2], y[1::2], inf[1::2])), add)
    out = tuple(torch.empty_like(c) for c in pts)
    for o, s in zip(out, sub):
        o[1::2] = s
    # S_0 = x_0; S_{2k} = S_{2k-1} + x_{2k}
    for o, e in zip(out, evens):
        o[0] = e[0]
    if n > 2:
        even_pref = add(F, tuple(s[:-1] for s in sub), tuple(e[1:] for e in evens))
        del sub
        for o, e in zip(out, even_pref):
            o[2::2] = e
    return out


def affine_tree_reduce(F, pts, add=affine_add_complete):
    """Sum a power-of-2 batch of affine triples along axis 0 by pairwise
    halving (log2(n) batched affine adds); batch dims after axis 0 are
    independent sums."""
    x, y, inf = pts
    n = x.shape[0]
    assert n & (n - 1) == 0
    while n > 1:
        a = (x[: n // 2], y[: n // 2], inf[: n // 2])
        b = (x[n // 2 : n], y[n // 2 : n], inf[n // 2 : n])
        x, y, inf = add(F, a, b)
        n //= 2
    return x[0], y[0], inf[0]


def _bucket_sums(F, S, ds, window, add):
    """The bucket sums sum_k (S_n - S_{c_k}) from the prefixes S (n,
    *batch) of points sorted by digit, ds (*batch, n) the sorted digits:
    (*batch,) affine triples."""
    Sx, Sy, Sinf = S
    K = 1 << (window - 1)
    batch = ds.shape[:-1]
    keys = torch.arange(K, dtype=ds.dtype, device=ds.device).expand(batch + (K,)).contiguous()
    # c_k counts the points with digit <= k: the prefix S_{c_k - 1}, or the
    # identity at c_k = 0
    c = torch.searchsorted(ds.contiguous(), keys, right=True).movedim(-1, 0)  # (K, *batch)
    cols = torch.meshgrid(*(torch.arange(b, device=ds.device) for b in batch), indexing="ij")
    idx = ((c - 1).clamp(min=0),) + tuple(col.expand_as(c) for col in cols)
    empty = c == 0
    gx = F.select(empty, torch.zeros((), dtype=Sx.dtype, device=Sx.device), Sx[idx])
    gy = F.select(empty, torch.zeros((), dtype=Sy.dtype, device=Sy.device), Sy[idx])
    ginf = empty | Sinf[idx]
    total = tuple(s[-1:].expand((K,) + s.shape[1:]) for s in S)
    diff = add(F, total, (gx, F.neg(gy), ginf))
    return affine_tree_reduce(F, diff, add)


def _sorted_points(bx, byy, base_inf, mags, negs):
    """The points of planes (G, n) sorted by digit: x, y (n, G, 16), inf
    (n, G), each negated where its digit is and (0, 0) at infinity or
    digit 0; and the sorted digits (G, n).  byy holds the bases' y and
    then their negations, (2n, 16): a negated point is one gather."""
    G, n = mags.shape
    ds, order = torch.sort(mags, dim=-1, stable=True)
    ds = ds.long()
    neg = torch.gather(negs, -1, order)
    pinf = (base_inf[order] | (ds == 0)).t()
    # row gathers with a contiguous (n, G) index
    px = bx.index_select(0, order.t().reshape(-1)).view(n, G, -1)
    py = byy.index_select(0, (order + n * neg).t().reshape(-1)).view(n, G, -1)
    px.masked_fill_(pinf[..., None], 0)
    py.masked_fill_(pinf[..., None], 0)
    return (px, py, pinf), ds


def _group_sums(F, bx, byy, base_inf, mags, negs, window):
    """The bucket sums of the planes mags/negs (G, n), all G as one
    batch: every prefix level, the differences and every tree level one
    add over the group.  (G,) affine triples."""
    pts, ds = _sorted_points(bx, byy, base_inf, mags, negs)
    S = affine_prefix_incl(F, pts)
    del pts
    return _bucket_sums(F, S, ds, window, affine_add_complete)


def _plane_sums(F, bx, byy, base_inf, mags, negs, window):
    """The old route of _group_sums: one plane at a time, every add by
    ``_affine_add_steps``."""
    outs = []
    for p in range(mags.shape[0]):
        pts, ds = _sorted_points(bx, byy, base_inf, mags[p:p + 1], negs[p:p + 1])
        S = affine_prefix_incl(F, pts, _affine_add_steps)
        del pts
        outs.append(_bucket_sums(F, S, ds, window, _affine_add_steps))
    return tuple(torch.cat(c) for c in zip(*outs))


def _bucket_msm(curve: TCurve, bases: AffPoint, mags: torch.Tensor, negs: torch.Tensor, window: int,
                plane_sums, group: int) -> JacPoint:
    assert len(curve.elem) == 1, "bucket MSM is G1-only"
    F = curve.F
    device = bases[0].device
    n = bases[0].shape[0]
    npad = (1 << (n - 1).bit_length()) - n
    bx, by = bases
    if npad:
        bx = F_.pad(bx, (0, 0, 0, npad))
        by = F_.pad(by, (0, 0, 0, npad))
        mags = F_.pad(mags, (0, npad))
        negs = F_.pad(negs, (0, npad))
    base_inf = F.is_zero(bx) & F.is_zero(by)
    byy = torch.cat([by, F.neg(by)])
    outs = [plane_sums(F, bx, byy, base_inf, mags[g:g + group], negs[g:g + group], window)
            for g in range(0, mags.shape[0], group)]
    gx, gy, ginf = (torch.cat(c) for c in zip(*outs))
    # force the (0, 0) sentinel on infinity planes before from_affine
    zero = torch.zeros_like(gx)
    planes_jac = curve.from_affine((F.select(ginf, zero, gx), F.select(ginf, zero, gy)))
    return horner_fold_planes(curve, curve.infinity((), device), planes_jac, window)


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
    Returns one Jacobian point.  G1 only.  PLANE_GROUP planes a batch
    (``_group_sums``); ``msm_bucket_affine_steps`` is the old route."""
    return _bucket_msm(curve, bases, mags, negs, window, _group_sums, PLANE_GROUP)


def msm_bucket_affine_steps(curve: TCurve, bases: AffPoint, mags: torch.Tensor, negs: torch.Tensor,
                            window: int = 16) -> JacPoint:
    """msm_bucket_affine by the old route: a plane at a time, each add
    ``_affine_add_steps``.  The same point, bit for bit."""
    return _bucket_msm(curve, bases, mags, negs, window, _plane_sums, 1)
