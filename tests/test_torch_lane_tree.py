"""The lane tree of zkp2p_tpu_torch.ops.cuda_lane_tree (K18 over G1 and
G2; its plain version on the CPU), compared exactly (equal limbs):

- ops.msm.tree_reduce against the reference's tree_reduce
  (zkp2p_tpu/ops/msm.py) on the same Jacobian limbs, G1 at 1, 2, 3, 5,
  17 and 64 lanes with a batch of 2, G2 at 1, 3 and 5 lanes (the
  reference's XLA G2 add is slow to compile on the CPU); the lanes hold a
  point at infinity, a pair P, P and a pair P, -P on the first level.
  XLA compiles the reference's add once for each shape it meets, some
  10 s (G1) and 20 s (G2) each, so its levels run through one compiled
  add a curve (_OneShapeAdd: a level padded with infinity lanes to one
  width, sliced back; the add is lane by lane);
- the plain version against the host sum of the points;
- the kernel's schedule (csrc/lane_tree.cu, the blocks and slots of
  tree_plan's stages) replayed on symbolic points against the loop's
  pairing, at every lane count up to 600 and at the MSMs' lane counts;
- the wrapper's rules: a tensor on neither the CPU nor CUDA raises, a
  CPU call launches nothing."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.curve.jcurve import G1J, G2J
from zkp2p_tpu.ops import msm as jmsm

from zkp2p_tpu_torch.curve import host
from zkp2p_tpu_torch.curve.tcurve import G1C, G2C, g1_jac_to_host, g1_to_affine_arrays, g2_jac_to_host, g2_to_affine_arrays
from zkp2p_tpu_torch.ops import cuda_build, cuda_lane_tree, msm

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

CURVES = {
    "g1": SimpleNamespace(C=G1C, gen=host.G1_GENERATOR, mul=host.g1_mul, add=host.g1_add, neg=host.g1_neg,
                          arrays=g1_to_affine_arrays, to_host=g1_jac_to_host),
    "g2": SimpleNamespace(C=G2C, gen=host.G2_GENERATOR, mul=host.g2_mul, add=host.g2_add, neg=host.g2_neg,
                          arrays=g2_to_affine_arrays, to_host=g2_jac_to_host),
}
# (curve, lanes, batch)
JAX_CASES = ([("g1", n, 2) for n in (1, 2, 3, 5, 17, 64)] + [("g2", n, None) for n in (1, 3, 5)])


class _OneShapeAdd:
    """The reference curve for its tree_reduce, with its add compiled once:
    the level's halves padded with infinity (zero) lanes to `width` along
    the lanes axis, added by one jitted G1J / G2J add, sliced back."""

    def __init__(self, J, width):
        self.F = J.F
        self.width = width
        self._add = jax.jit(J.add)

    def add(self, p, q):
        ax = p[0].ndim - 1 - self.F.zero_limbs.ndim
        n = p[0].shape[ax]
        pad = [(0, 0)] * p[0].ndim
        pad[ax] = (0, self.width - n)
        out = self._add(tuple(jnp.pad(c, pad) for c in p), tuple(jnp.pad(c, pad) for c in q))
        return tuple(jax.lax.slice_in_dim(c, 0, n, axis=ax) for c in out)


# the widest level of the cases: 64 lanes' 32 sums (G1), 5 lanes' 3 (G2)
JAX_CURVES = {"g1": _OneShapeAdd(G1J, 32), "g2": _OneShapeAdd(G2J, 3)}


def _lanes(curve, lanes, batch, seed):
    """Jacobian limbs (*batch, lanes, *elem) with Z != 1 (each point 2H,
    doubled by the plain K4) and the host points; scalars from numpy.  A
    lane at infinity, and on the first level (pairs i, i + ceil(n/2)) a
    pair P, P and a pair P, -P where the lanes allow."""
    cv = CURVES[curve]
    rows = []
    for b in range(batch or 1):
        ks = np.random.default_rng(seed + b).integers(1, 1 << 62, size=lanes)
        halves = [cv.mul(cv.gen, int(k)) for k in ks]
        h = -(-lanes // 2)
        if lanes >= 2:
            halves[0] = None
        if lanes >= 4:
            halves[1 + h] = halves[1]
        if lanes >= 6:
            halves[2 + h] = cv.neg(halves[2])
        rows.append(halves)
    jac = [cv.C.double(cv.C.from_affine(cv.arrays(row, "cpu"))) for row in rows]
    pts = tuple(torch.stack([j[c] for j in jac]) for c in range(3))
    if batch is None:
        pts = tuple(c[0] for c in pts)
    return pts, [[None if h is None else cv.add(h, h) for h in row] for row in rows]


def _host_sum(cv, row):
    acc = None
    for p in row:
        acc = cv.add(acc, p)
    return acc


@pytest.mark.parametrize("curve,lanes,batch", JAX_CASES, ids=[f"{c}-{n}x{b}" for c, n, b in JAX_CASES])
def test_tree_reduce_matches_jax(curve, lanes, batch):
    cv = CURVES[curve]
    pts, rows = _lanes(curve, lanes, batch, 40 + lanes)
    cuda_build.reset_launches()
    got = msm.tree_reduce(cv.C, pts, lanes)
    assert not any(cuda_build.LAUNCHES.values())
    want = jmsm.tree_reduce(JAX_CURVES[curve], tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in pts), lanes)
    assert all(np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64)) for g, w in zip(got, want))
    plain = cuda_lane_tree.lane_tree(cv.C.g2, pts)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))
    sums = cv.to_host(tuple(c.reshape((-1,) + c.shape[c.dim() - len(cv.C.elem):]) for c in got))
    assert sums == [_host_sum(cv, row) for row in rows]


# ------------------------------------------------- the kernel's schedule


def _add(p, q):
    """pt_add on symbolic points: infinity (None) is the identity."""
    if q is None:
        return p
    if p is None:
        return q
    return (p, q)


def _loop(n):
    """The loop's sum of lanes 0..n-1 (tree_steps on symbols)."""
    pts = list(range(n))
    while len(pts) > 1:
        if len(pts) % 2:
            pts.append(None)
        h = len(pts) // 2
        pts = [_add(pts[i], pts[i + h]) for i in range(h)]
    return pts[0]


def _count(n0, k):
    return -(-n0 >> k)


def _block(level0, n0, levels, per_block, a):
    """csrc/lane_tree.cu: lt_levels, one block: the outputs [a, a +
    per_block) of level `levels` from the level-0 points `level0`."""
    cap = per_block << levels
    sm = []
    for e in range(cap):
        s, t = divmod(e, per_block)
        idx = a + t + sum(_count(n0, j) for j in range(1, levels + 1) if (s >> (levels - j)) & 1)
        sm.append(level0[idx] if idx < n0 else None)
    for k in range(levels):
        half = cap >> (k + 1)
        n_k, h = _count(n0, k), _count(n0, k + 1)
        for e in range(half):
            s, t = divmod(e, per_block)
            idx = a + t + sum(_count(n0, j) for j in range(k + 2, levels + 1) if (s >> (levels - j)) & 1)
            if idx + h < n_k:
                sm[e] = _add(sm[e], sm[e + half])
    n_out = _count(n0, levels)
    return [sm[e] for e in range(per_block) if a + e < n_out]


def _kernel(n):
    """k_lane_tree's stages for one witness, as tree_plan plans them."""
    plan = cuda_lane_tree.tree_plan(n)
    level0 = list(range(n))
    if plan.levels_b < 0:
        assert plan.per_block == 1 and plan.blocks == 1 and (1 << plan.levels_a) <= cuda_lane_tree.CAP
        (out,) = _block(level0, n, plan.levels_a, 1, 0)
        return out
    assert plan.per_block << plan.levels_a == cuda_lane_tree.CAP and plan.n_a <= cuda_lane_tree.CAP
    scratch = []
    for blk in range(plan.blocks):
        scratch += _block(level0, n, plan.levels_a, plan.per_block, blk * plan.per_block)
    assert len(scratch) == plan.n_a == _count(n, plan.levels_a)
    assert (1 << plan.levels_b) <= cuda_lane_tree.CAP
    (out,) = _block(scratch, plan.n_a, plan.levels_b, 1, 0)
    return out


# every count up to 600 (both stages, odd levels at every depth), the
# MSMs' lane counts, and the largest two stages take
SCHEDULE_LANES = list(range(1, 601)) + [2088, 4096, 16384, 2 ** 16 - 1]


def test_kernel_schedule_pairs_as_the_loop():
    for n in SCHEDULE_LANES:
        assert _kernel(n) == _loop(n), n


def test_tree_plan():
    assert cuda_lane_tree.tree_plan(1) == (0, 1, 1, 1, -1)
    assert cuda_lane_tree.tree_plan(256) == (8, 1, 1, 1, -1)
    assert cuda_lane_tree.tree_plan(16384) == (6, 4, 64, 256, 8)
    assert cuda_lane_tree.tree_plan(2088) == (4, 16, 9, 131, 8)
    assert cuda_lane_tree.tree_plan(572) == (2, 64, 3, 143, 8)
    for n in (0, 2 ** 16 + 1):
        with pytest.raises(ValueError):
            cuda_lane_tree.tree_plan(n)


# ----------------------------------------------------------- the wrapper


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_lane_tree_rules(g2):
    elem = (2, 16) if g2 else (16,)
    cuda_build.reset_launches()
    pts = tuple(torch.zeros((3, 5) + elem, dtype=torch.int32) for _ in range(3))
    got = cuda_lane_tree.lane_tree(g2, pts)
    assert all(c.shape == (3,) + elem and not c.any() for c in got)  # infinity sums to infinity
    assert not any(cuda_build.LAUNCHES.values())
    with pytest.raises(ValueError):
        cuda_lane_tree.lane_tree(g2, tuple(c.to("meta") for c in pts))
    with pytest.raises(ValueError):
        cuda_lane_tree.lane_tree(g2, (pts[0], pts[1], pts[2].to("meta")))
