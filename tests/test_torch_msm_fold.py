"""The Horner fold of zkp2p_tpu_torch.ops.cuda_msm_fold (K10 over G1, K11
over G2; their plain versions on the CPU), compared exactly (equal limbs),
with G1 and G2 as cases of the same tests: against the reference's
horner_fold_planes over G1J / G2J, against the step loop it replaces
(ops.msm._fold_steps) and against a Horner sum of host points.  Window 4
with 3 planes over 6 lanes, with the special lanes: an init at infinity
and one not, plane partials at infinity, a partial equal to 2^w * acc (the
add's doubling branch) and one equal to -2^w * acc (infinity); window 16
with 16 planes at batch (), as the bucket MSM folds; window 4 with 5
planes over 4 lanes, the init and the first 2 planes at infinity in every
lane (as a witness's small scalars leave the top planes), which the plain
fold skips.  The G2 cases of the
reference comparison are slow (XLA compiles the Fq2 graphs for about 30 s
on the CPU); the host comparison is their tier-1 twin."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.curve.jcurve import G1J, G2J
from zkp2p_tpu.ops import msm as jmsm

from zkp2p_tpu_torch.curve import host
from zkp2p_tpu_torch.curve.tcurve import G1C, G2C, g1_jac_to_host, g1_to_affine_arrays, g2_jac_to_host, g2_to_affine_arrays
from zkp2p_tpu_torch.ops import cuda_msm_fold, msm

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

CURVES = {
    "g1": SimpleNamespace(C=G1C, J=G1J, gen=host.G1_GENERATOR, mul=host.g1_mul, add=host.g1_add, neg=host.g1_neg,
                          arrays=g1_to_affine_arrays, to_host=g1_jac_to_host, fold=cuda_msm_fold.g1_horner_fold,
                          plain=cuda_msm_fold.g1_horner_fold_plain),
    "g2": SimpleNamespace(C=G2C, J=G2J, gen=host.G2_GENERATOR, mul=host.g2_mul, add=host.g2_add, neg=host.g2_neg,
                          arrays=g2_to_affine_arrays, to_host=g2_jac_to_host, fold=cuda_msm_fold.g2_horner_fold,
                          plain=cuda_msm_fold.g2_horner_fold_plain),
}
# (lanes, planes, window); lanes None is the batch ()
SHAPES = {"w4": (6, 3, 4), "w16": (None, 16, 16), "lead": (4, 5, 4)}


def _jacobian(cv, pts):
    """Host points (None = infinity) as Jacobian limbs with Z != 1: each is
    2H for the host point H = P / 2 given, doubled by the plain K4."""
    return cv.C.double(cv.C.from_affine(cv.arrays(pts, "cpu")))


def _case(curve, shape, seed):
    """(init, planes, host init, host planes) from scalars drawn by numpy;
    for 6 lanes, the special lanes (see the module docstring)."""
    cv = CURVES[curve]
    lanes, n_planes, window = SHAPES[shape]
    n = lanes or 1
    ks = np.random.default_rng(seed).integers(1, 1 << 62, size=(n_planes + 1, n))
    halves = [[cv.mul(cv.gen, int(k)) for k in row] for row in ks]  # H; the points are 2H
    if lanes == 6:
        halves[0][0] = None  # lane 0: init at infinity
        halves[1][2] = cv.mul(halves[0][2], 1 << window)  # lane 2: plane 0 = 2^w * init (doubling branch)
        halves[1][3] = cv.neg(cv.mul(halves[0][3], 1 << window))  # lane 3: plane 0 = -2^w * init (infinity)
        halves[2][4] = None  # lane 4: plane 1 at infinity
        for p in range(n_planes):
            halves[1 + p][5] = None  # lane 5: every plane at infinity
    elif shape == "lead":
        for row in halves[:3]:  # the init and planes 0 and 1 at infinity in every lane
            row[:] = [None] * n
        halves[4][1] = None
    else:
        halves[2][0] = None  # plane 1 at infinity
    jac = [_jacobian(cv, row) for row in halves]
    pts = [[None if h is None else cv.add(h, h) for h in row] for row in halves]
    init = jac[0]
    planes = tuple(torch.stack([j[c] for j in jac[1:]]) for c in range(3))
    if lanes is None:
        init = tuple(c[0] for c in init)
        planes = tuple(c[:, 0] for c in planes)
    return init, planes, pts[0], pts[1:]


def _equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _horner_host(cv, init, planes, window):
    out = []
    for lane, acc in enumerate(init):
        for row in planes:
            for _ in range(window):
                acc = cv.add(acc, acc)
            acc = cv.add(acc, row[lane])
        out.append(acc)
    return out


CASES = [(c, s) for c in CURVES for s in SHAPES]


@pytest.mark.parametrize("curve,shape", CASES, ids=[f"{c}-{s}" for c, s in CASES])
def test_fold_matches_fold_steps_and_host(curve, shape):
    cv = CURVES[curve]
    window = SHAPES[shape][2]
    init, planes, init_h, planes_h = _case(curve, shape, 11)
    got = msm.horner_fold_planes(cv.C, init, planes, window)
    assert all(g.shape == i.shape and g.dtype == torch.int32 for g, i in zip(got, init))
    assert _equal(got, cv.fold(init, planes, window))
    assert _equal(got, msm._fold_steps(cv.C, init, planes, window))
    assert cv.to_host(got) == _horner_host(cv, init_h, planes_h, window)
    if shape == "lead":
        assert cuda_msm_fold._leading_idle_planes(curve == "g2", init, planes) == 2
    if shape == "w4":
        # lane 2 took the add's doubling branch to 2^(w+1) * init; lane 3
        # reached infinity at plane 0 and then added planes 1 and 2
        assert planes_h[0][2] == cv.mul(init_h[2], 1 << window)
        assert cv.to_host(got)[3] == _horner_host(cv, [None], [row[3:4] for row in planes_h[1:]], window)[0]
    # neither input was written
    assert _equal(init, _case(curve, shape, 11)[0])


@pytest.mark.parametrize("curve,shape", [
    pytest.param(c, s, marks=[pytest.mark.slow] if c == "g2" else []) for c, s in CASES
], ids=[f"{c}-{s}" for c, s in CASES])
def test_fold_plain_matches_jax(curve, shape):
    cv = CURVES[curve]
    window = SHAPES[shape][2]
    init, planes, _, _ = _case(curve, shape, 12)
    want = jmsm.horner_fold_planes(cv.J, tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in init),
                                   tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in planes), window)
    got = cv.plain(init, planes, window)
    assert all(np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64)) for g, w in zip(got, want))
