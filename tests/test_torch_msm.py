"""The port's MSM (zkp2p_tpu_torch.ops.msm, signed windowed path) against
the host oracles curve.host.g1_msm/g2_msm: an n that is not a multiple of
the lanes and infinity bases included.  The signed digit recode against
the JAX one; the whole MSM against the JAX function in the slow tier
(slow there: XLA compiles)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.curve import host as ref_host
from zkp2p_tpu.curve.jcurve import g1_to_affine_arrays, g2_to_affine_arrays
from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.field.jfield import int_to_limbs
from zkp2p_tpu.ops import msm as jmsm

from zkp2p_tpu_torch.curve.tcurve import G1C, G2C, g1_jac_to_host, g2_jac_to_host
from zkp2p_tpu_torch.ops import msm

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

rng = random.Random(1234)


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def scalars(n, holes=()):
    ks = [rng.randrange(R) for _ in range(n)]
    ks[0], ks[1], ks[2] = 0, 1, R - 1
    return ks


def std_limbs(ks):
    return np.stack([int_to_limbs(k) for k in ks])


def g2_tuple(p):
    return None if p is None else tuple((c.c0, c.c1) for c in p)


def test_signed_digit_planes_match_jax():
    ks = scalars(33) + [(1 << 253) + 12345, 0x8888888888]
    lim = std_limbs(ks)
    mags, negs = msm.signed_digit_planes_from_limbs(to_t(lim), 4)
    jm, jn = jmsm.signed_digit_planes_from_limbs(jnp.asarray(lim), 4)
    assert np.array_equal(mags.numpy(), np.asarray(jm).astype(np.int32))
    assert np.array_equal(negs.numpy(), np.asarray(jn))
    assert np.array_equal(msm.digit_planes_from_limbs(to_t(lim), 4).numpy(),
                          np.asarray(jmsm.digit_planes_from_limbs(jnp.asarray(lim), 4)).astype(np.int32))
    for n in (10, 1000, 70000, 10**6):
        assert msm.default_lanes(n) == jmsm.default_lanes(n)
        assert msm.default_lanes(n, cap=16384) == jmsm.default_lanes(n, cap=16384)


def g1_case(n, holes):
    pts = [ref_host.g1_mul(ref_host.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    for h in holes:
        pts[h] = None
    return pts


@pytest.mark.parametrize("n,lanes", [(70, 64), (37, 16)])
def test_msm_g1_matches_host(n, lanes):
    pts = g1_case(n, holes=(3, n - 1))
    ks = scalars(n)
    bases = tuple(to_t(c) for c in g1_to_affine_arrays(pts))
    mags, negs = msm.signed_digit_planes_from_limbs(to_t(std_limbs(ks)), 4)
    got = msm.msm_windowed_signed(G1C, bases, mags, negs, lanes=lanes, window=4)
    assert g1_jac_to_host(got) == [ref_host.g1_msm(pts, ks)]


def test_msm_g2_matches_host():
    n = 11
    pts = [ref_host.g2_mul(ref_host.G2_GENERATOR, rng.randrange(1, 1 << 64)) for _ in range(n)]
    pts[4] = None
    ks = scalars(n)
    bases = tuple(to_t(c) for c in g2_to_affine_arrays(pts))
    mags, negs = msm.signed_digit_planes_from_limbs(to_t(std_limbs(ks)), 4)
    got = msm.msm_windowed_signed(G2C, bases, mags, negs, lanes=4, window=4)
    assert [g2_tuple(p) for p in g2_jac_to_host(got)] == [g2_tuple(ref_host.g2_msm(pts, ks))]


def test_msm_narrow_planes_match_host():
    """The narrow class: scalars below 2^11 need only the last 3 planes."""
    n = 40
    pts = g1_case(n, holes=(7,))
    ks = [rng.randrange(1 << 11) for _ in range(n)]
    bases = tuple(to_t(c) for c in g1_to_affine_arrays(pts))
    mags, negs = msm.signed_digit_planes_from_limbs(to_t(std_limbs(ks)), 4)
    assert not mags[:-3].any()
    got = msm.msm_windowed_signed(G1C, bases, mags[-3:], negs[-3:], lanes=16, window=4)
    assert g1_jac_to_host(got) == [ref_host.g1_msm(pts, ks)]


@pytest.mark.slow
def test_msm_g1_matches_jax():
    from zkp2p_tpu.curve.jcurve import G1J, g1_jac_to_host as j_to_host

    n = 70
    pts = g1_case(n, holes=(3,))
    ks = scalars(n)
    jb = g1_to_affine_arrays(pts)
    lim = std_limbs(ks)
    jm, jn = jmsm.signed_digit_planes_from_limbs(jnp.asarray(lim), 4)
    want = jmsm.msm_windowed_signed(G1J, jb, jm, jn, lanes=64, window=4)
    mags, negs = msm.signed_digit_planes_from_limbs(to_t(lim), 4)
    got = msm.msm_windowed_signed(G1C, tuple(to_t(c) for c in jb), mags, negs, lanes=64, window=4)
    # G1 folds its lanes by the same pairwise tree: the Jacobian limbs agree
    assert all(np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64)) for g, w in zip(got, want))
    assert g1_jac_to_host(got) == j_to_host(want)


@pytest.mark.slow
def test_msm_g2_matches_jax():
    """G2 against the JAX function, compared as affine points: the
    reference folds G2 lanes by a scan when its Pallas kernels are not
    armed (as on the CPU) and by the tree otherwise, as the port does."""
    from zkp2p_tpu.curve.jcurve import G2J, g2_jac_to_host as j_to_host

    n = 9
    pts = [ref_host.g2_mul(ref_host.G2_GENERATOR, rng.randrange(1, 1 << 64)) for _ in range(n)]
    pts[2] = None
    ks = scalars(n)
    jb = g2_to_affine_arrays(pts)
    lim = std_limbs(ks)
    jm, jn = jmsm.signed_digit_planes_from_limbs(jnp.asarray(lim), 4)
    want = jmsm.msm_windowed_signed(G2J, jb, jm, jn, lanes=4, window=4)
    mags, negs = msm.signed_digit_planes_from_limbs(to_t(lim), 4)
    got = msm.msm_windowed_signed(G2C, tuple(to_t(c) for c in jb), mags, negs, lanes=4, window=4)
    assert [g2_tuple(p) for p in g2_jac_to_host(got)] == [g2_tuple(p) for p in j_to_host(want)]
