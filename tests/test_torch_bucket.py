"""The port's sorted-prefix bucket MSM (zkp2p_tpu_torch.ops.msm_bucket)
against the host curve (zkp2p_tpu.curve.host) and, in the slow tier, the
JAX functions of zkp2p_tpu.ops.msm_bucket.

The affine inclusive prefix sums with an infinity point mid-stream,
duplicates and a negated pair; the affine tree; the whole bucket MSM at
w = 4 with an infinity base, a zero scalar and forced doubling and
P + (-P) in the prefix tree.  test_torch_bucket_w8.py holds the w = 8
cases (a padded point count, all-zero scalars); the prover's w = 16 runs
in test_torch_prover_arms.py.

On the CPU every batch inversion is a 363-product plain ladder, and a
bucket MSM takes (256/w) * (2 log2 n + w) of them, so these MSMs are
kept small and spread over files that run in parallel.  Integer math:
every comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.curve import host as ref_host
from zkp2p_tpu.curve.jcurve import g1_to_affine_arrays
from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.field.jfield import int_to_limbs

from zkp2p_tpu_torch.curve.tcurve import G1C, g1_jac_to_host
from zkp2p_tpu_torch.field.tfield import FQ
from zkp2p_tpu_torch.ops import msm, msm_bucket

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def planes(ks, window):
    return msm.signed_digit_planes_from_limbs(to_t(np.stack([int_to_limbs(k) for k in ks])), window)


def g1_points(rng, n):
    return [ref_host.g1_mul(ref_host.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]


def affine_triple(pts):
    x, y = (to_t(c) for c in g1_to_affine_arrays(pts))
    return x, y, torch.tensor([p is None for p in pts])


def triple_to_host(t):
    x, y, inf = t
    out = []
    for i in range(x.shape[0]):
        if bool(inf[i]):
            assert not x[i].any() and not y[i].any(), "an infinity lane must carry (0, 0)"
            out.append(None)
        else:
            out.append((FQ.from_mont_host(x[i].numpy()), FQ.from_mont_host(y[i].numpy())))
    return out


def _prefix_case():
    rng = random.Random(41)
    pts = g1_points(rng, 8)
    pts[3] = None  # infinity mid-stream
    pts[5] = pts[4]  # the pair (4, 5) doubles
    pts[7] = ref_host.g1_neg(pts[6])  # the pair (6, 7) cancels
    return pts


def test_affine_prefix_incl_matches_host():
    pts = _prefix_case()
    got = triple_to_host(msm_bucket.affine_prefix_incl(FQ, affine_triple(pts)))
    acc = None
    for i, p in enumerate(pts):
        acc = ref_host.g1_add(acc, p)
        assert got[i] == acc, f"prefix {i}"


def test_affine_tree_reduce_matches_host():
    pts = _prefix_case()
    got = msm_bucket.affine_tree_reduce(FQ, affine_triple(pts))
    want = None
    for p in pts:
        want = ref_host.g1_add(want, p)
    assert triple_to_host(tuple(c[None] for c in got)) == [want]


def bucket_case(case):
    """(points, scalars, window) of one bucket-MSM case."""
    rng = random.Random(f"bucket-{case}")
    if case == "w4":
        # the same scalar on P, P and -P: in every plane they share a
        # digit, so the sorted prefix meets P + (-P) in a pair and P + P
        # one level up; the infinity base carries a zero scalar
        p = ref_host.g1_mul(ref_host.G1_GENERATOR, rng.randrange(1, R))
        s = rng.randrange(R)
        return [None, p, p, ref_host.g1_neg(p)], [0, s, s, s], 4
    if case == "w8":
        # 3 points, padded to 4
        return g1_points(rng, 3), [rng.randrange(R), R - 1, 1], 8
    return g1_points(rng, 1), [0], 8  # all-zero scalars


def check_bucket_case(case):
    pts, ks, window = bucket_case(case)
    bases = tuple(to_t(c) for c in g1_to_affine_arrays(pts))
    mags, negs = planes(ks, window)
    got = msm_bucket.msm_bucket_affine(G1C, bases, mags, negs, window=window)
    assert g1_jac_to_host(got) == [ref_host.g1_msm(pts, ks)]


def test_msm_bucket_affine_w4_matches_host():
    check_bucket_case("w4")


def test_msm_bucket_affine_is_g1_only():
    from zkp2p_tpu_torch.curve.tcurve import G2C

    z = torch.zeros(2, 2, 16, dtype=torch.int32)
    m = torch.zeros(16, 2, dtype=torch.int32)
    with pytest.raises(AssertionError, match="G1-only"):
        msm_bucket.msm_bucket_affine(G2C, (z, z), m, m.bool(), window=16)


# ---------------------------------------------- against the JAX functions


@pytest.mark.slow
def test_affine_prefix_incl_matches_jax():
    from zkp2p_tpu.field import jfield
    from zkp2p_tpu.ops import msm_bucket as jbucket

    pts = _prefix_case()
    x, y, inf = affine_triple(pts)
    got = msm_bucket.affine_prefix_incl(FQ, (x, y, inf))
    want = jbucket.affine_prefix_incl(
        jfield.FQ, (jnp.asarray(x.numpy().astype(np.uint32)), jnp.asarray(y.numpy().astype(np.uint32)),
                    jnp.asarray(inf.numpy())))
    assert all(np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64)) for g, w in zip(got, want))


@pytest.mark.slow
def test_msm_bucket_affine_matches_jax():
    """w=4 against the JAX function, compared as affine points."""
    from zkp2p_tpu.curve.jcurve import G1J
    from zkp2p_tpu.curve.jcurve import g1_jac_to_host as j_to_host
    from zkp2p_tpu.ops import msm as jmsm
    from zkp2p_tpu.ops import msm_bucket as jbucket

    pts, ks, _ = bucket_case("w4")
    jb = g1_to_affine_arrays(pts)
    jm, jn = jmsm.signed_digit_planes_from_limbs(jnp.asarray(np.stack([int_to_limbs(k) for k in ks])), 4)
    want = jbucket.msm_bucket_affine(G1J, jb, jm, jn, window=4)
    mags, negs = planes(ks, 4)
    got = msm_bucket.msm_bucket_affine(G1C, tuple(to_t(c) for c in jb), mags, negs, window=4)
    assert g1_jac_to_host(got) == j_to_host(want)
