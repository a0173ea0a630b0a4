"""The port's batch-affine MSM tier (zkp2p_tpu_torch.ops.msm_affine)
against host integers, the host curve (zkp2p_tpu.curve.host) and, in the
slow tier, the JAX functions of zkp2p_tpu.ops.msm_affine.

Covers the batch inversion (zero lanes, whose slots are garbage by
contract and skipped; the Fq2 norm route; counts that are not a power of
2), the Jacobian -> affine normalisation with infinity, the complete
affine add on every exceptional lane, and the windowed MSM with the
affine accumulate: first adds, infinity bases and zero digits, forced
accumulate doubling, forced P + (-P), an n that is not a multiple of the
lanes and lanes that are not a power of 2, G1 and G2.  Integer math:
every comparison is exact.  Inputs come from a seeded random.Random."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.curve import host as ref_host
from zkp2p_tpu.curve.jcurve import g1_to_affine_arrays, g2_to_affine_arrays
from zkp2p_tpu.field.bn254 import P, R
from zkp2p_tpu.field.jfield import int_to_limbs
from zkp2p_tpu.field.tower import Fq2 as HostFq2

from zkp2p_tpu_torch.curve.tcurve import G1C, G2C, g1_jac_to_host, g2_jac_to_host
from zkp2p_tpu_torch.field.tfield import FQ, FQ2
from zkp2p_tpu_torch.ops import msm, msm_affine

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def fq_mont(xs) -> torch.Tensor:
    return to_t(np.stack([FQ.to_mont_host(x % P) for x in xs]))


def fq2_mont(els) -> torch.Tensor:
    return to_t(np.stack([np.stack([FQ.to_mont_host(e.c0), FQ.to_mont_host(e.c1)]) for e in els]))


def fq_int(t: torch.Tensor) -> int:
    return FQ.from_mont_host(t.numpy())


def planes(ks, window):
    return msm.signed_digit_planes_from_limbs(to_t(np.stack([int_to_limbs(k) for k in ks])), window)


def g2_tuple(p):
    return None if p is None else tuple((c.c0, c.c1) for c in p)


def g1_points(rng, n):
    return [ref_host.g1_mul(ref_host.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]


def affine_triple(pts):
    """Host G1 points -> (x, y, is_inf) limb tensors; None -> (0, 0, True)."""
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
            out.append((fq_int(x[i]), fq_int(y[i])))
    return out


# -------------------------------------------------- batch inversion, tier 1


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
def test_excl_prefix_mul_matches_ints(seeded):
    rng = random.Random(11 + seeded)
    xs = [rng.randrange(1, P) for _ in range(16)]
    seed = rng.randrange(1, P) if seeded else 1
    out = msm_affine.excl_prefix_mul(FQ, fq_mont(xs), fq_mont([seed])[0])
    acc = seed
    for i, x in enumerate(xs):
        assert fq_int(out[i]) == acc
        acc = acc * x % P


@pytest.mark.parametrize("n", [32, 5], ids=["pow2", "padded"])
def test_batch_inverse_with_zero_lanes_matches_ints(n):
    """Zero lanes leave garbage in their own slots only; a count that is
    not a power of 2 (the 3-plane narrow class) pads with ones."""
    rng = random.Random(n)
    xs = [rng.randrange(1, P) for _ in range(n)]
    xs[3] = 0
    xs[n - 1] = 0
    out = msm_affine.batch_inverse(FQ, fq_mont(xs))
    assert out.shape == (n, 16)
    for i, x in enumerate(xs):
        if x:
            assert fq_int(out[i]) == pow(x, P - 2, P)


def test_batch_inverse_fq2_norm_route_matches_host():
    rng = random.Random(12)
    els = [HostFq2(rng.randrange(1, P), rng.randrange(P)) for _ in range(8)]
    els[5] = HostFq2(0, 0)  # garbage slot by contract
    out = msm_affine.batch_inverse(FQ2, fq2_mont(els))
    for i, e in enumerate(els):
        if e.c0 == 0 and e.c1 == 0:
            continue
        inv = e.inv()
        assert (fq_int(out[i, 0]), fq_int(out[i, 1])) == (inv.c0, inv.c1)


def test_jac_to_affine_batch_with_infinity_matches_host():
    rng = random.Random(13)
    pts = g1_points(rng, 8)
    pts[2] = pts[5] = None
    x, y, inf = affine_triple(pts)
    # scale each point by a random Z so the normalisation really divides
    z = fq_mont([rng.randrange(1, P) for _ in range(8)])
    z = torch.where(inf[:, None], torch.zeros_like(z), z)
    z2 = FQ.square(z)
    jac = (FQ.mul(x, z2), FQ.mul(y, FQ.mul(z2, z)), z)
    ax, ay = msm_affine.jac_to_affine_batch(FQ, jac)
    assert torch.equal(ax, x) and torch.equal(ay, y)


def test_affine_add_complete_every_case_matches_host():
    """Random pairs, P + P, P + (-P), inf + Q, P + inf and inf + inf,
    over a 2-D batch whose flattened count (6) is not a power of 2."""
    rng = random.Random(14)
    ps = g1_points(rng, 6)
    qs = g1_points(rng, 6)
    qs[1] = ps[1]  # doubling
    qs[2] = ref_host.g1_neg(ps[2])  # cancellation
    ps[3] = None
    qs[4] = None
    ps[5] = qs[5] = None
    a, b = affine_triple(ps), affine_triple(qs)
    shaped = [tuple(c.reshape((2, 3) + c.shape[1:]) for c in t) for t in (a, b)]
    got = msm_affine.affine_add_complete(FQ, *shaped)
    assert got[0].shape == (2, 3, 16) and got[2].shape == (2, 3)
    flat = tuple(c.reshape((6,) + c.shape[2:]) for c in got)
    assert triple_to_host(flat) == [ref_host.g1_add(p, q) for p, q in zip(ps, qs)]


# ------------------------------------------------- windowed MSM, tier 1


def _g1_msm_case(case):
    rng = random.Random(f"g1-{case}")
    if case == "random":
        pts = g1_points(rng, 23)
        ks = [rng.randrange(R) for _ in range(23)]
        pts[2] = None  # infinity base (pruned-key hole)
        ks[3] = 0  # zero scalar
        ks[4], ks[5] = 1, R - 1
        return pts, ks, 8
    if case == "all_zero":
        return g1_points(rng, 8), [0] * 8, 8
    if case == "doubling":
        # the same base and scalar in two lane steps: the second step adds
        # a point equal to the accumulator
        base = ref_host.g1_mul(ref_host.G1_GENERATOR, 12345)
        s = rng.randrange(R)
        return [base] * 16, [s] * 16, 8
    if case == "cancellation":
        # step 2 adds the negation of step 1's points with the same
        # digits: accumulator + (-accumulator), then recovery from infinity
        bases = [ref_host.g1_mul(ref_host.G1_GENERATOR, 7 + i) for i in range(8)]
        neg = [ref_host.g1_neg(p) for p in bases]
        s = rng.randrange(R)
        return bases + neg + g1_points(rng, 8), [s] * 16 + [rng.randrange(R) for _ in range(8)], 8
    # lanes=6 rounds down to 4; n=13 is not a multiple of either
    return g1_points(rng, 13), [rng.randrange(R) for _ in range(13)], 6


@pytest.mark.parametrize("case", ["random", "all_zero", "doubling", "cancellation", "nonpow2_lanes"])
def test_msm_windowed_affine_g1_matches_host(case):
    pts, ks, lanes = _g1_msm_case(case)
    bases = tuple(to_t(c) for c in g1_to_affine_arrays(pts))
    mags, negs = planes(ks, 4)
    got = msm_affine.msm_windowed_affine(G1C, bases, mags, negs, lanes=lanes, window=4)
    assert g1_jac_to_host(got) == [ref_host.g1_msm(pts, ks)]


def test_msm_windowed_affine_g1_w8_matches_host():
    rng = random.Random(15)
    pts = g1_points(rng, 10)
    ks = [rng.randrange(R) for _ in range(10)]
    pts[1] = None
    ks[2] = 0
    bases = tuple(to_t(c) for c in g1_to_affine_arrays(pts))
    mags, negs = planes(ks, 8)
    got = msm_affine.msm_windowed_affine(G1C, bases, mags, negs, lanes=8, window=8)
    assert g1_jac_to_host(got) == [ref_host.g1_msm(pts, ks)]


def test_msm_windowed_affine_g2_matches_host():
    """G2 over Fq2: the norm-route inversion and the same add formulas."""
    rng = random.Random(16)
    n = 6
    pts = [ref_host.g2_mul(ref_host.G2_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    ks = [rng.randrange(R) for _ in range(n)]
    pts[1] = None
    ks[2] = 0
    pts[4], ks[4] = pts[3], ks[3]  # an accumulate doubling in step 2 (lanes=4)
    bases = tuple(to_t(c) for c in g2_to_affine_arrays(pts))
    mags, negs = planes(ks, 4)
    got = msm_affine.msm_windowed_affine(G2C, bases, mags, negs, lanes=4, window=4)
    assert [g2_tuple(p) for p in g2_jac_to_host(got)] == [g2_tuple(ref_host.g2_msm(pts, ks))]


def test_narrow_planes_pad_the_batch_inverse():
    """The narrow class: 3 digit planes, so each step's denominator batch
    (3 x lanes) is not a power of 2 and the batch inversion pads."""
    rng = random.Random(17)
    pts = g1_points(rng, 20)
    pts[6] = None
    ks = [rng.randrange(1 << 11) for _ in range(20)]
    mags, negs = planes(ks, 4)
    assert not mags[:-3].any()
    bases = tuple(to_t(c) for c in g1_to_affine_arrays(pts))
    got = msm_affine.msm_windowed_affine(G1C, bases, mags[-3:], negs[-3:], lanes=8, window=4)
    assert g1_jac_to_host(got) == [ref_host.g1_msm(pts, ks)]


# ---------------------------------------------- against the JAX functions


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().astype(np.int64), np.asarray(j).astype(np.int64))


@pytest.mark.slow
@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
def test_excl_prefix_mul_matches_jax(seeded):
    from zkp2p_tpu.field import jfield
    from zkp2p_tpu.ops import msm_affine as jaff

    rng = random.Random(21 + seeded)
    x = fq_mont([rng.randrange(1, P) for _ in range(16)])
    seed = fq_mont([rng.randrange(1, P) if seeded else 1])[0]
    assert _same(msm_affine.excl_prefix_mul(FQ, x, seed), jaff.excl_prefix_mul(jfield.FQ, _j(x), _j(seed)))


@pytest.mark.slow
def test_batch_inverse_matches_jax():
    """Equal to the JAX function on every slot but the garbage ones (zero
    inputs), for Fq with zero lanes, a padded count and the Fq2 norm
    route."""
    from zkp2p_tpu.field import jfield
    from zkp2p_tpu.ops import msm_affine as jaff

    rng = random.Random(22)
    for n in (32, 5):
        xs = [rng.randrange(1, P) for _ in range(n)]
        xs[3] = 0
        x = fq_mont(xs)
        live = torch.tensor([v != 0 for v in xs])
        got = msm_affine.batch_inverse(FQ, x)
        want = np.asarray(jaff.batch_inverse(jfield.FQ, _j(x)))
        assert _same(got[live], want[live.numpy()])
    els = [HostFq2(rng.randrange(1, P), rng.randrange(P)) for _ in range(8)]
    els[5] = HostFq2(0, 0)
    z = fq2_mont(els)
    live = torch.tensor([not (e.c0 == 0 and e.c1 == 0) for e in els])
    got = msm_affine.batch_inverse(FQ2, z)
    want = np.asarray(jaff.batch_inverse(jfield.FQ2, _j(z)))
    assert _same(got[live], want[live.numpy()])


@pytest.mark.slow
def test_jac_to_affine_and_affine_add_match_jax():
    from zkp2p_tpu.field import jfield
    from zkp2p_tpu.ops import msm_affine as jaff

    rng = random.Random(23)
    pts = g1_points(rng, 8)
    pts[2] = None
    x, y, inf = affine_triple(pts)
    z = fq_mont([rng.randrange(1, P) for _ in range(8)])
    z = torch.where(inf[:, None], torch.zeros_like(z), z)
    jac = (FQ.mul(x, FQ.square(z)), FQ.mul(y, FQ.mul(FQ.square(z), z)), z)
    got = msm_affine.jac_to_affine_batch(FQ, jac)
    want = jaff.jac_to_affine_batch(jfield.FQ, tuple(_j(c) for c in jac))
    assert all(_same(g, w) for g, w in zip(got, want))

    qs = g1_points(rng, 8)
    qs[1] = pts[1]
    qs[3] = ref_host.g1_neg(pts[3])
    qs[5] = None
    a, b = affine_triple(pts), affine_triple(qs)
    got = msm_affine.affine_add_complete(FQ, a, b)
    want = jaff.affine_add_complete(
        jfield.FQ, (_j(a[0]), _j(a[1]), jnp.asarray(a[2].numpy())), (_j(b[0]), _j(b[1]), jnp.asarray(b[2].numpy()))
    )
    assert all(_same(g, w) for g, w in zip(got, want))


@pytest.mark.slow
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_windowed_affine_matches_jax(g2):
    """Compared as affine points: the Jacobian limbs of the result depend
    on the lane fold, which the reference picks per backend."""
    from zkp2p_tpu.curve.jcurve import G1J, G2J
    from zkp2p_tpu.curve.jcurve import g1_jac_to_host as j1_to_host
    from zkp2p_tpu.curve.jcurve import g2_jac_to_host as j2_to_host
    from zkp2p_tpu.ops import msm as jmsm
    from zkp2p_tpu.ops import msm_affine as jaff

    rng = random.Random(24 + g2)
    n = 6 if g2 else 13
    if g2:
        pts = [ref_host.g2_mul(ref_host.G2_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    else:
        pts = g1_points(rng, n)
    pts[1] = None
    ks = [rng.randrange(R) for _ in range(n)]
    ks[2] = 0
    jb = (g2_to_affine_arrays if g2 else g1_to_affine_arrays)(pts)
    lim = jnp.asarray(np.stack([int_to_limbs(k) for k in ks]))
    jm, jn = jmsm.signed_digit_planes_from_limbs(lim, 4)
    want = jaff.msm_windowed_affine(G2J if g2 else G1J, jb, jm, jn, lanes=4, window=4)
    mags, negs = planes(ks, 4)
    got = msm_affine.msm_windowed_affine(G2C if g2 else G1C, tuple(to_t(c) for c in jb), mags, negs,
                                         lanes=4, window=4)
    if g2:
        assert [g2_tuple(p) for p in g2_jac_to_host(got)] == [g2_tuple(p) for p in j2_to_host(want)]
    else:
        assert g1_jac_to_host(got) == j1_to_host(want)
