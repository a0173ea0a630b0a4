"""The batch-affine arm's new routes (zkp2p_tpu_torch.ops.msm_affine,
msm_bucket), whose kernels are K15 and K16 on the card, against the old
routes, Python ints, the host curve and the JAX functions.

- batch_inverse_blocked, the kernels' grouping in plain torch, against
  the grid-wide plain route (_batch_inverse_steps), Python pow and JAX's
  batch_inverse, at block sizes 1, 3, 32 and the whole batch, with zero
  lanes (0 out; the global route leaves garbage there by contract),
  counts that are not a power of 2, Fq, Fr and Fq2;
- inv_model, K15's inversion (a binary extended Euclid) over Python
  ints, against Fermat on 0, 1, p-1, R mod p and random values;
- the windowed affine partials through the new route (K6/K8's plain
  tables, the normalisation, the plain accumulate, in chunks) against
  _affine_steps, bit for bit, on the cases of test_torch_affine.py,
  with the global and the blocked inversion;
- the bucket sums of a group of planes as one batch against the old
  route a plane at a time, and the whole bucket MSM against the host.

The JAX twins of the whole MSMs cost one to two minutes of XLA compile
each on the CPU and are `slow`, as their siblings in test_torch_affine.py
and test_torch_bucket.py are.  Integer math: every comparison is exact.
Inputs come from seeded random.Random."""

import random

import jax
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
from zkp2p_tpu_torch.field.bn254 import MONT_R
from zkp2p_tpu_torch.field.tfield import FQ, FQ2, FR, limbs_to_int
from zkp2p_tpu_torch.ops import cuda_affine, cuda_mont, cuda_msm_window, msm, msm_affine, msm_bucket

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

FIELDS = {"fq": (FQ, P), "fr": (FR, R), "fq2": (FQ2, P)}


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def mont(xs, mod) -> torch.Tensor:
    return to_t(np.stack([int_to_limbs(x * MONT_R % mod) for x in xs]))


def inputs(field: str, n: int):
    """n Montgomery elements with zeros at 3 and n-1, 1 at 0 and p-1 at 1
    (Fq2: (1, 0), (p-1, 5) and (0, 0)), and the host values."""
    F, mod = FIELDS[field]
    rng = random.Random(f"{field}-{n}")
    if field == "fq2":
        els = [HostFq2(rng.randrange(P), rng.randrange(1, P)) for _ in range(n)]
        els[0], els[1], els[3], els[n - 1] = HostFq2(1, 0), HostFq2(P - 1, 5), HostFq2(0, 0), HostFq2(0, 0)
        x = torch.stack([mont([e.c0 for e in els], P), mont([e.c1 for e in els], P)], dim=1)
        return F, x, els
    xs = [rng.randrange(1, mod) for _ in range(n)]
    xs[0], xs[1], xs[3], xs[n - 1] = 1, mod - 1, 0, 0
    return F, mont(xs, mod), xs


def to_host(field, t):
    rinv = pow(MONT_R, -1, P if field == "fq2" else FIELDS[field][1])
    if field == "fq2":
        return HostFq2(limbs_to_int(t[0].numpy()) * rinv % P, limbs_to_int(t[1].numpy()) * rinv % P)
    return limbs_to_int(t.numpy()) * rinv % FIELDS[field][1]


# ------------------------------------------------------------ batch inversion


@pytest.mark.parametrize("field,n,block", [
    ("fq", 37, 1), ("fq", 37, 3), ("fq", 37, 32), ("fq", 37, 37), ("fr", 20, 8), ("fr", 20, 20),
    ("fq2", 13, 1), ("fq2", 13, 3), ("fq2", 13, 32), ("fq2", 13, 13),
])
def test_batch_inverse_blocked_matches_global_and_ints(field, n, block):
    F, x, vals = inputs(field, n)
    got = msm_affine.batch_inverse_blocked(F, x, block)
    assert got.shape == x.shape
    glob = msm_affine.batch_inverse(F, x)  # the plain route on a CPU tensor
    zero = F.is_zero(x)
    assert torch.equal(got[~zero], glob[~zero])
    assert not got[zero].any(), "a zero element inverts to 0 in the kernels' grouping"
    for i in (0, 1, 2, n - 2):
        want = vals[i].inv() if field == "fq2" else pow(vals[i], FIELDS[field][1] - 2, FIELDS[field][1])
        got_i = to_host(field, got[i])
        assert (got_i.c0, got_i.c1) == (want.c0, want.c1) if field == "fq2" else got_i == want


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy().astype(np.uint32))


@pytest.mark.parametrize("field", ["fq", "fq2"])
def test_batch_inverse_blocked_matches_jax(field):
    """Equal to the JAX function (called as test_torch_affine.py's JAX twin
    calls it, under one jit) on every slot but its garbage ones."""
    from zkp2p_tpu.field import jfield
    from zkp2p_tpu.ops import msm_affine as jaff

    F, x, _ = inputs(field, 37 if field == "fq" else 13)
    jF = jfield.FQ2 if field == "fq2" else jfield.FQ
    want = np.asarray(jax.jit(lambda v: jaff.batch_inverse(jF, v))(_j(x)))
    got = msm_affine.batch_inverse_blocked(F, x, 4)
    live = (~F.is_zero(x)).numpy()
    assert np.array_equal(got.numpy()[live].astype(np.int64), want[live].astype(np.int64))


@pytest.mark.parametrize("field", ["fq", "fr"])
def test_inversion_model_matches_fermat(field):
    """inv_model, K15's binary extended Euclid over ints: Montgomery in,
    Montgomery out, equal to Fermat (pow(x, p-2, p)) and to K5's plain
    ladder's limbs."""
    F, mod = FIELDS[field]
    rng = random.Random(field)
    vals = [0, 1, mod - 1, MONT_R % mod, 2, (mod + 1) // 2] + [rng.randrange(mod) for _ in range(64)]
    rounds = []
    for v in vals:
        got, k = cuda_affine.inv_model(v * MONT_R % mod, mod)
        assert got == (pow(v, mod - 2, mod) * MONT_R % mod), v
        if v:
            rounds.append(k)
    assert 100 < sum(rounds) / len(rounds) < 400  # about 0.7 a bit of u and v
    x = mont(vals[:8], mod)
    k5 = cuda_mont.mont_pow_plain(F, x, mod - 2)
    assert [cuda_affine.inv_model(limbs_to_int(r), mod)[0] for r in x.numpy()] == [limbs_to_int(r) for r in k5.numpy()]


# ------------------------------------------------------------ windowed MSM


def g1_points(rng, n):
    return [ref_host.g1_mul(ref_host.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]


def _msm_case(case):
    """(g2, points, scalars, lanes, window, planes kept) of one case:
    test_torch_affine.py's, at as few points as keep each special lane
    (random: 2 lane steps; nonpow2_lanes: 7 points on lanes 6 -> 4)."""
    rng = random.Random(f"kernels-{case}")
    if case == "random":
        pts = g1_points(rng, 12)
        ks = [rng.randrange(R) for _ in range(12)]
        pts[2] = None  # infinity base
        ks[3], ks[4], ks[5] = 0, 1, R - 1
        return False, pts, ks, 8, 4, None
    if case == "all_zero":
        return False, g1_points(rng, 8), [0] * 8, 8, 4, None
    if case == "doubling":
        base = ref_host.g1_mul(ref_host.G1_GENERATOR, 12345)
        s = rng.randrange(R)
        return False, [base] * 16, [s] * 16, 8, 4, None
    if case == "cancellation":
        bases = [ref_host.g1_mul(ref_host.G1_GENERATOR, 7 + i) for i in range(8)]
        s = rng.randrange(R)
        return False, bases + [ref_host.g1_neg(p) for p in bases], [s] * 16, 8, 4, None
    if case == "nonpow2_lanes":
        return False, g1_points(rng, 7), [rng.randrange(R) for _ in range(7)], 6, 4, None
    if case == "narrow":  # 3 planes: a 3 x lanes denominator batch
        pts = g1_points(rng, 20)
        pts[6] = None
        return False, pts, [rng.randrange(1 << 11) for _ in range(20)], 8, 4, 3
    if case == "w8":  # one lane step of a 128-entry table
        pts = g1_points(rng, 4)
        pts[1] = None
        return False, pts, [rng.randrange(R) for _ in range(4)], 8, 8, None
    # G2: an infinity base, a zero scalar, an accumulate doubling in step 2
    pts = [ref_host.g2_mul(ref_host.G2_GENERATOR, rng.randrange(1, R)) for _ in range(6)]
    ks = [rng.randrange(R) for _ in range(6)]
    pts[1], ks[2] = None, 0
    pts[4], ks[4] = pts[3], ks[3]
    return True, pts, ks, 4, 4, None


def _planes(ks, window, keep):
    mags, negs = msm.signed_digit_planes_from_limbs(to_t(np.stack([int_to_limbs(k) for k in ks])), window)
    if keep:
        assert not mags[:-keep].any()
        mags, negs = mags[-keep:], negs[-keep:]
    return mags, negs


def _lane_inputs(case):
    g2, pts, ks, lanes, window, keep = _msm_case(case)
    curve = G2C if g2 else G1C
    bases = tuple(to_t(c) for c in (g2_to_affine_arrays if g2 else g1_to_affine_arrays)(pts))
    mags, negs = _planes(ks, window, keep)
    lanes = msm_affine._pow2_floor(min(lanes, len(pts)))
    pad = (-len(pts)) % lanes
    steps = (len(pts) + pad) // lanes
    elem = curve.elem
    pb = tuple(torch.nn.functional.pad(c, [0, 0] * len(elem) + [0, pad]).reshape((steps, lanes) + elem)
               for c in bases)
    planes = tuple(torch.nn.functional.pad(t, [0, pad]).reshape(t.shape[0], steps, lanes) for t in (mags, negs))
    return curve, pb, planes, window, (g2, pts, ks, bases, mags, negs, lanes)


CASES = ["random", "all_zero", "doubling", "cancellation", "nonpow2_lanes", "narrow", "w8", "g2"]


@pytest.mark.parametrize("case,inversion", [(c, "global") for c in CASES]
                         + [(c, "blocked") for c in ("random", "cancellation", "narrow", "g2")])
def test_affine_partials_new_route_match_steps(case, inversion, monkeypatch):
    """The partials of the chunked route (tables by K6/K8's plain
    version, normalised, accumulated a chunk at a time; a chunk of one
    step, so that every chunk boundary is crossed) equal _affine_steps'
    (K3 tables, a step at a time) bit for bit, with the global batch
    inversion or the kernels' grouping (blocks of 4)."""
    curve, pts, (mags, negs), window, _ = _lane_inputs(case)
    monkeypatch.setattr(cuda_msm_window, "TABLE_BUDGET_BYTES", 1)
    want = msm_affine._affine_steps(curve, pts, mags, negs, window)
    if inversion == "blocked":
        monkeypatch.setattr(msm_affine, "_batch_inverse_steps",
                            lambda F, x: msm_affine.batch_inverse_blocked(F, x, 4))
    got = msm_affine._affine_chunked(curve, pts, mags, negs, window)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", ["random", "g2"])
def test_msm_windowed_affine_new_route_matches_host(case):
    _, _, _, _, (g2, pts, ks, bases, mags, negs, lanes) = _lane_inputs(case)
    got = msm_affine.msm_windowed_affine(G2C if g2 else G1C, bases, mags, negs, lanes=lanes, window=4)
    if g2:
        want = ref_host.g2_msm(pts, ks)
        assert [tuple((c.c0, c.c1) for c in p) for p in g2_jac_to_host(got)] == [tuple((c.c0, c.c1) for c in want)]
    else:
        assert g1_jac_to_host(got) == [ref_host.g1_msm(pts, ks)]


@pytest.mark.slow
@pytest.mark.parametrize("case", ["random", "g2"])
def test_msm_windowed_affine_new_route_matches_jax(case):
    from zkp2p_tpu.curve.jcurve import G1J, G2J
    from zkp2p_tpu.curve.jcurve import g1_jac_to_host as j1_to_host
    from zkp2p_tpu.curve.jcurve import g2_jac_to_host as j2_to_host
    from zkp2p_tpu.ops import msm as jmsm
    from zkp2p_tpu.ops import msm_affine as jaff

    _, _, _, _, (g2, pts, ks, bases, mags, negs, lanes) = _lane_inputs(case)
    jb = (g2_to_affine_arrays if g2 else g1_to_affine_arrays)(pts)
    jm, jn = jmsm.signed_digit_planes_from_limbs(jnp.asarray(np.stack([int_to_limbs(k) for k in ks])), 4)
    want = jaff.msm_windowed_affine(G2J if g2 else G1J, jb, jm, jn, lanes=lanes, window=4)
    got = msm_affine.msm_windowed_affine(G2C if g2 else G1C, bases, mags, negs, lanes=lanes, window=4)
    if g2:
        assert ([tuple((c.c0, c.c1) for c in p) for p in g2_jac_to_host(got)]
                == [tuple((c.c0, c.c1) for c in p) for p in j2_to_host(want)])
    else:
        assert g1_jac_to_host(got) == j1_to_host(want)


# ------------------------------------------------------------ bucket MSM


def _bucket_inputs():
    """8 points (an infinity base, a pair P, -P, a repeat) with scalars
    below 2^11: the last 3 of the w = 4 planes carry every digit."""
    rng = random.Random("kernels-bucket")
    pts = g1_points(rng, 7)
    pts[2] = None
    pts[4] = ref_host.g1_neg(pts[3])
    pts[6] = pts[5]
    ks = [rng.randrange(1 << 11) for _ in range(7)]
    ks[4] = ks[3]
    ks[6] = ks[5]
    bases = tuple(to_t(c) for c in g1_to_affine_arrays(pts))
    mags, negs = _planes(ks, 4, 3)
    return pts, ks, bases, mags, negs


def test_bucket_group_sums_match_per_plane():
    """The grouped route's bucket sums of 3 planes (as one batch) equal
    the old route's a plane at a time, bit for bit."""
    _, _, (bx, by), mags, negs = _bucket_inputs()
    pad = 1
    bx, by = (torch.nn.functional.pad(c, (0, 0, 0, pad)) for c in (bx, by))
    mags, negs = (torch.nn.functional.pad(t, (0, pad)) for t in (mags, negs))
    base_inf = FQ.is_zero(bx) & FQ.is_zero(by)
    byy = torch.cat([by, FQ.neg(by)])
    got = msm_bucket._group_sums(FQ, bx, byy, base_inf, mags, negs, 4)
    want = msm_bucket._plane_sums(FQ, bx, byy, base_inf, mags, negs, 4)
    assert got[0].shape == (3, 16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("group", [2, 16])
def test_msm_bucket_affine_grouped_matches_host(group, monkeypatch):
    """Groups of 2 planes (3 planes: a group and a remainder) and one
    group of all: the MSM equals the host's."""
    pts, ks, bases, mags, negs = _bucket_inputs()
    monkeypatch.setattr(msm_bucket, "PLANE_GROUP", group)
    got = msm_bucket.msm_bucket_affine(G1C, bases, mags, negs, window=4)
    assert g1_jac_to_host(got) == [ref_host.g1_msm(pts, ks)]


@pytest.mark.slow
def test_msm_bucket_affine_grouped_matches_jax():
    from zkp2p_tpu.curve.jcurve import G1J
    from zkp2p_tpu.curve.jcurve import g1_jac_to_host as j1_to_host
    from zkp2p_tpu.ops import msm as jmsm
    from zkp2p_tpu.ops import msm_bucket as jbucket

    pts, ks, bases, mags, negs = _bucket_inputs()
    jm, jn = jmsm.signed_digit_planes_from_limbs(jnp.asarray(np.stack([int_to_limbs(k) for k in ks])), 4)
    want = jbucket.msm_bucket_affine(G1J, g1_to_affine_arrays(pts), jm[-3:], jn[-3:], window=4)
    got = msm_bucket.msm_bucket_affine(G1C, bases, mags, negs, window=4)
    assert g1_jac_to_host(got) == j1_to_host(want)
