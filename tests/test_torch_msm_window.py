"""The G1 window kernels' plain versions (zkp2p_tpu_torch.ops.cuda_msm_window:
K6 table, K7 accumulate) and the chunked G1 accumulate of
zkp2p_tpu_torch.ops.msm, compared exactly (equal limbs): the table against
from_affine plus chained K3-plain add_mixed and the host curve; the
chunked accumulate against the step loop it replaces (_accumulate_steps)
on the (n_digits, lanes) partials, with chunks that do not divide the
steps, the narrow class, negative and e = 16 digits, infinity bases and
the doubling and inverse branches; the whole MSM against the host oracle
and, in the slow tier, against the JAX function."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zkp2p_tpu.curve import host as ref_host
from zkp2p_tpu.curve.jcurve import g1_to_affine_arrays
from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.field.jfield import int_to_limbs
from zkp2p_tpu.ops import msm as jmsm

from zkp2p_tpu_torch.curve.tcurve import G1C, g1_jac_to_host
from zkp2p_tpu_torch.ops import cuda_msm_window, msm

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

rng = random.Random(4321)
N_TABLE = 8  # window 4


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def points(n, holes=()):
    pts = [ref_host.g1_mul(ref_host.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    for h in holes:
        pts[h] = None
    return pts


def planes_of(ks):
    lim = np.stack([int_to_limbs(k) for k in ks])
    return msm.signed_digit_planes_from_limbs(to_t(lim), 4)


def equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture
def chunk_of(monkeypatch):
    """Set the table budget so that a chunk holds `steps` lane steps."""

    def set_chunk(steps, lanes):
        monkeypatch.setattr(cuda_msm_window, "TABLE_BUDGET_BYTES", steps * 3 * N_TABLE * lanes * 64)
        assert cuda_msm_window.chunk_steps(lanes, N_TABLE) == steps

    return set_chunk


def test_table_plain_matches_from_affine_and_k3_chain():
    T, lanes = 3, 5
    pts = points(T * lanes, holes=(0, 7, 14))
    pts[3] = pts[4]  # a repeated base
    x, y = (to_t(c).reshape(T, lanes, 16) for c in g1_to_affine_arrays(pts))
    got = cuda_msm_window.g1_window_table((x, y), N_TABLE)
    assert all(c.shape == (T, N_TABLE, lanes, 16) and c.dtype == torch.int32 for c in got)
    entry = G1C.from_affine((x, y))
    for k in range(N_TABLE):
        if k:
            entry = G1C.add_mixed(entry, (x, y))
        assert equal(tuple(c[:, k] for c in got), entry)
    # against the host curve: entry k of base P is (k+1)P
    for t, l, k in ((0, 1, 0), (1, 2, 6), (2, 3, 7), (0, 0, 5), (1, 4, 1)):
        P = pts[t * lanes + l]
        want = None if P is None else ref_host.g1_mul(P, k + 1)
        assert g1_jac_to_host(tuple(c[t, k, l] for c in got)) == [want]


def _padded(pts, mags, negs, lanes):
    """Bases and planes as _windowed lays them out: (steps, lanes) and
    (n_digits, steps, lanes), padded with (0, 0) bases and zero digits."""
    n = len(pts)
    pad = (-n) % lanes
    steps = (n + pad) // lanes
    bases = tuple(F.pad(to_t(c), [0, 0, 0, pad]).reshape(steps, lanes, 16) for c in g1_to_affine_arrays(pts))
    nd = mags.shape[0]
    return bases, F.pad(mags, [0, pad]).reshape(nd, steps, lanes), F.pad(negs, [0, pad]).reshape(nd, steps, lanes)


def _crafted(lanes=6, steps=5, nd=4):
    """Digits chosen by hand: negative digits, e = 16 (magnitude 0 with
    the sign set), infinity bases; lane 0 adds P to P (doubling branch),
    lane 1 adds -P to P (to infinity)."""
    pts = points(lanes * steps, holes=(2, 9, 15))
    pts[lanes + 0] = pts[0]  # step 1, lane 0: the base of step 0
    pts[lanes + 1] = pts[1]
    g = np.random.default_rng(7)
    mags = g.integers(0, N_TABLE + 1, size=(nd, steps * lanes)).astype(np.int32)
    negs = g.integers(0, 2, size=(nd, steps * lanes)).astype(bool)
    mags[:, :3] = 0  # digit rows start at infinity in lanes 0-2
    mags[:, 4] = 0
    negs[:, 4] = True  # e = 16 at step 0, lane 4
    # row 0: lane 0 adds 3P at steps 0 and 1 (2 * 3P by the doubling),
    # lane 1 adds 5P and then -5P (infinity)
    mags[0, 0] = mags[0, lanes] = 3
    negs[0, 0] = negs[0, lanes] = False
    mags[0, 1] = mags[0, lanes + 1] = 5
    negs[0, 1], negs[0, lanes + 1] = False, True
    mags[0, 2 * lanes::lanes] = mags[0, 2 * lanes + 1::lanes] = 0  # and nothing after
    return pts, torch.from_numpy(mags), torch.from_numpy(negs)


def _case(name):
    if name == "full":  # 64 planes of full scalars, n = 37 over 8 lanes
        pts = points(37, holes=(3, 36))
        ks = [rng.randrange(R) for _ in range(37)]
        ks[0], ks[1], ks[2] = 0, 1, R - 1
        mags, negs = planes_of(ks)
        return pts, mags, negs, 8
    if name == "narrow":  # the narrow class: scalars < 2^11, the last 3 planes
        pts = points(40, holes=(7,))
        mags, negs = planes_of([rng.randrange(1 << 11) for _ in range(40)])
        assert not mags[:-3].any()
        return pts, mags[-3:], negs[-3:], 16
    pts, mags, negs = _crafted()
    return pts, mags, negs, 6


@pytest.mark.parametrize("name,chunk", [("full", 2), ("full", 3), ("narrow", 2), ("crafted", 2), ("crafted", 5)])
def test_chunked_accumulate_matches_step_loop(name, chunk, chunk_of):
    pts, mags, negs, lanes = _case(name)
    bases, planes, neg_t = _padded(pts, mags, negs, lanes)
    chunk_of(chunk, lanes)
    got = msm._accumulate_g1(G1C, bases, planes, neg_t, 4)
    want = msm._accumulate_steps(G1C, bases, planes, neg_t, 4)
    assert equal(got, want)
    if name == "crafted":
        # the special lanes took their branches: 2 * 3P, and P - P
        host = g1_jac_to_host(tuple(c[0, :2] for c in got))
        assert host[0] == ref_host.g1_mul(pts[0], 6)
        assert host[1] is None and not got[2][0, 1].any()


def test_accumulate_plain_reads_planes_at_an_offset():
    pts, mags, negs = _crafted()
    bases, planes, neg_t = _padded(pts, mags, negs, 6)
    table = cuda_msm_window.g1_window_table((bases[0][2:4], bases[1][2:4]), N_TABLE)
    acc = G1C.infinity((4, 6), "cpu")
    got = cuda_msm_window.g1_window_accumulate(acc, table, planes, neg_t, 2)
    want = msm._accumulate_steps(G1C, (bases[0][2:4], bases[1][2:4]), planes[:, 2:4], neg_t[:, 2:4], 4)
    assert equal(got, want)


@pytest.mark.parametrize("n,lanes,chunk", [(70, 16, 2), (37, 8, 4)])
def test_msm_g1_chunked_matches_host(n, lanes, chunk, chunk_of):
    pts = points(n, holes=(3, n - 1))
    ks = [rng.randrange(R) for _ in range(n)]
    ks[0], ks[1], ks[2] = 0, 1, R - 1
    mags, negs = planes_of(ks)
    chunk_of(chunk, lanes)
    got = msm.msm_windowed_signed(G1C, tuple(to_t(c) for c in g1_to_affine_arrays(pts)), mags, negs,
                                  lanes=lanes, window=4)
    assert g1_jac_to_host(got) == [ref_host.g1_msm(pts, ks)]


@pytest.mark.slow
def test_msm_g1_chunked_matches_jax(chunk_of):
    from zkp2p_tpu.curve.jcurve import G1J

    n, lanes = 70, 16
    pts = points(n, holes=(3,))
    ks = [rng.randrange(R) for _ in range(n)]
    jb = g1_to_affine_arrays(pts)
    lim = np.stack([int_to_limbs(k) for k in ks])
    jm, jn = jmsm.signed_digit_planes_from_limbs(jnp.asarray(lim), 4)
    want = jmsm.msm_windowed_signed(G1J, jb, jm, jn, lanes=lanes, window=4)
    chunk_of(2, lanes)
    mags, negs = msm.signed_digit_planes_from_limbs(to_t(lim), 4)
    got = msm.msm_windowed_signed(G1C, tuple(to_t(c) for c in jb), mags, negs, lanes=lanes, window=4)
    assert all(np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64)) for g, w in zip(got, want))
