"""The window kernels' plain versions (zkp2p_tpu_torch.ops.cuda_msm_window:
K6/K8 table, K7/K9 accumulate, over G1 and G2) and the chunked accumulate
of zkp2p_tpu_torch.ops.msm, compared exactly (equal limbs), with G1 and
G2 as cases of the same tests: the table against from_affine plus
chained K3-plain add_mixed and the host curve; the chunked accumulate
against the step loop it replaces (_accumulate_steps) on the
(n_digits, lanes) partials, with chunks that do not divide the steps,
the narrow class, negative and e = 16 digits, infinity bases and the
doubling and inverse branches; the whole MSM against the host oracle
and, in the slow tier, against the JAX function (G2 as affine points:
the reference folds G2 lanes by a scan on the CPU)."""

import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zkp2p_tpu.curve import host as ref_host
from zkp2p_tpu.curve.jcurve import g1_to_affine_arrays, g2_to_affine_arrays
from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.field.jfield import int_to_limbs
from zkp2p_tpu.ops import msm as jmsm

from zkp2p_tpu_torch.curve.tcurve import G1C, G2C, g1_jac_to_host, g2_jac_to_host
from zkp2p_tpu_torch.ops import cuda_msm_window, msm

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

rng = random.Random(4321)
N_TABLE = 8  # window 4


def g2_tuple(p):
    return None if p is None else tuple((c.c0, c.c1) for c in p)


# per curve: the port's curve, the host oracle, and the window wrappers.
# G2 bases are small multiples of the generator (host G2 multiplication
# by full scalars is slow); `host` maps a host point to a comparable value.
CURVES = {
    "g1": SimpleNamespace(
        C=G1C, elem=(16,), gen=ref_host.G1_GENERATOR, mul=ref_host.g1_mul,
        msm=ref_host.g1_msm, arrays=g1_to_affine_arrays, to_host=g1_jac_to_host, host=lambda p: p, base_hi=R,
        table=cuda_msm_window.g1_window_table, accumulate=cuda_msm_window.g1_window_accumulate),
    "g2": SimpleNamespace(
        C=G2C, elem=(2, 16), gen=ref_host.G2_GENERATOR, mul=ref_host.g2_mul,
        msm=ref_host.g2_msm, arrays=g2_to_affine_arrays, to_host=g2_jac_to_host, host=g2_tuple, base_hi=1 << 64,
        table=cuda_msm_window.g2_window_table, accumulate=cuda_msm_window.g2_window_accumulate),
}


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def points(cv, n, holes=()):
    pts = [cv.mul(cv.gen, rng.randrange(1, cv.base_hi)) for _ in range(n)]
    for h in holes:
        pts[h] = None
    return pts


def host_points(cv, p):
    return [cv.host(q) for q in cv.to_host(p)]


def planes_of(ks):
    lim = np.stack([int_to_limbs(k) for k in ks])
    return msm.signed_digit_planes_from_limbs(to_t(lim), 4)


def equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture
def chunk_of(monkeypatch):
    """Set the table budget so that a chunk holds `steps` lane steps."""

    def set_chunk(cv, steps, lanes):
        limbs = int(np.prod(cv.elem))
        monkeypatch.setattr(cuda_msm_window, "TABLE_BUDGET_BYTES", steps * 3 * N_TABLE * lanes * limbs * 4)
        assert cuda_msm_window.chunk_steps(lanes, N_TABLE, limbs) == steps

    return set_chunk


def test_chunk_steps_counts_the_element_width():
    # the proof's chunks: h 4,096 lanes; b2 narrow 4,096 lanes (G2), 85
    # steps a chunk, 390 steps in 5 chunks; b2 wide 572 lanes, 17 steps in 1
    assert cuda_msm_window.chunk_steps(4096, N_TABLE, 16) == 170
    assert cuda_msm_window.chunk_steps(4096, N_TABLE, 32) == 85
    assert -(-390 // cuda_msm_window.chunk_steps(4096, N_TABLE, 32)) == 5
    assert cuda_msm_window.chunk_steps(572, N_TABLE, 32) >= 17


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_table_plain_matches_from_affine_and_k3_chain(curve):
    cv = CURVES[curve]
    T, lanes = 3, 5
    pts = points(cv, T * lanes, holes=(0, 7, 14))
    pts[3] = pts[4]  # a repeated base
    x, y = (to_t(c).reshape((T, lanes) + cv.elem) for c in cv.arrays(pts))
    got = cv.table((x, y), N_TABLE)
    assert all(c.shape == (T, N_TABLE, lanes) + cv.elem and c.dtype == torch.int32 for c in got)
    entry = cv.C.from_affine((x, y))
    for k in range(N_TABLE):
        if k:
            entry = cv.C.add_mixed(entry, (x, y))
        assert equal(tuple(c[:, k] for c in got), entry)
    # against the host curve: entry k of base P is (k+1)P
    for t, l, k in ((0, 1, 0), (1, 2, 6), (2, 3, 7), (0, 0, 5), (1, 4, 1)):
        P = pts[t * lanes + l]
        want = None if P is None else cv.mul(P, k + 1)
        assert host_points(cv, tuple(c[t, k, l] for c in got)) == [cv.host(want)]


def _padded(cv, pts, mags, negs, lanes):
    """Bases and planes as _windowed lays them out: (steps, lanes) and
    (n_digits, steps, lanes), padded with (0, 0) bases and zero digits."""
    n = len(pts)
    pad = (-n) % lanes
    steps = (n + pad) // lanes
    elem_pad = [0, 0] * len(cv.elem)
    bases = tuple(F.pad(to_t(c), elem_pad + [0, pad]).reshape((steps, lanes) + cv.elem) for c in cv.arrays(pts))
    nd = mags.shape[0]
    return bases, F.pad(mags, [0, pad]).reshape(nd, steps, lanes), F.pad(negs, [0, pad]).reshape(nd, steps, lanes)


def _crafted(cv, lanes=6, steps=5, nd=4):
    """Digits chosen by hand: negative digits, e = 16 (magnitude 0 with
    the sign set), infinity bases; lane 0 adds P to P (doubling branch),
    lane 1 adds -P to P (to infinity)."""
    pts = points(cv, lanes * steps, holes=(2, 9, 15))
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


def _case(cv, name):
    if name == "full":  # 64 planes of full scalars, n = 37 over 8 lanes (G2: 19 over 4)
        n, lanes = (19, 4) if cv.C.g2 else (37, 8)
        pts = points(cv, n, holes=(3, n - 1))
        ks = [rng.randrange(R) for _ in range(n)]
        ks[0], ks[1], ks[2] = 0, 1, R - 1
        mags, negs = planes_of(ks)
        return pts, mags, negs, lanes
    if name == "narrow":  # the narrow class: scalars < 2^11, the last 3 planes
        pts = points(cv, 40, holes=(7,))
        mags, negs = planes_of([rng.randrange(1 << 11) for _ in range(40)])
        assert not mags[:-3].any()
        return pts, mags[-3:], negs[-3:], 8 if cv.C.g2 else 16
    pts, mags, negs = _crafted(cv)
    return pts, mags, negs, 6


ACCUMULATE_CASES = [("g1", "full", 2), ("g1", "full", 3), ("g1", "narrow", 2), ("g1", "crafted", 2),
                    ("g1", "crafted", 5), ("g2", "full", 2), ("g2", "narrow", 2), ("g2", "crafted", 2)]


@pytest.mark.parametrize("curve,name,chunk", ACCUMULATE_CASES,
                         ids=[f"{n}-{c}" if cv == "g1" else f"{cv}-{n}-{c}" for cv, n, c in ACCUMULATE_CASES])
def test_chunked_accumulate_matches_step_loop(curve, name, chunk, chunk_of):
    cv = CURVES[curve]
    pts, mags, negs, lanes = _case(cv, name)
    bases, planes, neg_t = _padded(cv, pts, mags, negs, lanes)
    chunk_of(cv, chunk, lanes)
    got = msm._accumulate_chunked(cv.C, bases, planes, neg_t, 4)
    want = msm._accumulate_steps(cv.C, bases, planes, neg_t, 4)
    assert equal(got, want)
    if name == "crafted":
        # the special lanes took their branches: 2 * 3P, and P - P
        host = host_points(cv, tuple(c[0, :2] for c in got))
        assert host[0] == cv.host(cv.mul(pts[0], 6))
        assert host[1] is None and not got[2][0, 1].any()


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_accumulate_plain_reads_planes_at_an_offset(curve):
    cv = CURVES[curve]
    pts, mags, negs = _crafted(cv)
    bases, planes, neg_t = _padded(cv, pts, mags, negs, 6)
    table = cv.table((bases[0][2:4], bases[1][2:4]), N_TABLE)
    acc = cv.C.infinity((4, 6), "cpu")
    got = cv.accumulate(acc, table, planes, neg_t, 2)
    want = msm._accumulate_steps(cv.C, (bases[0][2:4], bases[1][2:4]), planes[:, 2:4], neg_t[:, 2:4], 4)
    assert equal(got, want)


# (curve, n, lanes, chunk, digit planes): G1 with full scalars; G2 in
# the narrow class (scalars < 2^11, 3 planes), whose Horner fold is short
# on the CPU (test_torch_msm.py holds a full-scalar G2 MSM against the host)
MSM_CASES = [("g1", 70, 16, 2, 64), ("g1", 37, 8, 4, 64), ("g2", 40, 8, 2, 3)]


@pytest.mark.parametrize("curve,n,lanes,chunk,planes", MSM_CASES)
def test_msm_chunked_matches_host(curve, n, lanes, chunk, planes, chunk_of):
    cv = CURVES[curve]
    pts = points(cv, n, holes=(3, n - 1))
    if planes == 64:
        ks = [rng.randrange(R) for _ in range(n)]
        ks[0], ks[1], ks[2] = 0, 1, R - 1
    else:
        ks = [rng.randrange(1 << (4 * planes - 1)) for _ in range(n)]
        ks[0], ks[1] = 0, 1
    mags, negs = planes_of(ks)
    assert not mags[:-planes].any()
    chunk_of(cv, chunk, lanes)
    got = msm.msm_windowed_signed(cv.C, tuple(to_t(c) for c in cv.arrays(pts)), mags[-planes:], negs[-planes:],
                                  lanes=lanes, window=4)
    assert host_points(cv, got) == [cv.host(cv.msm(pts, ks))]


@pytest.mark.slow
@pytest.mark.parametrize("curve,n,lanes", [("g1", 70, 16), ("g2", 11, 4)])
def test_msm_chunked_matches_jax(curve, n, lanes, chunk_of):
    from zkp2p_tpu.curve.jcurve import G1J, G2J
    from zkp2p_tpu.curve.jcurve import g2_jac_to_host as j_g2_to_host

    cv = CURVES[curve]
    pts = points(cv, n, holes=(3,))
    ks = [rng.randrange(R) for _ in range(n)]
    jb = cv.arrays(pts)
    lim = np.stack([int_to_limbs(k) for k in ks])
    jm, jn = jmsm.signed_digit_planes_from_limbs(jnp.asarray(lim), 4)
    want = jmsm.msm_windowed_signed(G2J if curve == "g2" else G1J, jb, jm, jn, lanes=lanes, window=4)
    chunk_of(cv, 2, lanes)
    mags, negs = msm.signed_digit_planes_from_limbs(to_t(lim), 4)
    got = msm.msm_windowed_signed(cv.C, tuple(to_t(c) for c in jb), mags, negs, lanes=lanes, window=4)
    if curve == "g2":  # the reference folds G2 lanes by a scan on the CPU: compare affine points
        assert host_points(cv, got) == [g2_tuple(p) for p in j_g2_to_host(want)]
    else:
        assert all(np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
                   for g, w in zip(got, want))


# ------------------------------------------------------------------ batches
# The batch prover's chunk: B witnesses' planes against one table (K7/K9
# with a batch axis) and one set of bases (the reference's vmap with the
# key unbatched).  Each witness's result must equal its unbatched one.

BATCH_CASES = [("g1", "full", 2), ("g1", "narrow", 3), ("g1", "crafted", 3), ("g2", "narrow", 2),
               ("g2", "crafted", 3)]


def _batch_planes(cv, name, batch):
    """`batch` witnesses' planes over the bases of _case(cv, name): the
    case's own planes first, then the same digits rolled along the lanes
    with the signs flipped."""
    pts, mags, negs, lanes = _case(cv, name)
    ms, ns = [mags], [negs]
    for b in range(1, batch):
        ms.append(torch.roll(mags, b, dims=-1))
        ns.append(torch.roll(negs, b, dims=-1) ^ (b % 2 == 1))
    return pts, torch.stack(ms, 1), torch.stack(ns, 1), lanes


@pytest.mark.parametrize("curve,name,batch", BATCH_CASES,
                         ids=[f"{cv}-{n}-B{b}" for cv, n, b in BATCH_CASES])
def test_batched_accumulate_plain_matches_each_witness(curve, name, batch):
    cv = CURVES[curve]
    pts, mags, negs, lanes = _batch_planes(cv, name, batch)
    per = [_padded(cv, pts, mags[:, b], negs[:, b], lanes) for b in range(batch)]
    bases = per[0][0]
    planes = torch.stack([p[1] for p in per], 1)  # (n_digits, B, steps, lanes)
    neg_t = torch.stack([p[2] for p in per], 1)
    table = cv.table((bases[0][1:3], bases[1][1:3]), N_TABLE)
    acc = tuple(torch.stack(c) for c in zip(*(cv.C.infinity(planes.shape[:1] + (lanes,), "cpu")
                                               for _ in range(batch))))
    got = cv.accumulate(acc, table, planes, neg_t, 1)
    assert got[0].shape == (batch, planes.shape[0], lanes) + cv.elem
    for b in range(batch):
        want = cv.accumulate(tuple(c[b] for c in acc), table, per[b][1], per[b][2], 1)
        assert equal(tuple(c[b] for c in got), want)


@pytest.mark.parametrize("curve,name,batch", BATCH_CASES,
                         ids=[f"{cv}-{n}-B{b}" for cv, n, b in BATCH_CASES])
def test_batched_msm_matches_each_witness(curve, name, batch, chunk_of):
    cv = CURVES[curve]
    pts, mags, negs, lanes = _batch_planes(cv, name, batch)
    chunk_of(cv, 2, lanes)
    bases = tuple(to_t(c) for c in cv.arrays(pts))
    got = msm.msm_windowed_signed(cv.C, bases, mags, negs, lanes=lanes, window=4)
    assert got[0].shape == (batch,) + cv.elem
    for b in range(batch):
        want = msm.msm_windowed_signed(cv.C, bases, mags[:, b], negs[:, b], lanes=lanes, window=4)
        assert equal(tuple(c[b] for c in got), want)
