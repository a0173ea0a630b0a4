"""The port's curve layer (zkp2p_tpu_torch.curve.tcurve, the plain
versions of kernels K2-K4 in ops.cuda_curve) against the reference:
bitwise against zkp2p_tpu.curve.jcurve on every special lane (P+Q, P+P,
P+(-P), inf+Q, P+inf, inf+inf, the (0, 0) affine sentinel), against the
host curve after normalisation, and, in the slow tier, against the Pallas
kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.curve import host as ref_host
from zkp2p_tpu.curve.jcurve import G1J, G2J, g1_to_affine_arrays, g2_to_affine_arrays

from zkp2p_tpu_torch.curve import tcurve

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

rng = np.random.default_rng(4242)


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def pt_t(p):
    return tuple(to_t(c) for c in p)


def same(a, b) -> bool:
    return all(np.array_equal(np.asarray(x).astype(np.int64), np.asarray(y).astype(np.int64)) for x, y in zip(a, b))


def cases(g2: bool):
    """Lanes: [0] inf+Q, [1] P+P, [2] P+(-P), [3] P+inf, [4] inf+inf,
    [5:] generic; the affine q has (0, 0) in lanes 3 and 4."""
    J = G2J if g2 else G1J
    G = ref_host.G2_GENERATOR if g2 else ref_host.G1_GENERATOR
    mul = ref_host.g2_mul if g2 else ref_host.g1_mul
    to_arr = g2_to_affine_arrays if g2 else g1_to_affine_arrays
    n = 7
    ps = [None] + [mul(G, int(k)) for k in rng.integers(1, 2**60, n - 1)]
    qs = [mul(G, int(k)) for k in rng.integers(1, 2**60, n)]
    qs[1] = ps[1]
    qs[2] = (ref_host.g2_neg if g2 else ref_host.g1_neg)(ps[2])
    qs_aff = list(qs)
    qs_aff[3] = qs_aff[4] = None
    ps[4] = None
    P_, Q_aff = J.from_affine(to_arr(ps)), to_arr(qs_aff)
    Q = J.from_affine(Q_aff)
    return J, P_, Q, Q_aff, ps, qs_aff


@pytest.fixture(scope="module", params=[False, True], ids=["g1", "g2"])
def curve_cases(request):
    g2 = request.param
    return (g2, (tcurve.G2C if g2 else tcurve.G1C)) + cases(g2)


def test_add_matches_jcurve_and_host(curve_cases):
    g2, C, J, P_, Q, _, ps, qs = curve_cases
    got = C.add(pt_t(P_), pt_t(Q))
    assert same(got, J.add(P_, Q))
    to_host = tcurve.g2_jac_to_host if g2 else tcurve.g1_jac_to_host
    add = ref_host.g2_add if g2 else ref_host.g1_add
    want = [add(p, q) for p, q in zip(ps, qs)]
    got_host = to_host(got)
    if g2:
        got_host = [None if p is None else tuple((c.c0, c.c1) for c in p) for p in got_host]
        want = [None if p is None else tuple((c.c0, c.c1) for c in p) for p in want]
    assert got_host == want


def test_add_mixed_matches_jcurve(curve_cases):
    g2, C, J, P_, _, Q_aff, _, _ = curve_cases
    assert same(C.add_mixed(pt_t(P_), pt_t(Q_aff)), J.add_mixed(P_, Q_aff))


def test_double_matches_jcurve(curve_cases):
    g2, C, J, P_, _, _, _, _ = curve_cases
    assert same(C.double(pt_t(P_)), J.double(P_))


def test_point_helpers_match_jcurve(curve_cases):
    g2, C, J, P_, _, Q_aff, ps, _ = curve_cases
    assert same(C.from_affine(pt_t(Q_aff)), J.from_affine(Q_aff))
    assert same(C.neg(pt_t(P_)), J.neg(P_))
    assert same([C.is_inf(pt_t(P_))], [J.is_inf(P_)])
    arr = (tcurve.g2_to_affine_arrays if g2 else tcurve.g1_to_affine_arrays)(ps, "cpu")
    ref = (g2_to_affine_arrays if g2 else g1_to_affine_arrays)(ps)
    assert same(arr, ref)


def test_plain_batch_dims_broadcast():
    """(2, 3) batch dims and a broadcast operand through the wrappers."""
    _, P_, Q, _, _, _ = cases(False)
    p = tuple(to_t(c)[1:7].reshape(2, 3, 16) for c in P_)
    q = tuple(to_t(c)[1:2] for c in Q)  # one point against the batch
    got = tcurve.G1C.add(p, q)
    want = G1J.add(tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in p),
                   tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in q))
    assert got[0].shape == (2, 3, 16) and same(got, want)


@pytest.mark.slow
def test_plain_matches_pallas_interpret_g1():
    """Against the Pallas G1 kernels in interpret mode (slow there too)."""
    from zkp2p_tpu.field.jfield import FQ
    from zkp2p_tpu.ops.pallas_curve import g1_add, g1_add_mixed, g1_double

    _, P_, Q, Q_aff, _, _ = cases(False)
    assert same(tcurve.G1C.add(pt_t(P_), pt_t(Q)), g1_add(FQ, P_, Q, True))
    assert same(tcurve.G1C.add_mixed(pt_t(P_), pt_t(Q_aff)), g1_add_mixed(FQ, P_, Q_aff, True))
    assert same(tcurve.G1C.double(pt_t(P_)), g1_double(FQ, P_, True))


@pytest.mark.slow
def test_plain_matches_pallas_g2_math():
    """Against the Pallas G2 point math over _Fq2Ops on plain arrays (the
    reference's own G2 test route: interpret-mode Fq2 kernels are
    prohibitively slow)."""
    from zkp2p_tpu.field.jfield import FQ
    from zkp2p_tpu.ops.pallas_curve import _add_math, _add_mixed_math, _consts, _double_math, _Fq2Ops, _FqOps

    f = _Fq2Ops(_FqOps(*_consts(FQ)))

    def to_lm(c):
        flat = c.reshape(-1, 2, 16)
        return (jnp.moveaxis(flat[:, 0, :], -1, 0), jnp.moveaxis(flat[:, 1, :], -1, 0))

    def from_lm(pair):
        return jnp.stack([jnp.moveaxis(pair[0], 0, -1), jnp.moveaxis(pair[1], 0, -1)], axis=-2)

    _, P_, Q, Q_aff, _, _ = cases(True)
    p_lm, q_lm, a_lm = (tuple(to_lm(c) for c in x) for x in (P_, Q, Q_aff))
    assert same(tcurve.G2C.add(pt_t(P_), pt_t(Q)), [from_lm(c) for c in _add_math(f, p_lm, q_lm)])
    assert same(tcurve.G2C.add_mixed(pt_t(P_), pt_t(Q_aff)), [from_lm(c) for c in _add_mixed_math(f, p_lm, a_lm)])
    assert same(tcurve.G2C.double(pt_t(P_)), [from_lm(c) for c in _double_math(f, *p_lm)])
