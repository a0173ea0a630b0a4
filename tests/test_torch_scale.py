"""K19, the shared-scalar G1 batch of the ceremony (zkp2p_tpu_torch.ops.
cuda_scale), on the CPU: the wrapper's NAF digits are the ones the
reference's native g1_scale_batch builds (its rule recomputed here over
64-bit words); the plain version, normalised as the ceremony normalises
it, gives the reference's host g1_mul point by point, holes and points
sent to infinity included; the wrapper takes the plain version only for
CPU tensors and then counts no launch."""

import random

import numpy as np
import pytest
import torch

from zkp2p_tpu.curve.host import G1_GENERATOR, g1_mul
from zkp2p_tpu.field.bn254 import R

from zkp2p_tpu_torch.curve.tcurve import g1_jac_to_host, g1_limbs
from zkp2p_tpu_torch.field.tfield import FQ
from zkp2p_tpu_torch.ops import cuda_build, cuda_scale
from zkp2p_tpu_torch.ops.msm_affine import jac_to_affine_batch

torch.set_num_threads(1)

SCALARS = {"1": 1, "2": 2, "r-1": R - 1, "2^127": 1 << 127, "random": random.Random(19).randrange(R), "0": 0,
           "r": R}


def native_naf(k: int):
    """csrc/zkp2p_native.cpp g1_scale_batch's digit loop over five 64-bit
    words, least significant digit first."""
    s = [(k >> (64 * i)) & (2**64 - 1) for i in range(4)] + [0]
    out = []
    while any(s) and len(out) < 260:
        if s[0] & 1:
            if s[0] & 3 == 3:
                out.append(-1)  # s += 1
                c = 1
                for i in range(5):
                    t = s[i] + c
                    s[i], c = t & (2**64 - 1), t >> 64
            else:
                out.append(1)  # s -= 1
                s[0] -= 1
        else:
            out.append(0)
        for i in range(4):
            s[i] = (s[i] >> 1) | ((s[i + 1] << 63) & (2**64 - 1))
        s[4] >>= 1
    return out


@pytest.mark.parametrize("k", list(SCALARS.values()) + [3, 7, (1 << 256) - 1, (1 << 255) + 1],
                         ids=list(SCALARS) + ["3", "7", "2^256-1", "2^255+1"])
def test_naf_digits_are_the_native_ones(k):
    digits = cuda_scale.naf_digits(k)
    assert digits == native_naf(k)
    assert sum(d << i for i, d in enumerate(digits)) == k
    assert all(not (a and b) for a, b in zip(digits, digits[1:]))  # non-adjacent
    assert not digits or digits[-1] == 1
    block = cuda_scale.digit_block(k)
    assert block.shape == (4 + cuda_scale.MAX_DIGITS,)
    assert int(block[:4].view(np.int32)[0]) == len(digits) <= 257
    assert block[4:].view(np.int8).tolist() == digits + [0] * (cuda_scale.MAX_DIGITS - len(digits))


def test_scalar_out_of_range_raises():
    with pytest.raises(ValueError):
        cuda_scale.naf_digits(-1)
    with pytest.raises(ValueError):
        cuda_scale.naf_digits(1 << 256)


@pytest.fixture(scope="module")
def points():
    """Five random points, two (0, 0) holes, the generator and its
    negation (the add's P + P and P + (-P) branches run at every digit)."""
    rng = random.Random(1919)
    pts = [g1_mul(G1_GENERATOR, rng.randrange(1, R)) for _ in range(5)]
    pts[2:2] = [None]
    pts += [G1_GENERATOR, g1_mul(G1_GENERATOR, R - 1), None]
    x, y = (torch.from_numpy(c) for c in g1_limbs(pts))
    return pts, (x, y)


@pytest.mark.parametrize("name", list(SCALARS))
def test_plain_version_is_the_host_g1_mul(points, name):
    k = SCALARS[name]
    pts, xy = points
    cuda_build.reset_launches()
    jac = cuda_scale.g1_scale(xy, k)
    assert cuda_build.LAUNCHES["zk_g1_scale"] == 0
    want = [None if p is None else g1_mul(p, k) for p in pts]
    assert g1_jac_to_host(jac) == want
    # holes and the scalar 0 give the Jacobian (0, 0, 0); a point sent to
    # infinity (k = 0, r) has Z = 0 and normalises to (0, 0)
    for i, p in enumerate(pts):
        if p is None or k == 0:
            assert all(not c[i].any() for c in jac)
        elif want[i] is None:
            assert not jac[2][i].any()
    ax, ay = jac_to_affine_batch(FQ, jac)
    wx, wy = g1_limbs(want)
    assert np.array_equal(ax.numpy(), wx) and np.array_equal(ay.numpy(), wy)


def test_wrapper_refuses_other_devices_and_shapes(points):
    _, (x, y) = points
    for a, b in ((x.to("meta"), y.to("meta")), (x, y.to("meta")), (x.to("meta"), y)):
        with pytest.raises(ValueError):
            cuda_scale.g1_scale((a, b), 5)
    with pytest.raises(ValueError):
        cuda_scale.g1_scale((x[:, :8], y[:, :8]), 5)
    with pytest.raises(ValueError):
        cuda_scale.g1_scale((x, y), R << 100)
