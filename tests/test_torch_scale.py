"""K19, the shared-scalar G1 batch of the ceremony (zkp2p_tpu_torch.ops.
cuda_scale), on the CPU: the wrapper's NAF digits are the ones the
reference's native g1_scale_batch builds (its rule recomputed here over
64-bit words); the port's GLV constants and split are the reference's,
integer for integer, and the op streams sum the scalar; the plain
version, normalised as the ceremony normalises it, gives the reference's
host g1_mul point by point, holes, points sent to infinity and points off
the curve included; the wrapper takes the plain version only for CPU
tensors and then counts no launch."""

import random

import numpy as np
import pytest
import torch

from zkp2p_tpu.curve.host import G1_GENERATOR, g1_mul
from zkp2p_tpu.field import bn254 as ref_bn254
from zkp2p_tpu.field.bn254 import R

from zkp2p_tpu_torch.curve.tcurve import g1_jac_to_host, g1_limbs
from zkp2p_tpu_torch.field import bn254 as port_bn254
from zkp2p_tpu_torch.field.tfield import FQ
from zkp2p_tpu_torch.ops import cuda_build, cuda_scale
from zkp2p_tpu_torch.ops.msm_affine import jac_to_affine_batch
from zkp2p_tpu_torch.tools import scale_variants

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


# ------------------------------------------------ the GLV split and streams

GLV_SELF_CHECK = {"0": 0, "1": 1, "2": 2, "r-1": R - 1, "lambda": ref_bn254.GLV_LAMBDA,
                  "r-lambda": R - ref_bn254.GLV_LAMBDA, "2^128-1": (1 << 128) - 1, "r>>1": R >> 1}


def test_glv_constants_are_the_reference():
    assert port_bn254.GLV_LAMBDA == ref_bn254.GLV_LAMBDA
    assert port_bn254.GLV_BETA == ref_bn254.GLV_BETA
    assert (port_bn254.GLV_V1, port_bn254.GLV_V2) == (ref_bn254.GLV_V1, ref_bn254.GLV_V2)
    assert port_bn254.GLV_MAX_BITS == ref_bn254.GLV_MAX_BITS


@pytest.mark.parametrize("k", list(GLV_SELF_CHECK.values()), ids=list(GLV_SELF_CHECK))
def test_glv_decompose_is_the_reference(k):
    k1, k2 = port_bn254.glv_decompose(k)
    assert (k1, k2) == ref_bn254.glv_decompose(k)
    assert (k1 + k2 * port_bn254.GLV_LAMBDA - k) % R == 0
    assert max(abs(k1), abs(k2)) < 1 << port_bn254.GLV_MAX_BITS


def test_glv_decompose_seeded_sweep():
    rng = random.Random(1818)
    for k in [rng.randrange(R) for _ in range(500)] + [rng.randrange(1 << 256) for _ in range(100)]:
        assert port_bn254.glv_decompose(k) == ref_bn254.glv_decompose(k), k


def test_phi_of_the_generator_is_lambda_times_it():
    x, y = G1_GENERATOR
    assert (port_bn254.GLV_BETA * x % ref_bn254.P, y) == g1_mul(G1_GENERATOR, port_bn254.GLV_LAMBDA)


def _run_ops(ops):
    """The coefficients (c1, c2) of P and phi(P) that an op stream sums."""
    c1 = c2 = 0
    for op in ops:
        if op == 0:
            c1, c2 = 2 * c1, 2 * c2
        elif abs(op) == 1:
            c1 += op
        else:
            c2 += op // 2
    return c1, c2


@pytest.mark.parametrize("k", list(SCALARS.values()) + [(1 << 256) - 1, int("55" * 32, 16), R + 5],
                         ids=list(SCALARS) + ["2^256-1", "0x55..55", "r+5"])
def test_op_streams_sum_the_scalar(k):
    glv, naf = cuda_scale.glv_ops(k), cuda_scale.naf_ops(k)
    assert _run_ops(glv) == port_bn254.glv_decompose(k)
    assert _run_ops(naf) == (k, 0)
    assert not glv or glv[0] != 0  # the first op adds to the point at infinity
    assert len(glv) + len(naf) <= cuda_scale.MAX_OPS
    assert sum(1 for o in glv if o == 0) <= port_bn254.GLV_MAX_BITS  # about half the NAF's doublings
    block = cuda_scale.op_block(k)
    assert block.shape == (40 + cuda_scale.MAX_OPS,)
    assert int.from_bytes(block[:32].tobytes(), "little") == port_bn254.GLV_BETA * (1 << 256) % ref_bn254.P
    assert block[32:40].view(np.int32).tolist() == [len(glv), len(naf)]
    assert block[40:].view(np.int8).tolist() == glv + naf + [0] * (cuda_scale.MAX_OPS - len(glv) - len(naf))


def test_plain_version_at_the_widest_scalar(points):
    pts, xy = points
    k = (1 << 256) - 1
    ax, ay = jac_to_affine_batch(FQ, cuda_scale.g1_scale(xy, k))
    wx, wy = g1_limbs([None if p is None else g1_mul(p, k) for p in pts])
    assert np.array_equal(ax.numpy(), wx) and np.array_equal(ay.numpy(), wy)


@pytest.fixture(scope="module")
def off_curve_points():
    """Three points off the curve (y^2 - x^3 neither 0 nor 3: a corrupt
    key's), beside a point on it and a hole."""
    rng = random.Random(1920)
    pts = []
    while len(pts) < 3:
        x, y = rng.randrange(ref_bn254.P), rng.randrange(ref_bn254.P)
        if (y * y - x ** 3) % ref_bn254.P not in (0, 3):
            pts.append((x, y))
    pts += [g1_mul(G1_GENERATOR, 77), None]
    x, y = (torch.from_numpy(c) for c in g1_limbs(pts))
    return pts, (x, y)


@pytest.mark.parametrize("k, n", [(random.Random(21).randrange(R), 3), (R + 5, 5)], ids=["random", "r+5"])
def test_plain_version_off_the_curve_is_the_host_g1_mul(off_curve_points, k, n):
    """Off the curve k1*P + k2*phi(P) is not k*P, and k is not reduced mod
    r: the full-scalar NAF ladder gives what the reference's g1_mul gives
    (at r + 5 beside a point on the curve and a hole, whose GLV stream is
    short)."""
    pts, (x, y) = off_curve_points
    pts, xy = pts[:n], (x[:n], y[:n])
    jac = cuda_scale.g1_scale(xy, k)
    want = [None if p is None else g1_mul(p, k) for p in pts]
    assert g1_jac_to_host(jac) == want
    ax, ay = jac_to_affine_batch(FQ, jac)
    wx, wy = g1_limbs(want)
    assert np.array_equal(ax.numpy(), wx) and np.array_equal(ay.numpy(), wy)
    if k >= R:  # off the curve, k mod r gives other points: the ladder must not reduce k
        assert want[:3] != [g1_mul(p, k % R) for p in pts[:3]]


@pytest.mark.parametrize("name", list(scale_variants.VARIANTS))
def test_variant_sources_change_only_k19s_policy_and_blocks(name):
    """tools/scale_variants.py edits csrc/scale.cu's text: each variant
    names its policy in k_g1_scale alone and its blocks an SM; the
    comparator keeps MulCC."""
    policy, blocks = scale_variants.VARIANTS[name]
    src = (cuda_build.CSRC_DIR / "scale.cu").read_text()
    out = scale_variants.variant_source(src, policy, blocks)
    kernel = out.split("k_g1_scale(const", 1)[1].split("// The comparator", 1)[0]
    assert f"<{policy}>" in kernel and ("<MulCallCC>" in kernel) == (policy == "MulCallCC")
    assert f"SCALE_MIN_BLOCKS = {blocks};" in out
    assert policy == "MulCallCC" or f"struct {policy} {{" in out
    assert out.split("// The comparator", 1)[1] == src.split("// The comparator", 1)[1]
