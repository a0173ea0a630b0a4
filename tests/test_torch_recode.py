"""The signed base-2^w recode of the port (ops.msm.signed_digit_planes:
K14 on the card, the Kogge-Stone signed_digit_planes_from_limbs on the
CPU) against a serial least-significant-first recode over Python ints,
written here as K14 computes it, and against the JAX
zkp2p_tpu.ops.msm.signed_digit_planes_from_limbs.  Inputs are made from
a numpy seed; mags and negs are compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.ops import msm as jmsm

from zkp2p_tpu_torch.ops import cuda_build, msm

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)


def nibbles(hexdigit: str, top: int = 0) -> int:
    """The value whose 64 base-16 digits are `hexdigit`, the top `top` of
    them 0 (so that it stays below R)."""
    return int("0" * top + hexdigit * (64 - top), 16)


# 0, 1, R-1, 2^253; all-0xF limbs below R; carry chains through digits
# equal to half (0x88..8 above a generating digit, 0x8000 limbs above a
# generating limb at w = 16); and digits 2^w - 1 that take a carry in, the
# (mag 0, neg) digits
SPECIAL = (
    0, 1, R - 1, 1 << 253,
    nibbles("f", 1), sum(0xFFFF << (16 * i) for i in range(15)) + (0x3063 << 240),
    nibbles("8", 1) + 1, nibbles("8", 1) | 0xF, sum(0x8000 << (16 * i) for i in range(15)) + 1,
    0xF9, 0xFFF9, 0xF0F0F9, 0xFFFF_9000, 0xFFFF_FFFF_8001_0000_0000_9000,
    nibbles("f", 2) - 6,
)


def serial_recode(k: int, window: int):
    """Signed digits of k, least significant first with the carry in hand
    (e = d + carry; neg = e > 2^(w-1); mag = 2^w - e if neg else e), the
    last carry dropped; returned most significant first."""
    half, full = 1 << (window - 1), 1 << window
    mags, negs, carry = [], [], 0
    for j in range(256 // window):
        e = ((k >> (window * j)) & (full - 1)) + carry
        neg = e > half
        mags.append(full - e if neg else e)
        negs.append(neg)
        carry = int(neg)
    return mags[::-1], negs[::-1]


def scalars(seed, n):
    rng = np.random.default_rng(seed)
    return list(SPECIAL) + [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def limbs_of(ks) -> np.ndarray:
    buf = b"".join(k.to_bytes(32, "little") for k in ks)
    return np.frombuffer(buf, dtype="<u2").astype(np.int32).reshape(len(ks), 16)


@pytest.mark.parametrize("window", [4, 16])
def test_recode_matches_serial_and_jax(window):
    ks = scalars(100 + window, 2000)
    assert all(0 <= k < R for k in ks)
    lim = limbs_of(ks)
    cuda_build.reset_launches()
    mags, negs = msm.signed_digit_planes(torch.from_numpy(lim), window)
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())
    assert mags.dtype == torch.int32 and negs.dtype == torch.bool and mags.shape == (256 // window, len(ks))
    serial = [serial_recode(k, window) for k in ks]
    want_mags = np.array([s[0] for s in serial], dtype=np.int32).T
    want_negs = np.array([s[1] for s in serial], dtype=bool).T
    assert np.array_equal(mags.numpy(), want_mags)
    assert np.array_equal(negs.numpy(), want_negs)
    km, kn = msm.signed_digit_planes_from_limbs(torch.from_numpy(lim), window)
    assert torch.equal(km, mags) and torch.equal(kn, negs)
    jm, jn = jmsm.signed_digit_planes_from_limbs(jnp.asarray(lim.astype(np.uint32)), window)
    assert np.array_equal(np.asarray(jm).astype(np.int32), want_mags)
    assert np.array_equal(np.asarray(jn), want_negs)
    # the planes spell the scalar, and the traps show
    digits = np.where(want_negs, -want_mags.astype(object), want_mags.astype(object))
    for i in (0, 1, 2, 3, 7, len(ks) - 1):
        assert sum(int(d) << (window * (len(digits) - 1 - p)) for p, d in enumerate(digits[:, i])) == ks[i]
    assert (want_mags.max() <= 1 << (window - 1)) and ((want_mags == 0) & want_negs).any()


def test_recode_keeps_leading_batch_axes():
    lim = torch.from_numpy(limbs_of(scalars(7, 13)).reshape(4, 7, 16))
    mags, negs = msm.signed_digit_planes(lim, 4)
    assert mags.shape == negs.shape == (64, 4, 7)
    flat_m, flat_n = msm.signed_digit_planes(lim.reshape(28, 16), 4)
    assert torch.equal(mags.reshape(64, 28), flat_m) and torch.equal(negs.reshape(64, 28), flat_n)
