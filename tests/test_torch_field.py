"""The port's field layer (zkp2p_tpu_torch.field, ops.cuda_mont) against
the reference: the plain versions of kernels K1 (mont_mul) and K5
(mont_pow) against the Pallas kernels in interpret mode, the XLA field
layer and Python ints; the plain field ops against
zkp2p_tpu.field.jfield.  Integer math: every comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp2p_tpu.field import jfield
from zkp2p_tpu.field.bn254 import MONT_R, P, R
from zkp2p_tpu.ops.pallas_mont import mont_mul as pallas_mont_mul
from zkp2p_tpu.ops.pallas_mont import mont_pow as pallas_mont_pow

from zkp2p_tpu_torch.field import tfield
from zkp2p_tpu_torch.ops import cuda_mont

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

rng = random.Random(777)

FIELDS = [(jfield.FR, tfield.FR, R), (jfield.FQ, tfield.FQ, P)]
IDS = ["fr", "fq"]


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def to_j(x: torch.Tensor):
    return jnp.asarray(x.numpy().astype(np.uint32))


def same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy().astype(np.int64), np.asarray(j).astype(np.int64))


def mont_batch(jf, mod, n):
    xs = [rng.randrange(mod) for _ in range(n)] + [0, 1, mod - 1]
    return xs, np.stack([jf.to_mont_host(x) for x in xs])


@pytest.mark.parametrize("jf,tf,mod", FIELDS, ids=IDS)
def test_mont_mul_plain_matches_pallas_xla_and_ints(jf, tf, mod):
    xs, a = mont_batch(jf, mod, 9)
    ys, b = mont_batch(jf, mod, 9)
    b = b[::-1].copy()
    ys = ys[::-1]
    got = cuda_mont.mont_mul_plain(tf, to_t(a), to_t(b))
    assert same(got, pallas_mont_mul(jf, jnp.asarray(a), jnp.asarray(b), interpret=True))
    assert same(got, jf.mul(jnp.asarray(a), jnp.asarray(b)))
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert tf.from_mont_host(got[i].numpy()) == x * y % mod
    # the field's mul on CPU tensors is the plain version
    assert torch.equal(tf.mul(to_t(a), to_t(b)), got)


def test_mont_mul_batch_dims_and_broadcast():
    _, a = mont_batch(jfield.FR, R, 3)
    _, b = mont_batch(jfield.FR, R, 3)
    a, b = a.reshape(2, 3, 16), b.reshape(2, 3, 16)
    got = tfield.FR.mul(to_t(a), to_t(b))
    assert got.shape == (2, 3, 16)
    assert same(got, jfield.FR.mul(jnp.asarray(a), jnp.asarray(b)))
    # a (16,) constant against a batch (to_mont's R^2 operand)
    std = np.stack([jfield.int_to_limbs(rng.randrange(R)) for _ in range(5)])
    assert same(tfield.FR.to_mont(to_t(std)), jfield.FR.to_mont(jnp.asarray(std)))


@pytest.mark.parametrize("jf,tf,mod", FIELDS, ids=IDS)
def test_add_sub_neg_match_jfield(jf, tf, mod):
    xs, a = mont_batch(jf, mod, 13)
    _, b = mont_batch(jf, mod, 13)
    b[0] = a[0]  # a - a = 0
    b[-1] = a[-1]
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), to_t(a), to_t(b)
    assert same(tf.add(ta, tb), jf.add(ja, jb))
    assert same(tf.sub(ta, tb), jf.sub(ja, jb))
    assert same(tf.sub(tb, ta), jf.sub(jb, ja))
    assert same(tf.neg(ta), jf.neg(ja))
    assert same(tf.neg(torch.zeros(4, 16, dtype=torch.int32)), np.zeros((4, 16)))  # -0 = 0
    assert same(tf.is_zero(ta), jf.is_zero(ja))
    assert same(tf.eq(ta, tb), jf.eq(ja, jb))


@pytest.mark.parametrize("jf,tf,mod", FIELDS, ids=IDS)
def test_to_from_mont_and_inv_match_jfield(jf, tf, mod):
    xs = [rng.randrange(mod) for _ in range(6)] + [0, 1, mod - 1]
    std = np.stack([jfield.int_to_limbs(x) for x in xs])
    mont = tf.to_mont(to_t(std))
    assert same(mont, jf.to_mont(jnp.asarray(std)))
    assert same(tf.from_mont(mont), std)
    inv = tf.inv(mont)
    assert same(inv, jf.inv(jnp.asarray(mont.numpy().astype(np.uint32))))
    for i, x in enumerate(xs):
        assert tf.from_mont_host(inv[i].numpy()) == (pow(x, mod - 2, mod) if x else 0)
    assert tf.from_mont_host(tf.pow_const(mont, 5)[3].numpy()) == pow(xs[3], 5, mod)


def test_fq2_mul_matches_jfield():
    _, a = mont_batch(jfield.FQ, P, 7)
    _, b = mont_batch(jfield.FQ, P, 7)
    a2, b2 = a[:10].reshape(5, 2, 16), b[:10].reshape(5, 2, 16)
    got = tfield.FQ2.mul(to_t(a2), to_t(b2))
    assert same(got, jfield.FQ2.mul(jnp.asarray(a2), jnp.asarray(b2)))
    assert same(tfield.FQ2.add(to_t(a2), to_t(b2)), jfield.FQ2.add(jnp.asarray(a2), jnp.asarray(b2)))
    assert same(tfield.FQ2.sub(to_t(a2), to_t(b2)), jfield.FQ2.sub(jnp.asarray(a2), jnp.asarray(b2)))


def test_lazy_segment_sum_mod_and_reduce_wide_match_jfield():
    n, segs = 200, 37
    _, vals = mont_batch(jfield.FR, R, n - 3)
    ids = np.array([rng.randrange(segs) for _ in range(n)], dtype=np.int32)
    ids[:40] = 5  # a heavy segment
    got = tfield.lazy_segment_sum_mod(tfield.FR, to_t(vals), torch.from_numpy(ids).long(), segs)
    want = jfield.lazy_segment_sum_mod(jfield.FR, jnp.asarray(vals), jnp.asarray(ids), segs)
    assert same(got, want)
    wide = np.stack([jfield.int_to_limbs(rng.randrange(1 << 490), 31) for _ in range(6)])
    assert same(tfield.reduce_wide(tfield.FQ, to_t(wide)), jfield.reduce_wide(jfield.FQ, jnp.asarray(wide)))


def test_limb_helpers_and_constants():
    x = rng.randrange(R)
    assert tfield.limbs_to_int(tfield.int_to_limbs(x)) == x
    assert np.array_equal(tfield.int_to_limbs(x), jfield.int_to_limbs(x).astype(np.int32))
    for tf, jf in ((tfield.FR, jfield.FR), (tfield.FQ, jfield.FQ)):
        assert (tf.mont_r, tf.mont_r2, tf.nprime_int) == (jf.mont_r, jf.mont_r2, jf.nprime_int)
        assert tf.from_mont_host(tf.to_mont_host(x % tf.modulus)) == x % tf.modulus
    from zkp2p_tpu.field import bn254 as ref
    from zkp2p_tpu_torch.field import bn254

    assert (bn254.P, bn254.R, bn254.MONT_R) == (ref.P, ref.R, MONT_R)
    for k in (1, 5, 11, 23, 28):
        assert bn254.fr_domain_root(k) == ref.fr_domain_root(k)
    assert bn254.fr_inv(12345) == ref.fr_inv(12345)


# the exponents of the reference's own mont_pow tests: Fermat inversion
# on Fq, small exponents on Fr
POW_CASES = [(jfield.FQ, tfield.FQ, P, P - 2), (jfield.FR, tfield.FR, R, 5), (jfield.FR, tfield.FR, R, 1)]
POW_IDS = ["fq-inv", "fr-e5", "fr-e1"]


@pytest.mark.parametrize("jf,tf,mod,e", POW_CASES, ids=POW_IDS)
def test_mont_pow_plain_matches_pallas_and_ints(jf, tf, mod, e):
    xs, a = mont_batch(jf, mod, 4)  # lanes 0, 1 and p - 1 included
    got = cuda_mont.mont_pow_plain(tf, to_t(a), e)
    assert same(got, pallas_mont_pow(jf, jnp.asarray(a), e, interpret=True))
    for i, x in enumerate(xs):
        assert tf.from_mont_host(got[i].numpy()) == pow(x, e, mod)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(cuda_mont.mont_pow(tf, to_t(a), e), got)


@pytest.mark.parametrize("jf,tf,mod", FIELDS, ids=IDS)
def test_inv_fused_matches_jax_inv_and_ints(jf, tf, mod):
    xs, a = mont_batch(jf, mod, 3)
    got = tf.inv_fused(to_t(a))
    assert same(got, jf.inv(jnp.asarray(a)))
    assert torch.equal(got, tf.inv(to_t(a)))
    for i, x in enumerate(xs):
        assert tf.from_mont_host(got[i].numpy()) == (pow(x, mod - 2, mod) if x else 0)


def test_mont_pow_batch_dims_and_exponent_range():
    """A 2-D batch (the reference's vmap case) keeps its shape; e = 0
    and e >= 2^256 are refused, as the reference asserts e >= 1."""
    xs, a = mont_batch(jfield.FQ, P, 3)
    a2 = to_t(a).reshape(2, 3, 16)
    got = cuda_mont.mont_pow_plain(tfield.FQ, a2, P - 2)
    assert got.shape == (2, 3, 16)
    assert same(got, pallas_mont_pow(jfield.FQ, jnp.asarray(a.reshape(2, 3, 16)), P - 2, interpret=True))
    assert same(got.reshape(6, 16), jfield.FQ.inv(jnp.asarray(a)))
    for bad in (0, -3, 1 << 256):
        with pytest.raises(ValueError):
            cuda_mont.mont_pow(tfield.FQ, a2, bad)
