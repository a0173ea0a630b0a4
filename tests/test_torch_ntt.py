"""The port's NTT (zkp2p_tpu_torch.ops.ntt) against the host oracle
zkp2p_tpu.snark.fft_host, and in the slow tier against the JAX ops.ntt
(slow there: XLA compiles)."""

import random

import numpy as np
import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.snark import fft_host

from zkp2p_tpu_torch.field.tfield import FR
from zkp2p_tpu_torch.ops import ntt

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

rng = random.Random(99)


def to_mont(xs):
    return torch.from_numpy(np.stack([FR.to_mont_host(x) for x in xs]))


def from_mont(t):
    return [FR.from_mont_host(row) for row in t.numpy()]


@pytest.mark.parametrize("log_m", [3, 6])
def test_ntt_intt_coset_match_host(log_m):
    m = 1 << log_m
    xs = [rng.randrange(R) for _ in range(m)]
    x = to_mont(xs)
    assert from_mont(ntt.ntt(x, log_m)) == fft_host.ntt(xs)
    assert from_mont(ntt.intt(x, log_m)) == fft_host.intt(xs)
    g = rng.randrange(2, R)
    assert from_mont(ntt.coset_shift(x, g, log_m)) == fft_host.coset_shift(xs, g)
    assert from_mont(ntt.intt(ntt.ntt(x, log_m), log_m)) == xs


def test_ntt_batched_rows():
    log_m = 4
    rows = [[rng.randrange(R) for _ in range(16)] for _ in range(3)]
    x = torch.stack([to_mont(r) for r in rows])
    got = ntt.ntt(x, log_m)
    assert [from_mont(g) for g in got] == [fft_host.ntt(r) for r in rows]


@pytest.mark.slow
@pytest.mark.parametrize("log_m", [3, 6])
def test_ntt_matches_jax(log_m):
    import jax.numpy as jnp

    from zkp2p_tpu.ops import ntt as jntt

    m = 1 << log_m
    x = to_mont([rng.randrange(R) for _ in range(m)])
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    g = rng.randrange(2, R)
    for got, want in (
        (ntt.ntt(x, log_m), jntt.ntt(jx, log_m)),
        (ntt.intt(x, log_m), jntt.intt(jx, log_m)),
        (ntt.coset_shift(x, g, log_m), jntt.coset_shift(jx, g, log_m)),
    ):
        assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
