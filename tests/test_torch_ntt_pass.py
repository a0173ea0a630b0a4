"""The NTT in passes (zkp2p_tpu_torch.ops.ntt: pass_plan, ntt, intt,
coset_ladder over K12's plain version, cuda_ntt.ntt_pass_plain) against
the stage-at-a-time ladder _ntt_core, the host oracle
zkp2p_tpu.snark.fft_host and the JAX ops.ntt; exact limbs in every case.
On the CPU, ntt, intt and coset_ladder are compositions of plain passes,
so these tests exercise the pass plan, the twiddle indexing of a pass and
the factor applied as the first pass loads."""

import numpy as np
import pytest
import torch

from zkp2p_tpu.field.bn254 import R
from zkp2p_tpu.snark import fft_host

from zkp2p_tpu_torch.field.tfield import FR
from zkp2p_tpu_torch.ops import cuda_ntt, ntt

# the test runner runs one process per core: torch's own intra-op threads
# would oversubscribe them (and these tensors are small)
torch.set_num_threads(1)

CPU = torch.device("cpu")
SPECIAL = (0, 1, R - 1)


def field_values(shape, seed):
    """Random Fr values (Python ints) made from a seed with numpy, the
    first entries of each row 0, 1 and r - 1."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=tuple(shape) + (8,), dtype=np.uint64)
    vals = np.frompyfunc(lambda *ws: sum(int(w) << (32 * i) for i, w in enumerate(ws)) % R, 8, 1)(
        *np.moveaxis(words, -1, 0))
    vals = np.asarray(vals, dtype=object).reshape(shape)
    for i, v in enumerate(SPECIAL[: shape[-1]]):
        vals[..., i] = v
    return vals


def to_mont(vals) -> torch.Tensor:
    flat = [FR.to_mont_host(int(v)) for v in np.asarray(vals, dtype=object).ravel()]
    return torch.from_numpy(np.stack(flat).reshape(np.shape(vals) + (16,)))


def from_mont(t: torch.Tensor) -> list:
    return [FR.from_mont_host(row) for row in t.reshape(-1, 16).numpy()]


def steps_ntt(x, log_m):
    d = ntt.domain(log_m, CPU)
    return ntt._ntt_core(x, d["tw"], d["perm"])


def steps_intt(x, log_m):
    d = ntt.domain(log_m, CPU)
    return FR.mul(ntt._ntt_core(x, d["tw_inv"], d["perm"]), d["m_inv_mont"])


@pytest.mark.parametrize("pass_log", [1, 2, 3, 11])
def test_pass_plan_covers_every_stage(monkeypatch, pass_log):
    monkeypatch.setattr(ntt, "PASS_LOG", pass_log)
    assert ntt.pass_plan(0) == [(0, 0)]
    for log_m in range(1, 29):
        plan = ntt.pass_plan(log_m)
        ks = [k for _, k in plan]
        assert [s0 for s0, _ in plan] == list(np.cumsum([0] + ks[:-1]))
        assert sum(ks) == log_m and max(ks) <= pass_log and max(ks) - min(ks) <= 1
        assert len(plan) == -(-log_m // pass_log)
    if pass_log == 11:
        assert ntt.pass_plan(23) == [(0, 8), (8, 8), (16, 7)]


@pytest.mark.parametrize("pass_log", [1, 2, 3, None])
@pytest.mark.parametrize("log_m", range(1, 11))
def test_passes_equal_ntt_core(monkeypatch, log_m, pass_log):
    """ntt and intt as composed plain passes equal _ntt_core (and its 1/m
    product), over a single row and over a (3, m) batch."""
    if pass_log is not None:
        monkeypatch.setattr(ntt, "PASS_LOG", pass_log)
    m = 1 << log_m
    for shape, seed in (((m,), log_m), ((3, m), 100 + log_m)):
        x = to_mont(field_values(shape, seed))
        assert torch.equal(ntt.ntt(x, log_m), steps_ntt(x, log_m))
        assert torch.equal(ntt.intt(x, log_m), steps_intt(x, log_m))


@pytest.mark.parametrize("pass_log", [2, None])
@pytest.mark.parametrize("log_m", [3, 7])
def test_transforms_match_host_and_old_composition(monkeypatch, log_m, pass_log):
    """ntt, intt and coset_ladder against fft_host.ntt/intt/coset_shift and
    against ntt(coset_shift(intt(x))) through _ntt_core."""
    if pass_log is not None:
        monkeypatch.setattr(ntt, "PASS_LOG", pass_log)
    m = 1 << log_m
    vals = field_values((3, m), 7 * log_m)
    x = to_mont(vals)
    g = 5
    rows = [[int(v) for v in row] for row in vals]
    got_ntt, got_intt, got_ladder = (from_mont(f(x)) for f in (
        lambda t: ntt.ntt(t, log_m), lambda t: ntt.intt(t, log_m), lambda t: ntt.coset_ladder(t, g, log_m)))
    assert got_ntt == sum((fft_host.ntt(r) for r in rows), [])
    assert got_intt == sum((fft_host.intt(r) for r in rows), [])
    assert got_ladder == sum((fft_host.ntt(fft_host.coset_shift(fft_host.intt(r), g)) for r in rows), [])
    old = steps_ntt(ntt.coset_shift(steps_intt(x, log_m), g, log_m), log_m)
    assert torch.equal(ntt.coset_ladder(x, g, log_m), old)
    assert torch.equal(ntt._ladder_steps(x, g, log_m), old)


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_plain_pass_in_chunks_and_in_place(monkeypatch, chunk):
    """A plain pass worked a few groups (or a part of one group's lows) at
    a time equals it in one piece, with each kind of factor; a pass with
    out=x writes x."""
    log_m = 7
    d = ntt.domain(log_m, CPU)
    x = to_mont(field_values((3, 1 << log_m), 71))
    factors = (None, d["m_inv_mont"], ntt._coset_factor(5, log_m, CPU))
    plan = [(0, 3), (3, 2), (5, 2)]
    whole = {}
    for i, (s0, k) in enumerate(plan):
        for j, f in enumerate(factors):
            whole[i, j] = cuda_ntt.ntt_pass_plain(x, d["tw"], s0, k, i == 0, f)
    monkeypatch.setattr(cuda_ntt, "PLAIN_CHUNK", chunk)
    for (i, j), want in whole.items():
        s0, k = plan[i]
        assert torch.equal(cuda_ntt.ntt_pass_plain(x, d["tw"], s0, k, i == 0, factors[j]), want)
        if i:
            y = x.clone()
            assert cuda_ntt.ntt_pass(y, d["tw"], s0, k, factor=factors[j], out=y) is y
            assert torch.equal(y, want)


def test_ladder_matches_jax():
    """coset_ladder on three rows against the JAX package's
    ntt(coset_shift(intt(x))) at 2^6.  On the CPU the reference's FR.mul
    takes its XLA path, the plain version of its Pallas mont_mul, as the
    JAX package's own tests run it; XLA's compile of the ladder takes
    about 13 s on the CPU."""
    import jax.numpy as jnp

    from zkp2p_tpu.ops import ntt as jntt

    log_m, g = 6, 5
    x = to_mont(field_values((3, 1 << log_m), 66))
    jx = jnp.asarray(x.numpy().astype(np.uint32))
    want = jntt.ntt(jntt.coset_shift(jntt.intt(jx, log_m), g, log_m), log_m)
    got = ntt.coset_ladder(x, g, log_m)
    assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
