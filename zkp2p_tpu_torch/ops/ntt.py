"""Radix-2 NTT / iNTT over BN254 Fr on limb tensors (port of the
reference's ``ops/ntt.py``).

A transform of 2^log_m is the reference's DIT ladder: the input in
bit-reversed order (its ``_ntt_core``, ``zkp2p_tpu/ops/ntt.py:83``:
``x[..., perm, :]``), then log_m butterfly stages (its ``stage`` body,
``:88-104``: the twiddle product, Pallas ``mont_mul`` on a TPU, then add
and sub).  Here the stages run in passes (``pass_plan``): at most
PASS_LOG stages a pass, split as evenly as possible (2^23: 8 + 8 + 7),
each pass one launch of kernel K12 over every row of the batch
(``ops/cuda_ntt.py``; its plain version for CPU tensors).  The first
pass reads the input at bit-reversed addresses, so the permutation costs
no pass of its own, and may multiply each element by a factor as it
loads:
  - ``intt`` multiplies by 1/m there, where the reference multiplies the
    iNTT's output (``:112-115``, ``FR.mul(y, m_inv_mont)``);
  - ``coset_ladder``, the H ladder's ntt(coset_shift(intt(x)))
    (``zkp2p_tpu/prover/groth16_tpu.py:525-538``), runs the iNTT's
    passes unscaled and multiplies by g^i / m, one precomputed table
    (``_coset_factor``), as the NTT's first pass loads: the reference's
    1/m product and its ``coset_shift`` (``:124-126``, coeff[i] *= g^i)
    in one product an element.
Every value is a canonical Fr element and each operation is exact, so
the limbs equal the stage-at-a-time ladder's (``_ntt_core``, kept as the
comparator with ``_ladder_steps``) bit for bit.

Twiddle tables are built on the device in log2(m) doubling steps."""

from __future__ import annotations

from functools import lru_cache

import torch

from ..field.bn254 import R, fr_domain_root, fr_inv
from ..field.tfield import FR
from .cuda_ntt import MAX_PASS_LOG, bit_reverse_perm, ntt_pass

# Stages a pass runs at most (K12's limit; a constant, not a knob).
PASS_LOG = MAX_PASS_LOG


def pass_plan(log_m: int):
    """[(s0, k), ...]: the fewest passes of at most PASS_LOG stages that
    cover stages 0 .. log_m-1, the larger first (2^23: (0, 8), (8, 8),
    (16, 7)); a domain of one element is one pass of no stages."""
    n = max(1, -(-log_m // PASS_LOG))
    base, extra = divmod(log_m, n)
    plan, s0 = [], 0
    for i in range(n):
        k = base + (i < extra)
        plan.append((s0, k))
        s0 += k
    return plan


def _twiddle_powers(w: int, count: int, device) -> torch.Tensor:
    """[w^0 .. w^(count-1)] in Montgomery form by doublings:
    powers[j + 2^i] = powers[j] * w^(2^i)."""
    cur = torch.from_numpy(FR.to_mont_host(1)[None, :]).to(device)
    e = 1
    while cur.shape[0] < count:
        factor = torch.from_numpy(FR.to_mont_host(pow(w, e, R))).to(device)
        cur = torch.cat([cur, FR.mul(cur, factor)], dim=0)
        e *= 2
    return cur[:count]


@lru_cache(maxsize=None)
def domain(log_m: int, device: torch.device):
    """Tables for the 2^log_m domain on `device` (cached per process)."""
    m = 1 << log_m
    w = fr_domain_root(log_m)
    return {
        "m": m,
        "perm": torch.from_numpy(bit_reverse_perm(m)).to(device),
        "tw": _twiddle_powers(w, max(m // 2, 1), device),
        "tw_inv": _twiddle_powers(fr_inv(w), max(m // 2, 1), device),
        "m_inv_mont": torch.from_numpy(FR.to_mont_host(fr_inv(m))).to(device),
    }


def _ntt_core(x: torch.Tensor, tw: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Iterative DIT butterfly ladder on (..., m, 16) Montgomery limbs, a
    stage at a time: the comparator of the passes.

    Stage s pairs element pos of each 2^(s+1)-block with element
    pos + 2^s under twiddle tw[pos * m / 2^(s+1)], as the reference's
    stage body does with gathers; here the pairs are views of one
    reshape and the outputs land in place by one stack."""
    m = x.shape[-2]
    if m == 1:
        return x
    log_m = m.bit_length() - 1
    x = x.index_select(-2, perm)
    for s in range(log_m):
        half = 1 << s
        v = x.reshape(*x.shape[:-2], m // (2 * half), 2, half, x.shape[-1])
        a, b = v[..., 0, :, :], v[..., 1, :, :]
        b = FR.mul(b, tw[:: m // (2 * half)])
        x = torch.stack([FR.add(a, b), FR.sub(a, b)], dim=-3).reshape(x.shape)
    return x


def _transform(x: torch.Tensor, tw: torch.Tensor, log_m: int, factor=None) -> torch.Tensor:
    """The DIT ladder over x (..., 2^log_m, 16) in pass_plan's passes, the
    first reading bit-reversed (times `factor`), the rest in place."""
    if x.shape[-2] != 1 << log_m:
        raise ValueError(f"NTT of 2^{log_m} on rows of {x.shape[-2]}")
    y = None
    for s0, k in pass_plan(log_m):
        if y is None:
            y = ntt_pass(x, tw, s0, k, bitrev=True, factor=factor)
        else:
            ntt_pass(y, tw, s0, k, out=y)
    return y


def ntt(x: torch.Tensor, log_m: int) -> torch.Tensor:
    """Evaluations of the coefficient vector on the 2^log_m roots domain."""
    return _transform(x, domain(log_m, x.device)["tw"], log_m)


def intt(x: torch.Tensor, log_m: int) -> torch.Tensor:
    d = domain(log_m, x.device)
    return _transform(x, d["tw_inv"], log_m, factor=d["m_inv_mont"])


@lru_cache(maxsize=None)
def _coset_powers(g: int, log_m: int, device: torch.device) -> torch.Tensor:
    return _twiddle_powers(g, 1 << log_m, device)


def coset_shift(coeffs: torch.Tensor, g: int, log_m: int) -> torch.Tensor:
    """coeff[i] *= g^i: moves evaluation onto the coset g*H."""
    return FR.mul(coeffs, _coset_powers(g, log_m, coeffs.device))


@lru_cache(maxsize=None)
def _coset_factor(g: int, log_m: int, device: torch.device) -> torch.Tensor:
    """g^i / m in Montgomery form, (2^log_m, 16): the iNTT's scale and the
    coset shift in one factor (cached per process)."""
    return FR.mul(_twiddle_powers(g, 1 << log_m, device), domain(log_m, device)["m_inv_mont"])


def coset_ladder(evals: torch.Tensor, g: int, log_m: int) -> torch.Tensor:
    """ntt(coset_shift(intt(evals), g)): evaluations on the 2^log_m roots
    domain (..., m, 16) -> evaluations on the coset g*H, in 2 x
    len(pass_plan(log_m)) passes over all rows."""
    d = domain(log_m, evals.device)
    coeffs = _transform(evals, d["tw_inv"], log_m)
    return _transform(coeffs, d["tw"], log_m, factor=_coset_factor(g, log_m, evals.device))


def _ladder_steps(evals: torch.Tensor, g: int, log_m: int) -> torch.Tensor:
    """coset_ladder a stage at a time, as the reference composes it
    (``_ntt_core`` with K1 products, the 1/m scale, coset_shift): the
    comparator of coset_ladder."""
    d = domain(log_m, evals.device)
    coeffs = FR.mul(_ntt_core(evals, d["tw_inv"], d["perm"]), d["m_inv_mont"])
    return _ntt_core(coset_shift(coeffs, g, log_m), d["tw"], d["perm"])
