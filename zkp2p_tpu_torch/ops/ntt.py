"""Radix-2 NTT / iNTT over BN254 Fr on limb tensors (port of the
reference's ``ops/ntt.py``).

Each stage views its butterfly pairs in one reshape, multiplies the
upper halves by their twiddles (one batched Fr product: kernel K1 on
CUDA), adds and subtracts; the same butterflies as the reference's stage
body.  Twiddle tables are built on the device in log2(m) doubling
steps."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field.bn254 import R, fr_domain_root, fr_inv
from ..field.tfield import FR


def _bit_reverse_perm(m: int) -> np.ndarray:
    k = m.bit_length() - 1
    idx = np.arange(m)
    rev = np.zeros(m, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


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
        "perm": torch.from_numpy(_bit_reverse_perm(m)).to(device),
        "tw": _twiddle_powers(w, max(m // 2, 1), device),
        "tw_inv": _twiddle_powers(fr_inv(w), max(m // 2, 1), device),
        "m_inv_mont": torch.from_numpy(FR.to_mont_host(fr_inv(m))).to(device),
    }


def _ntt_core(x: torch.Tensor, tw: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Iterative DIT butterfly ladder on (..., m, 16) Montgomery limbs.

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


def ntt(x: torch.Tensor, log_m: int) -> torch.Tensor:
    """Evaluations of the coefficient vector on the 2^log_m roots domain."""
    d = domain(log_m, x.device)
    return _ntt_core(x, d["tw"], d["perm"])


def intt(x: torch.Tensor, log_m: int) -> torch.Tensor:
    d = domain(log_m, x.device)
    return FR.mul(_ntt_core(x, d["tw_inv"], d["perm"]), d["m_inv_mont"])


@lru_cache(maxsize=None)
def _coset_powers(g: int, log_m: int, device: torch.device) -> torch.Tensor:
    return _twiddle_powers(g, 1 << log_m, device)


def coset_shift(coeffs: torch.Tensor, g: int, log_m: int) -> torch.Tensor:
    """coeff[i] *= g^i: moves evaluation onto the coset g*H."""
    return FR.mul(coeffs, _coset_powers(g, log_m, coeffs.device))
