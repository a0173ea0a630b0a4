"""One pass of a radix-2 DIT NTT over BN254 Fr: the k consecutive
butterfly stages s0 .. s0+k-1 in one launch of kernel K12
(``csrc/ntt.cu``), over every row of a ``(*rows, m, 16)`` batch.

Stage s pairs, for each index i0 with bit s clear, x[i0] and x[i0 | 2^s]
under the twiddle ``tw[pos << (log_m - 1 - s)]`` (pos = i0 mod 2^s):
b = x[i0 | 2^s] * tw, then x[i0] = a + b and x[i0 | 2^s] = a - b, the
stage body of the reference's ``_ntt_core`` (``ops/ntt.py``), whose
twiddle product is the Pallas kernel ``mont_mul``
(``ops/pallas_mont.py``).  The stages of a pass mix only indices that
differ in bits [s0, s0+k), so the pass splits into m / 2^k closed groups
of 2^k elements; group (low, high) holds x[low | t << s0 | high << (s0+k)]
for t < 2^k, a reshape of the row to (high, t, low).

With ``bitrev`` the pass reads element i from address brev(i) (the
input permutation of a DIT ladder); with a ``factor`` it multiplies the
element read from address j by factor[j] (an ``(m, 16)`` table) or by
one ``(16,)`` constant as it loads.  ``out`` may be ``x`` (in place)
unless ``bitrev``.

``ntt_pass`` launches K12 for CUDA tensors and runs ``ntt_pass_plain``
for CPU tensors; nothing else.  The plain version is the same pass in
plain torch (limb products by ``mont_mul_plain``, add and sub by the
field layer), on any device; the kernel equals it bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..field.tfield import FR
from . import cuda_build
from .cuda_mont import NUM_LIMBS, check_cuda_operand, field_consts, mont_mul_plain

# The kernel's largest pass: 2^11 elements of 32 B, 64 KB of shared memory
# a block.
MAX_PASS_LOG = 11
# Elements a plain pass works on at a time (bounds the int64 temporaries
# of its products on large batches).
PLAIN_CHUNK = 1 << 20


def bit_reverse_perm(m: int) -> np.ndarray:
    k = m.bit_length() - 1
    idx = np.arange(m)
    rev = np.zeros(m, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _check(x: torch.Tensor, tw: torch.Tensor, s0: int, k: int, factor) -> int:
    """log2 of the row length; raises on shapes the pass does not take."""
    m = x.shape[-2] if x.dim() >= 2 else 0
    log_m = m.bit_length() - 1
    if x.dim() < 2 or x.shape[-1] != NUM_LIMBS or m != 1 << log_m:
        raise ValueError(f"ntt_pass: x {tuple(x.shape)}, expected (..., 2^log_m, 16)")
    if tuple(tw.shape) != (max(m // 2, 1), NUM_LIMBS):
        raise ValueError(f"ntt_pass: twiddles {tuple(tw.shape)} for m = {m}")
    if not (0 <= k <= MAX_PASS_LOG and 0 <= s0 and s0 + k <= log_m):
        raise ValueError(f"ntt_pass: stages {s0}..{s0 + k} of {log_m}, at most {MAX_PASS_LOG} a pass")
    if factor is not None and tuple(factor.shape) not in ((NUM_LIMBS,), (m, NUM_LIMBS)):
        raise ValueError(f"ntt_pass: factor {tuple(factor.shape)} for m = {m}")
    return log_m


def ntt_pass_plain(x: torch.Tensor, tw: torch.Tensor, s0: int, k: int, bitrev: bool = False,
                   factor: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of K12, any device: stages s0 .. s0+k-1 of the
    DIT ladder over each closed group, PLAIN_CHUNK elements at a time."""
    log_m = _check(x, tw, s0, k, factor)
    m = 1 << log_m
    lead = x.shape[:-2]
    rows = math.prod(lead)
    if bitrev:
        src = torch.from_numpy(bit_reverse_perm(m)).to(x.device)
        x = x.index_select(-2, src)
        if factor is not None and factor.dim() == 2:
            factor = factor.index_select(0, src)
    H, K, L = m >> (s0 + k), 1 << k, 1 << s0
    v = x.reshape(rows, H, K, L, NUM_LIMBS)
    res = torch.empty(v.shape, dtype=torch.int32, device=x.device)
    f = None if factor is None else factor.reshape(1, H, K, L, NUM_LIMBS) if factor.dim() == 2 else factor
    # chunks of (high, low) groups: whole highs while a chunk holds one
    per_low = max(rows, 1) * K
    hc = max(1, PLAIN_CHUNK // (per_low * L))
    lc = L if hc > 1 else max(1, min(L, PLAIN_CHUNK // per_low))
    for h0 in range(0, H, hc):
        for l0 in range(0, L, lc):
            sl = (slice(None), slice(h0, h0 + hc), slice(None), slice(l0, l0 + lc))
            c = v[sl]
            if f is not None:
                c = mont_mul_plain(FR, c, f if f.dim() == 1 else f[sl])
            res[sl] = _stages(c, tw, log_m, s0, k, l0)
    res = res.reshape(x.shape)
    if out is None:
        return res
    out.copy_(res)
    return out


def _stages(v: torch.Tensor, tw: torch.Tensor, log_m: int, s0: int, k: int, l0: int) -> torch.Tensor:
    """The pass's stages on groups (rows, high, 2^k, low, 16), low from l0."""
    shape = v.shape
    lows = torch.arange(l0, l0 + shape[3], device=v.device)
    for ls in range(k):
        s, half = s0 + ls, 1 << ls
        w = v.reshape(*shape[:2], shape[2] // (2 * half), 2, half, *shape[3:])
        a, b = w[:, :, :, 0], w[:, :, :, 1]
        pos = lows[None, :] | (torch.arange(half, device=v.device)[:, None] << s0)  # (half, low)
        t = tw.index_select(0, (pos << (log_m - 1 - s)).flatten()).reshape(half, len(lows), NUM_LIMBS)
        b = mont_mul_plain(FR, b, t)
        v = torch.stack([FR.add(a, b), FR.sub(a, b)], dim=3).reshape(shape)
    return v


def ntt_pass(x: torch.Tensor, tw: torch.Tensor, s0: int, k: int, bitrev: bool = False,
             factor: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stages s0 .. s0+k-1 of the DIT ladder over x (*rows, m, 16), int32
    Montgomery limbs, canonical; twiddles tw (m/2, 16).  Reads x at
    bit-reversed addresses with ``bitrev``; multiplies each element read
    from address j by factor[j] (or by one (16,) factor) as it loads.
    Writes ``out`` (new if None; may be x unless bitrev) and returns it.
    CUDA tensors launch K12; CPU tensors take the plain version."""
    operands = [t for t in (x, tw, factor, out) if t is not None]
    devs = {t.device for t in operands}
    if all(d.type == "cpu" for d in devs):
        return ntt_pass_plain(x, tw, s0, k, bitrev, factor, out)
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"ntt_pass: operands on {sorted(str(d) for d in devs)}; expected one cuda device")
    log_m = _check(x, tw, s0, k, factor)
    for t, name in ((x, "x"), (tw, "twiddles"), (factor, "factor"), (out, "out")):
        if t is not None:
            check_cuda_operand(t, f"ntt_pass {name}")
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape or (bitrev and out.data_ptr() == x.data_ptr()):
        raise ValueError(f"ntt_pass: out {tuple(out.shape)} for x {tuple(x.shape)} (in place only without bitrev)")
    rows = math.prod(x.shape[:-2])
    if rows:
        cuda_build.launch(
            "ntt", "zk_fr_ntt_pass",
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), None if factor is None else factor.data_ptr(),
            rows, log_m, s0, k, int(bitrev), 0 if factor is None or factor.dim() == 1 else 1,
            field_consts(FR).ctypes.data,
        )
    return out
