"""Montgomery multiplication and powers: the CUDA kernels K1 and K5 and
their plain versions.

Replaces the reference's fused Pallas kernels (``ops/pallas_mont.py``):
``mont_mul``, the SOS Montgomery product a*b*2^-256 mod N for Fr and for
Fq, and ``mont_pow``, the whole square-and-multiply ladder of a^e in one
launch.  At the boundary a field element is 16 little-endian 16-bit limbs
in an ``int32`` tensor, shaped ``(..., 16)``.

``mont_mul`` and ``mont_pow`` launch their kernels (``csrc/mont_mul.cu``,
``csrc/mont_pow.cu``) for CUDA tensors and run ``mont_mul_plain`` and
``mont_pow_plain`` for CPU tensors; nothing else.  The plain versions are
the same limb math in ``int64`` torch ops (torch has no unsigned 32-bit
shifts on the CPU), and are also what ``chip_smoke.py`` holds the kernels
against on the card.

The limb helpers below (carry, schoolbook columns, add and subtract mod
N) are shared with the field layer, whose add/sub/neg and
``reduce_wide`` are plain torch as they are plain XLA in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

LIMB_BITS = 16
NUM_LIMBS = 16
MASK = (1 << LIMB_BITS) - 1


def limbs_of(x: int, n: int = NUM_LIMBS) -> list:
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(n)]


def carry(x: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Nonnegative int64 limbs (each below 2^62) -> canonical 16-bit
    limbs, mod 2^(16*out_limbs): one ripple pass from limb 0 up, each step
    one op over the whole batch."""
    L = x.shape[-1]
    if L < out_limbs:
        x = F.pad(x, (0, out_limbs - L))
    cols = x.unbind(-1)
    c = None
    out = []
    for i in range(out_limbs):
        v = cols[i] if c is None else cols[i] + c
        c = v >> LIMB_BITS
        out.append(v & MASK)
    return torch.stack(out, dim=-1)


def mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns (uncarried): (..., La) x (..., Lb) ->
    (..., La+Lb), column k = sum_{i+j=k} a_i b_j (< 2^37 for 16 limbs).
    The outer product is skewed so row i lands at columns i..i+Lb-1."""
    La, Lb = a.shape[-1], b.shape[-1]
    W = La + Lb
    prods = a.unsqueeze(-1) * b.unsqueeze(-2)
    bshape = prods.shape[:-2]
    flat = F.pad(prods, (0, W + 1 - Lb)).reshape(*bshape, La * (W + 1))
    return flat[..., : La * W].reshape(*bshape, La, W).sum(dim=-2)


def _pick(y: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """y stacks two carried candidates on axis 0; take limbs lo:hi of the
    second where its limb `hi` (the carry out) is set, else of the first."""
    return torch.where(y[1, ..., hi:hi + 1] != 0, y[1, ..., lo:hi], y[0, ..., lo:hi])


def mod_once(x: torch.Tensor, negn: torch.Tensor) -> torch.Tensor:
    """x < 2N (limbs up to 2^17) -> x mod N, negn = 2^256 - N.  Both
    candidates, x and x - N (as x + 2^256 - N, whose bit 256 says
    x >= N), carry in one pass."""
    return _pick(carry(torch.stack([x, x + negn]), NUM_LIMBS + 1), 0, NUM_LIMBS)


def add_mod(a: torch.Tensor, b: torch.Tensor, negn: torch.Tensor) -> torch.Tensor:
    """(a + b) mod N for canonical int64 limbs."""
    return mod_once(a + b, negn)


def sub_mod(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(a - b) mod N for canonical int64 limbs: a + 2^256 - b has bit 256
    set iff a >= b; otherwise a - b + N, offset by the same 2^256, is the
    answer."""
    x = a + (MASK - b)
    x[..., 0] += 1
    y = carry(torch.stack([x + n, x]), NUM_LIMBS + 1)
    return _pick(y, 0, NUM_LIMBS)


def mont_mul_plain64(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor, nprime: torch.Tensor,
                     negn: torch.Tensor) -> torch.Tensor:
    """The SOS Montgomery product on int64 limbs (broadcasting batch
    dims): t = a*b, m = (t mod 2^256)*N' mod 2^256, (t + m*N) / 2^256,
    then one conditional subtract, as the reference kernel does for
    canonical inputs (the subtracted candidate carries beside the sum:
    + (2^256 - N) * 2^256 sets bit 512 iff the quotient is >= N).  m
    takes t's low 16 columns uncarried (below 2^37 each, so their
    columns against N' stay below 2^57): mod 2^256 they are t."""
    tc = mul_cols(a, b)
    t_lo = tc[..., :NUM_LIMBS]
    m = carry(mul_cols(t_lo, nprime.expand_as(t_lo))[..., :NUM_LIMBS], NUM_LIMBS)
    s = tc + mul_cols(m, n.expand_as(m))
    negn_hi = F.pad(negn, (NUM_LIMBS, 0))
    y = carry(torch.stack([s, s + negn_hi]), 2 * NUM_LIMBS + 1)
    return _pick(y, NUM_LIMBS, 2 * NUM_LIMBS)


def mont_mul_plain(field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K1 on int32 limbs, any device."""
    n, nprime, negn = (field.const(k, a.device) for k in ("n", "nprime", "negn"))
    return mont_mul_plain64(a.long(), b.long(), n, nprime, negn).to(torch.int32)


_CONSTS = {}


def field_consts(field) -> np.ndarray:
    """The kernels' FieldConst block: N (8 words), Montgomery one (8
    words), -N^-1 mod 2^32 (cached per modulus)."""
    got = _CONSTS.get(field.modulus)
    if got is None:
        words = [(field.modulus >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
        words += [(field.mont_r >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
        words.append((-pow(field.modulus, -1, 1 << 32)) % (1 << 32))
        got = _CONSTS[field.modulus] = np.array(words, dtype=np.uint32)
    return got


def check_cuda_operand(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: limbs must be int32, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: limbs must be contiguous and 16-byte aligned")


def mont_mul(field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*2^-256 mod N of (..., 16) int32 limbs with
    broadcast batch dims.  Inputs must be canonical (< N).  CUDA tensors
    launch K1; CPU tensors take the plain version."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(field, a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    bshape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    n = math.prod(bshape)

    def operand(x):
        # a single element broadcasts through a stride-0 read
        if math.prod(x.shape[:-1]) == 1 and n > 1:
            return x.reshape(NUM_LIMBS).contiguous(), 0
        if x.shape[:-1] != bshape:
            x = x.expand(*bshape, NUM_LIMBS)
        return (x if x.is_contiguous() else x.contiguous()), 1

    a_c, sa = operand(a)
    b_c, sb = operand(b)
    check_cuda_operand(a_c, "a")
    check_cuda_operand(b_c, "b")
    out = torch.empty(*bshape, NUM_LIMBS, dtype=torch.int32, device=a.device)
    if n:
        cuda_build.launch(
            "mont_mul", "zk_mont_mul",
            a_c.data_ptr(), b_c.data_ptr(), out.data_ptr(), n, sa, sb,
            field_consts(field).ctypes.data,
        )
    return out


def mont_pow_plain(field, a: torch.Tensor, e: int) -> torch.Tensor:
    """Plain torch version of K5 on int32 limbs, any device: the
    reference's LSB-first ladder over mont_mul_plain (acc = one; per bit,
    acc *= base where the bit is set, then base *= base)."""
    if e < 1:
        raise ValueError("mont_pow: the exponent must be >= 1")
    acc = field.const("one", a.device).int().expand_as(a)
    base = a
    while e:
        if e & 1:
            acc = mont_mul_plain(field, acc, base)
        e >>= 1
        if e:
            base = mont_mul_plain(field, base, base)
    return acc


def mont_pow(field, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host exponent e >= 1, Montgomery form in and out, of
    (..., 16) int32 canonical limbs; 0 maps to 0.  CUDA tensors launch
    K5 (one launch for the whole ladder); CPU tensors take the plain
    version."""
    if e < 1 or e >= 1 << 256:
        raise ValueError(f"mont_pow: the exponent must be in [1, 2^256), got {e}")
    if a.device.type == "cpu":
        return mont_pow_plain(field, a, e)
    if a.device.type != "cuda":
        raise ValueError(f"mont_pow: operand on {a.device}")
    a_c = a if a.is_contiguous() else a.contiguous()
    check_cuda_operand(a_c, "a")
    out = torch.empty_like(a_c)
    n = a_c.numel() // NUM_LIMBS
    if n:
        words = np.array([(e >> (32 * i)) & 0xFFFFFFFF for i in range(8)], dtype=np.uint32)
        cuda_build.launch(
            "mont_pow", "zk_mont_pow",
            a_c.data_ptr(), out.data_ptr(), n, words.ctypes.data, e.bit_length(),
            field_consts(field).ctypes.data,
        )
    return out
