"""BN254 field arithmetic on torch limb tensors (port of the reference's
``field/jfield.py``).

Layout contract, the same as the reference's: an element is 16
little-endian 16-bit limbs, value = sum(limb[i] << 16*i), canonical
(< modulus), held in an ``int32`` tensor of shape ``(..., 16)``;
Fq2 elements are ``(..., 2, 16)``.  Elements are in Montgomery form
(R = 2^256) unless a function says otherwise.

``mul`` is kernel K1 on a CUDA tensor (``ops.cuda_mont``) and its plain
version on a CPU tensor, and so is ``inv_fused`` with kernel K5.
add/sub/neg, the carry ladders and the partial products inside
``reduce_wide`` are plain torch, as they are plain XLA in the reference;
they compute in ``int64`` internally.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import cuda_mont
from ..ops.cuda_mont import NUM_LIMBS, add_mod, carry, mod_once, mul_cols, sub_mod
from .bn254 import MONT_R, P, R, mont_constants

LIMB_BITS = 16


def int_to_limbs(x: int, n: int = NUM_LIMBS) -> np.ndarray:
    """Host int -> int32 limb vector (little-endian 16-bit limbs)."""
    return np.array(cuda_mont.limbs_of(x, n), dtype=np.int32)


def mont_limbs(vals, modulus: int) -> np.ndarray:
    """Host ints -> (n, 16) int32 Montgomery limbs (one bytes join, no
    per-limb loop)."""
    vals = list(vals)
    buf = b"".join((int(v) * MONT_R % modulus).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, "<u2").astype(np.int32).reshape(len(vals), NUM_LIMBS)


def limbs_to_int(a) -> int:
    a = np.asarray(a, dtype=np.int64)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a))


class TPrimeField:
    """A prime field over torch limb tensors.  Two instances exist: ``FQ``
    (base field, curve coordinates) and ``FR`` (scalar field, witness and
    NTT)."""

    elem = (NUM_LIMBS,)

    def __init__(self, modulus: int, name: str):
        self.modulus = modulus
        self.name = name
        self.mont_r, self.mont_r2, self.nprime_int = mont_constants(modulus)
        self._dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def const(self, name: str, device) -> torch.Tensor:
        """A (16,) int64 constant on `device`: "n", "nprime", "negn"
        (2^256 - N), "r2", "one" (Montgomery one) or "unit" (the integer 1)."""
        device = torch.device(device)
        table = self._dev.get(device)
        if table is None:
            vals = {"n": self.modulus, "nprime": self.nprime_int, "negn": (1 << 256) - self.modulus,
                    "r2": self.mont_r2, "one": self.mont_r, "unit": 1}
            table = {k: torch.tensor(cuda_mont.limbs_of(v), dtype=torch.int64, device=device)
                     for k, v in vals.items()}
            self._dev[device] = table
        return table[name]

    # ------------------------------------------------------------ host I/O

    def to_mont_host(self, x: int) -> np.ndarray:
        return int_to_limbs((x * MONT_R) % self.modulus)

    def from_mont_host(self, limbs) -> int:
        return (limbs_to_int(limbs) * pow(MONT_R, -1, self.modulus)) % self.modulus

    # --------------------------------------------------------- basic arith

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return add_mod(a.long(), b.long(), self.const("negn", a.device)).int()

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a.long(), b.long())
        return sub_mod(a, b, self.const("n", a.device)).int()

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        """(0 - a) mod N: -0 stays 0, not N."""
        a64 = a.long()
        return sub_mod(torch.zeros_like(a64), a64, self.const("n", a.device)).int()

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product (a*b*R^-1) mod N: K1 on CUDA."""
        return cuda_mont.mont_mul(self, a, b)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Standard-form limbs -> Montgomery form."""
        return self.mul(a, self.const("r2", a.device).int())

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery form -> standard-form limbs (mont-mul by 1)."""
        return self.mul(a, self.const("unit", a.device).int())

    def one_like(self, a: torch.Tensor) -> torch.Tensor:
        return self.const("one", a.device).int().expand_as(a)

    # ----------------------------------------------------------- predicates

    @staticmethod
    def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=-1)

    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=-1)

    @staticmethod
    def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """cond ? a : b, cond shaped (...,) against (..., 16) operands."""
        return torch.where(cond.unsqueeze(-1), a, b)

    # ------------------------------------------------------------ inversion

    def pow_const(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a host exponent, LSB-first square-and-multiply."""
        acc = self.one_like(a).clone()
        base = a
        while e:
            if e & 1:
                acc = self.mul(acc, base)
            e >>= 1
            if e:
                base = self.square(base)
        return acc

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Fermat inverse a^(N-2); 0 maps to 0."""
        return self.pow_const(a, self.modulus - 2)

    def inv_fused(self, a: torch.Tensor) -> torch.Tensor:
        """`inv` in one launch: kernel K5 runs the whole ladder on a CUDA
        tensor (pow_const issues 363 K1 launches on Fq, 380 on Fr); the
        plain ladder on a CPU tensor."""
        return cuda_mont.mont_pow(self, a, self.modulus - 2)


FQ = TPrimeField(P, "fq")
FR = TPrimeField(R, "fr")


class TFq2Ops:
    """Fq2 = Fq[u]/(u^2 + 1) on stacked limb pairs (..., 2, 16)."""

    elem = (2, NUM_LIMBS)

    def __init__(self, fq: TPrimeField = FQ):
        self.fq = fq

    def add(self, a, b):
        return self.fq.add(a, b)

    def sub(self, a, b):
        return self.fq.sub(a, b)

    def neg(self, a):
        return self.fq.neg(a)

    def mul(self, a, b):
        f = self.fq
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        v0 = f.mul(a0, b0)
        v1 = f.mul(a1, b1)
        c0 = f.sub(v0, v1)  # u^2 = -1
        c1 = f.sub(f.mul(f.add(a0, a1), f.add(b0, b1)), f.add(v0, v1))
        return torch.stack([c0, c1], dim=-2)

    def square(self, a):
        return self.mul(a, a)

    def one_like(self, a):
        one = self.fq.one_like(a[..., 0, :])
        return torch.stack([one, torch.zeros_like(one)], dim=-2)

    @staticmethod
    def eq(a, b):
        return (a == b).all(dim=-1).all(dim=-1)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=-1).all(dim=-1)

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond[..., None, None], a, b)


FQ2 = TFq2Ops(FQ)


# ------------------------------------------------------- batched reductions


def reduce_wide(field: TPrimeField, wide: torch.Tensor) -> torch.Tensor:
    """A canonical-limb value of up to 31 limbs -> x mod N.

    One Montgomery reduction computes x*2^-256 mod N (exact because
    x < 2^496), then a mont-mul by 2^512 mod N restores the factor."""
    L = wide.shape[-1]
    if L > 31:
        raise ValueError("reduce_wide supports < 2^496 inputs")
    x = torch.nn.functional.pad(wide.long(), (0, 2 * NUM_LIMBS - L))
    nprime = field.const("nprime", x.device)
    n = field.const("n", x.device)
    m = carry(mul_cols(x[..., :NUM_LIMBS], nprime.expand(*x.shape[:-1], NUM_LIMBS))[..., :NUM_LIMBS],
              NUM_LIMBS)
    s = carry(x + mul_cols(m, n.expand_as(m)), 2 * NUM_LIMBS)
    t = mod_once(s[..., NUM_LIMBS:], field.const("negn", x.device)).int()
    return field.mul(t, field.const("r2", x.device).int())


def lazy_segment_sum_mod(
    field: TPrimeField, values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment sums of canonical limb values, reduced mod N: the
    sparse-matvec primitive behind Az/Bz.  Limbs are summed in int64
    (exact for any fan-in below 2^47).  On CUDA `index_add_` adds with
    atomics in no fixed order, which is harmless: integer sums are exact
    in any order."""
    acc = torch.zeros(num_segments, NUM_LIMBS, dtype=torch.int64, device=values.device)
    acc.index_add_(0, segment_ids.long(), values.long())
    wide = carry(acc, NUM_LIMBS + 3)
    # in chunks: the partial products of reduce_wide take 2 KiB a row
    return torch.cat([reduce_wide(field, w) for w in wide.split(_REDUCE_CHUNK)])


_REDUCE_CHUNK = 1 << 20
