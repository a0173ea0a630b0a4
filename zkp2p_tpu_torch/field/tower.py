"""Fq2 = Fq[u]/(u^2 + 1) on Python ints: the host arithmetic the G2
oracle and the proof assembly need."""

from __future__ import annotations

from .bn254 import P


class Fq2:
    """a + b*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @classmethod
    def zero(cls) -> "Fq2":
        return cls(0, 0)

    @classmethod
    def one(cls) -> "Fq2":
        return cls(1, 0)

    def __eq__(self, other) -> bool:
        return isinstance(other, Fq2) and self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __add__(self, other: "Fq2") -> "Fq2":
        return Fq2(self.c0 + other.c0, self.c1 + other.c1)

    def __sub__(self, other: "Fq2") -> "Fq2":
        return Fq2(self.c0 - other.c0, self.c1 - other.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, other):
        if isinstance(other, int):
            return Fq2(self.c0 * other, self.c1 * other)
        a0, a1, b0, b1 = self.c0, self.c1, other.c0, other.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    __rmul__ = __mul__

    def square(self) -> "Fq2":
        a0, a1 = self.c0, self.c1
        return Fq2((a0 + a1) * (a0 - a1), 2 * a0 * a1)

    def inv(self) -> "Fq2":
        a0, a1 = self.c0, self.c1
        norm = (a0 * a0 + a1 * a1) % P
        if norm == 0:
            raise ZeroDivisionError("inverse of zero in Fq2")
        ninv = pow(norm, P - 2, P)
        return Fq2(a0 * ninv, -a1 * ninv)

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"


XI = Fq2(9, 1)  # the twist's non-residue 9 + u
