"""Mersenne-31 scalar field arithmetic (host reference implementation).

Parity target: reference ``zkir-spec/src/field.rs`` — p = 2^31 - 1, canonical
form, Mersenne reduction ``(x & p) + (x >> 31)`` (field.rs:57-68), Fermat
inverse ``a^(p-2)`` (field.rs:95-100).

This module is the *scalar oracle* for the vectorized device kernels in
``zkir_tpu.ops.field_ops`` — every device kernel is differential-tested
against these functions.
"""

from __future__ import annotations

M31_PRIME = (1 << 31) - 1


def m31_reduce(x: int) -> int:
    """Reduce a non-negative value modulo p via the Mersenne identity
    ``x mod (2^31 - 1) = (x & p) + (x >> 31)`` (reference field.rs:57-79)."""
    while x >> 31:
        x = (x & M31_PRIME) + (x >> 31)
    return 0 if x == M31_PRIME else x


def m31_add(a: int, b: int) -> int:
    return m31_reduce(a + b)


def m31_sub(a: int, b: int) -> int:
    return m31_reduce(a + M31_PRIME - (b % M31_PRIME))


def m31_neg(a: int) -> int:
    a %= M31_PRIME
    return 0 if a == 0 else M31_PRIME - a


def m31_mul(a: int, b: int) -> int:
    return m31_reduce(a * b)


def m31_pow(a: int, exp: int) -> int:
    result = 1
    base = a % M31_PRIME
    while exp > 0:
        if exp & 1:
            result = m31_mul(result, base)
        base = m31_mul(base, base)
        exp >>= 1
    return result


def m31_inv(a: int) -> int:
    """Multiplicative inverse via Fermat: a^(p-2) (reference field.rs:95-100)."""
    if a % M31_PRIME == 0:
        raise ZeroDivisionError("division by zero in Mersenne31")
    return m31_pow(a, M31_PRIME - 2)


class M31:
    """Canonical-form Mersenne-31 field element (value in [0, p))."""

    __slots__ = ("v",)

    PRIME = M31_PRIME

    def __init__(self, value: int):
        self.v = value % M31_PRIME

    def __add__(self, other: "M31") -> "M31":
        return M31(self.v + other.v)

    def __sub__(self, other: "M31") -> "M31":
        return M31(self.v - other.v)

    def __mul__(self, other: "M31") -> "M31":
        return M31(self.v * other.v)

    def __neg__(self) -> "M31":
        return M31(m31_neg(self.v))

    def inv(self) -> "M31":
        return M31(m31_inv(self.v))

    def pow(self, exp: int) -> "M31":
        return M31(m31_pow(self.v, exp))

    def __eq__(self, other) -> bool:
        return isinstance(other, M31) and self.v == other.v

    def __hash__(self) -> int:
        return hash(self.v)

    def __repr__(self) -> str:
        return f"M31({self.v})"
