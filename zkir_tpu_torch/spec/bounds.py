"""Value-bound tracking for range-check elision.

Parity target: reference ``zkir-spec/src/bound.rs`` — CryptoType widths
(bound.rs:24-41), adaptive internal width (bound.rs:47-54), bound
propagation rules (bound.rs:199-299).

Host copy of ``zkir_tpu/spec/bounds.py``.  In the batched interpreter,
bounds live as a per-register ``max_bits`` int32 column; the propagation
rules below are mirrored there.  This host-side type keeps the full (max_bits, source) pair for the
oracle VM and trace parity tests.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple, Union


class CryptoType(enum.IntEnum):
    SHA256 = 0
    KECCAK256 = 1
    POSEIDON2 = 2
    BLAKE3 = 3

    @property
    def algorithm_bits(self) -> int:
        # bound.rs:24-31
        return {self.SHA256: 32, self.KECCAK256: 64,
                self.POSEIDON2: 31, self.BLAKE3: 32}[self]

    @property
    def min_internal_bits(self) -> int:
        # bound.rs:35-41
        return {self.SHA256: 44, self.BLAKE3: 44,
                self.POSEIDON2: 40, self.KECCAK256: 80}[self]

    def internal_bits(self, program_bits: int) -> int:
        # bound.rs:47-54: max(min_internal, program_bits)
        return max(self.min_internal_bits, program_bits)

    def internal_headroom(self, program_bits: int) -> int:
        return self.internal_bits(program_bits) - self.algorithm_bits

    def post_crypto_headroom(self, program_bits: int) -> int:
        return max(program_bits - self.algorithm_bits, 0)

    def needs_range_check(self, program_bits: int) -> bool:
        # bound.rs:75-77
        return self.algorithm_bits > program_bits


class BoundKind(enum.IntEnum):
    PROGRAM_WIDTH = 0
    TYPE_WIDTH = 1
    CRYPTO_OUTPUT = 2
    COMPUTED = 3
    CONSTANT = 4


# BoundSource is (kind, payload): payload is the type width for TYPE_WIDTH,
# the CryptoType for CRYPTO_OUTPUT, the constant value for CONSTANT, else None.
BoundSource = Tuple[BoundKind, Optional[Union[int, CryptoType]]]


def _const_bits(val: int) -> int:
    return 0 if val == 0 else val.bit_length()


@dataclass(frozen=True)
class ValueBound:
    max_bits: int
    source: BoundSource = (BoundKind.COMPUTED, None)

    # ---- constructors (bound.rs:123-173) ----

    @staticmethod
    def from_program_width(data_bits: int) -> "ValueBound":
        return ValueBound(data_bits, (BoundKind.PROGRAM_WIDTH, None))

    @staticmethod
    def from_type_width(bits: int) -> "ValueBound":
        return ValueBound(bits, (BoundKind.TYPE_WIDTH, bits))

    @staticmethod
    def from_crypto(crypto: CryptoType) -> "ValueBound":
        return ValueBound(crypto.algorithm_bits, (BoundKind.CRYPTO_OUTPUT, crypto))

    @staticmethod
    def from_constant(val: int) -> "ValueBound":
        return ValueBound(_const_bits(val), (BoundKind.CONSTANT, val))

    @staticmethod
    def computed(max_bits: int) -> "ValueBound":
        return ValueBound(max_bits, (BoundKind.COMPUTED, None))

    # ---- queries ----

    def headroom(self, data_bits: int) -> int:
        return max(data_bits - self.max_bits, 0)

    def needs_range_check(self, data_bits: int) -> bool:
        return self.max_bits > data_bits

    def fits_in(self, target_bits: int) -> bool:
        return self.max_bits <= target_bits

    # ---- propagation rules (bound.rs:199-299) ----

    @staticmethod
    def after_add(a: "ValueBound", b: "ValueBound") -> "ValueBound":
        return ValueBound.computed(max(a.max_bits, b.max_bits) + 1)

    @staticmethod
    def after_sub(a: "ValueBound", b: "ValueBound") -> "ValueBound":
        return ValueBound.computed(max(a.max_bits, b.max_bits))

    @staticmethod
    def after_mul(a: "ValueBound", b: "ValueBound") -> "ValueBound":
        return ValueBound.computed(a.max_bits + b.max_bits)

    @staticmethod
    def after_div(dividend: "ValueBound", _divisor: "ValueBound") -> "ValueBound":
        return ValueBound.computed(dividend.max_bits)

    @staticmethod
    def after_rem(dividend: "ValueBound", divisor: "ValueBound") -> "ValueBound":
        return ValueBound.computed(min(dividend.max_bits, divisor.max_bits))

    @staticmethod
    def after_and(a: "ValueBound", b: "ValueBound") -> "ValueBound":
        return ValueBound.computed(min(a.max_bits, b.max_bits))

    @staticmethod
    def after_or(a: "ValueBound", b: "ValueBound") -> "ValueBound":
        return ValueBound.computed(max(a.max_bits, b.max_bits))

    @staticmethod
    def after_xor(a: "ValueBound", b: "ValueBound") -> "ValueBound":
        return ValueBound.computed(max(a.max_bits, b.max_bits))

    @staticmethod
    def after_not(_a: "ValueBound", data_bits: int) -> "ValueBound":
        return ValueBound.computed(data_bits)

    @staticmethod
    def after_shl(a: "ValueBound", shift: int, max_bits: int) -> "ValueBound":
        return ValueBound.computed(min(a.max_bits + shift, max_bits))

    @staticmethod
    def after_srl(a: "ValueBound", shift: int) -> "ValueBound":
        return ValueBound.computed(max(a.max_bits - shift, 0))

    @staticmethod
    def after_sra(a: "ValueBound", shift: int, data_bits: int) -> "ValueBound":
        # Conservative: a value already at full width may stay full width
        # because arithmetic shift fills with sign bits (bound.rs:267-275).
        if a.max_bits >= data_bits:
            return ValueBound.computed(data_bits)
        return ValueBound.computed(max(a.max_bits - shift, 0))

    @staticmethod
    def after_cmp() -> "ValueBound":
        return ValueBound.computed(1)

    @staticmethod
    def after_sign_extend(_a: "ValueBound", to_bits: int) -> "ValueBound":
        return ValueBound.computed(to_bits)

    @staticmethod
    def after_zero_extend(a: "ValueBound", to_bits: int) -> "ValueBound":
        return ValueBound.computed(min(a.max_bits, to_bits))

    @staticmethod
    def after_truncate(_a: "ValueBound", to_bits: int) -> "ValueBound":
        return ValueBound.computed(to_bits)
