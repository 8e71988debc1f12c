"""Variable-limb value semantics (host reference implementation).

Parity target: reference ``zkir-spec/src/value.rs`` — the ``Value`` trait
surface and ``GenericValue<LIMB_BITS, NUM_LIMBS>`` (value.rs:145-474), with
the legacy 2x20-bit ``Value40`` as the default instantiation
(value.rs:522-771).

A ``GenericValue`` instance is a *class factory*: ``GenericValue(20, 2)``
returns the value class for that limb geometry; classes are cached so
identity comparisons work.  Host copy of ``zkir_tpu/spec/values.py``.
In the batched interpreter these semantics appear as limb arithmetic; this host type is the oracle for limb-
geometry edge cases (overflow, cross-limb carries, shifts).
"""

from __future__ import annotations

import functools
from typing import List


@functools.lru_cache(maxsize=None)
def GenericValue(limb_bits: int, num_limbs: int):
    """Build (and cache) the value class for a limb geometry."""

    total_bits = limb_bits * num_limbs
    limb_mask = (1 << limb_bits) - 1
    total_mask = (1 << total_bits) - 1

    class _Value:
        LIMB_BITS = limb_bits
        NUM_LIMBS = num_limbs
        TOTAL_BITS = total_bits
        LIMB_MASK = limb_mask

        __slots__ = ("limbs",)

        def __init__(self, limbs: List[int]):
            assert len(limbs) == num_limbs
            self.limbs = [l & limb_mask for l in limbs]

        # ---- conversions (value.rs:201-253) ----

        @classmethod
        def from_int(cls, val: int) -> "_Value":
            limbs = []
            remaining = val & total_mask
            for _ in range(num_limbs):
                limbs.append(remaining & limb_mask)
                remaining >>= limb_bits
            return cls(limbs)

        # from_u64 truncates input to 64 bits first (value.rs:231-241).
        @classmethod
        def from_u64(cls, val: int) -> "_Value":
            return cls.from_int(val & ((1 << 64) - 1))

        def to_int(self) -> int:
            result = 0
            for i, limb in enumerate(self.limbs):
                result |= limb << (i * limb_bits)
            return result

        def to_u64(self) -> int:
            # Truncates if wider than 64 bits (value.rs:201-214).
            result = 0
            shift = 0
            for limb in self.limbs:
                if shift >= 64:
                    break
                result |= limb << shift
                shift += limb_bits
            return result & ((1 << 64) - 1)

        @classmethod
        def from_limbs(cls, limbs: List[int]) -> "_Value":
            assert len(limbs) >= num_limbs
            return cls(list(limbs[:num_limbs]))

        @classmethod
        def zero(cls) -> "_Value":
            return cls([0] * num_limbs)

        @classmethod
        def max_value(cls) -> "_Value":
            return cls([limb_mask] * num_limbs)

        # ---- arithmetic (wrap at TOTAL_BITS; value.rs:303-326) ----

        def wrapping_add(self, rhs: "_Value") -> "_Value":
            return type(self).from_int(self.to_int() + rhs.to_int())

        def wrapping_sub(self, rhs: "_Value") -> "_Value":
            return type(self).from_int(self.to_int() - rhs.to_int())

        def wrapping_mul(self, rhs: "_Value") -> "_Value":
            return type(self).from_int(self.to_int() * rhs.to_int())

        # ---- bitwise (per-limb; value.rs:328-362) ----

        def bitwise_and(self, rhs: "_Value") -> "_Value":
            return type(self)([a & b for a, b in zip(self.limbs, rhs.limbs)])

        def bitwise_or(self, rhs: "_Value") -> "_Value":
            return type(self)([a | b for a, b in zip(self.limbs, rhs.limbs)])

        def bitwise_xor(self, rhs: "_Value") -> "_Value":
            return type(self)([a ^ b for a, b in zip(self.limbs, rhs.limbs)])

        def bitwise_not(self) -> "_Value":
            return type(self)([(~l) & limb_mask for l in self.limbs])

        # ---- shifts (value.rs / value.rs:658-697) ----

        def left_shift(self, shift: int) -> "_Value":
            if shift >= total_bits:
                return type(self).zero()
            return type(self).from_int(self.to_int() << shift)

        def right_shift(self, shift: int) -> "_Value":
            if shift >= total_bits:
                return type(self).zero()
            return type(self).from_int(self.to_int() >> shift)

        def arithmetic_right_shift(self, shift: int, data_bits: int) -> "_Value":
            val = self.to_int()
            sign_bit = 1 << (data_bits - 1)
            negative = (val & sign_bit) != 0
            if shift >= data_bits:
                return (type(self).from_int((1 << data_bits) - 1)
                        if negative else type(self).zero())
            shifted = val >> shift
            if negative:
                fill = ((1 << shift) - 1) << (data_bits - shift)
                return type(self).from_int(shifted | fill)
            return type(self).from_int(shifted)

        # ---- comparisons (value.rs:699-721) ----

        def unsigned_lt(self, rhs: "_Value") -> bool:
            return self.to_int() < rhs.to_int()

        def unsigned_le(self, rhs: "_Value") -> bool:
            return self.to_int() <= rhs.to_int()

        def signed_lt(self, rhs: "_Value", data_bits: int) -> bool:
            sign = 1 << (data_bits - 1)
            return (self.to_int() ^ sign) < (rhs.to_int() ^ sign)

        # ---- extension / truncation (value.rs:730-770) ----

        def sign_bit(self, data_bits: int) -> bool:
            return (self.to_int() >> (data_bits - 1)) & 1 == 1

        def sign_extend(self, from_bits: int, to_bits: int) -> "_Value":
            val = self.to_int()
            if (val >> (from_bits - 1)) & 1:
                mask = ((1 << to_bits) - 1) ^ ((1 << from_bits) - 1)
                return type(self).from_int(val | mask)
            return self

        def zero_extend(self, from_bits: int) -> "_Value":
            return type(self).from_int(self.to_int() & ((1 << from_bits) - 1))

        def truncate(self, to_bits: int) -> "_Value":
            return type(self).from_int(self.to_int() & ((1 << to_bits) - 1))

        # ---- predicates ----

        def is_zero(self) -> bool:
            return all(l == 0 for l in self.limbs)

        def fits_in(self, bits: int) -> bool:
            if bits >= total_bits:
                return True
            return self.to_int() <= (1 << bits) - 1

        def __eq__(self, other) -> bool:
            return isinstance(other, _Value) and self.limbs == other.limbs

        def __hash__(self) -> int:
            return hash(tuple(self.limbs))

        def __repr__(self) -> str:
            inner = ", ".join(f"{l:#x}" for l in self.limbs)
            return f"GenericValue<{limb_bits}, {num_limbs}>({inner})"

    _Value.__name__ = f"Value{total_bits}"
    _Value.__qualname__ = _Value.__name__
    return _Value


# Common aliases (value.rs:498-511).
Value40 = GenericValue(20, 2)
Value60 = GenericValue(20, 3)
Value80 = GenericValue(20, 4)
Value30 = GenericValue(15, 2)
Value64 = GenericValue(32, 2)
