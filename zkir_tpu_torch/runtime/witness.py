"""Normalization witnesses (parity: reference normalization_witness.rs)."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

from .normalize import NormalizationResult


class NormalizationCause(enum.Enum):
    OBSERVATION_POINT = "observation_point"
    OVERFLOW = "overflow"
    EXPLICIT = "explicit"


@dataclass(frozen=True)
class NormalizationWitness:
    """Record of one normalization (reference normalization_witness.rs:19-110)."""

    cycle: int
    pc: int
    register: int
    accumulated_limbs: Tuple[int, int]
    normalized_limbs: Tuple[int, int]
    carries: Tuple[int, int]
    normalized_bits: int
    limb_bits: int

    @property
    def has_carries(self) -> bool:
        return self.carries[0] != 0 or self.carries[1] != 0

    def total_carry(self) -> int:
        return self.carries[0] + (self.carries[1] << self.normalized_bits)

    def verify(self) -> bool:
        """Re-run the normalization algorithm and compare — this predicate
        becomes an AIR constraint in the prover
        (reference normalization_witness.rs:83-104)."""
        mask = (1 << self.normalized_bits) - 1
        expected_carry_0 = self.accumulated_limbs[0] >> self.normalized_bits
        expected_norm_0 = self.accumulated_limbs[0] & mask
        if (self.carries[0] != expected_carry_0
                or self.normalized_limbs[0] != expected_norm_0):
            return False
        limb1_with_carry = self.accumulated_limbs[1] + self.carries[0]
        expected_carry_1 = limb1_with_carry >> self.normalized_bits
        expected_norm_1 = limb1_with_carry & mask
        return (self.carries[1] == expected_carry_1
                and self.normalized_limbs[1] == expected_norm_1)


@dataclass(frozen=True)
class NormalizationEvent:
    witness: NormalizationWitness
    cause: NormalizationCause
    triggering_opcode: Optional[int] = None

    @staticmethod
    def observation_point(cycle: int, pc: int, register: int,
                          result: NormalizationResult, normalized_bits: int,
                          limb_bits: int, opcode: int) -> "NormalizationEvent":
        return NormalizationEvent(
            NormalizationWitness(
                cycle, pc, register, result.accumulated, result.normalized,
                result.carries, normalized_bits, limb_bits,
            ),
            NormalizationCause.OBSERVATION_POINT,
            opcode,
        )

    @staticmethod
    def overflow(cycle: int, pc: int, register: int,
                 result: NormalizationResult, normalized_bits: int,
                 limb_bits: int) -> "NormalizationEvent":
        return NormalizationEvent(
            NormalizationWitness(
                cycle, pc, register, result.accumulated, result.normalized,
                result.carries, normalized_bits, limb_bits,
            ),
            NormalizationCause.OVERFLOW,
        )
