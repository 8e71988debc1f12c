"""Carry-extraction normalization for the deferred model.

Parity target: reference ``zkir-runtime/src/normalize.rs`` — the exact
algorithm (normalize.rs:85-105): extract carry from limb0, mask, propagate
into limb1, extract its carry, drop the final carry (two's-complement wrap).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from .state import VMState


@dataclass(frozen=True)
class NormalizationResult:
    accumulated: Tuple[int, int]
    normalized: Tuple[int, int]
    carries: Tuple[int, int]

    @property
    def has_carries(self) -> bool:
        return self.carries[0] != 0 or self.carries[1] != 0

    def total_carry(self) -> int:
        return self.carries[0] + (self.carries[1] << 20)


def _normalize_limbs(accumulated, normalized_bits: int):
    mask = (1 << normalized_bits) - 1
    carry_0 = accumulated[0] >> normalized_bits
    norm_0 = accumulated[0] & mask
    limb1_with_carry = accumulated[1] + carry_0
    carry_1 = limb1_with_carry >> normalized_bits
    norm_1 = limb1_with_carry & mask
    return (norm_0, norm_1), (carry_0, carry_1)


def normalize_register(state: VMState, reg: int, normalized_bits: int,
                       limb_bits: int) -> Optional[NormalizationResult]:
    """Normalize an accumulated register; None if already normalized or R0
    (reference normalize.rs:65-106)."""
    if reg == 0:
        return None
    if state.get_reg_state(reg).is_normalized:
        return None
    accumulated = tuple(state.read_reg_limbs_extended(reg, normalized_bits, limb_bits))
    normalized, carries = _normalize_limbs(accumulated, normalized_bits)
    state.write_reg_from_limbs(reg, normalized, normalized_bits)
    return NormalizationResult(accumulated, normalized, carries)


def normalize_register_for_observation(
    state: VMState, reg: int, normalized_bits: int, limb_bits: int
) -> Optional[NormalizationResult]:
    """Normalize at an observation point — ALWAYS emits a witness even for
    already-normalized registers (reference normalize.rs:121-154)."""
    if reg == 0:
        return None
    accumulated = tuple(state.read_reg_limbs_extended(reg, normalized_bits, limb_bits))
    normalized, carries = _normalize_limbs(accumulated, normalized_bits)
    state.write_reg_from_limbs(reg, normalized, normalized_bits)
    return NormalizationResult(accumulated, normalized, carries)


def normalize_and_write(state: VMState, reg: int, accumulated,
                        normalized_bits: int) -> NormalizationResult:
    """Normalize freshly-computed accumulated limbs directly into a register
    (reference normalize.rs:165-191)."""
    if reg == 0:
        return NormalizationResult((0, 0), (0, 0), (0, 0))
    accumulated = tuple(accumulated)
    normalized, carries = _normalize_limbs(accumulated, normalized_bits)
    state.write_reg_from_limbs(reg, normalized, normalized_bits)
    return NormalizationResult(accumulated, normalized, carries)


def would_overflow(limbs, limb_bits: int) -> bool:
    """True if any accumulated limb exceeds its storage capacity
    (reference normalize.rs:230-233)."""
    limit = 1 << limb_bits
    return limbs[0] >= limit or limbs[1] >= limit


def normalize_if_near_overflow(
    state: VMState, reg: int, normalized_bits: int, limb_bits: int
) -> Optional[NormalizationResult]:
    """Normalize only if the accumulated limbs approach overflow
    (reference normalize.rs:247-271)."""
    if reg == 0:
        return None
    if not state.get_reg_state(reg).needs_normalization:
        return None
    limbs = state.read_reg_limbs_extended(reg, normalized_bits, limb_bits)
    if would_overflow(limbs, limb_bits):
        return normalize_register(state, reg, normalized_bits, limb_bits)
    return None


def normalize_registers(
    state: VMState, regs: List[int], normalized_bits: int, limb_bits: int
):
    """Normalize each accumulated register in the list
    (reference normalize.rs:204-217)."""
    out = []
    for reg in regs:
        if reg == 0:
            continue
        result = normalize_register(state, reg, normalized_bits, limb_bits)
        if result is not None:
            out.append((reg, result))
    return out
