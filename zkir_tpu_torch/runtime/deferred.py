"""Deferred-carry (30+30) arithmetic.

Parity target: reference ``zkir-runtime/src/deferred.rs`` — element-wise
limb add/sub without carry extraction, forced pre-normalization when a limb
would exceed 2^limb_bits (deferred.rs:81-274).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..spec.bounds import ValueBound
from .normalize import normalize_register, would_overflow
from .range_check import RangeCheckTracker
from .state import VMState


@dataclass(frozen=True)
class DeferredConfig:
    """30+30 deferred model config (reference deferred.rs:33-67)."""

    normalized_bits: int = 20
    limb_bits: int = 30

    @property
    def headroom_bits(self) -> int:
        return self.limb_bits - self.normalized_bits

    @property
    def max_deferred_ops(self) -> int:
        return 1 << self.headroom_bits


_U64 = (1 << 64) - 1


def execute_add_deferred(state: VMState, rd: int, rs1: int, rs2: int,
                         config: DeferredConfig,
                         range_checker: RangeCheckTracker | None) -> None:
    """ADD with deferred carry (reference deferred.rs:81-138)."""
    nb, lb = config.normalized_bits, config.limb_bits
    limbs_a = state.read_reg_limbs_extended(rs1, nb, lb)
    limbs_b = state.read_reg_limbs_extended(rs2, nb, lb)
    result = [limbs_a[0] + limbs_b[0], limbs_a[1] + limbs_b[1]]

    if would_overflow(result, lb):
        # Force normalization of sources (no witness), then recompute.
        normalize_register(state, rs1, nb, lb)
        normalize_register(state, rs2, nb, lb)
        limbs_a = state.read_reg_limbs_extended(rs1, nb, lb)
        limbs_b = state.read_reg_limbs_extended(rs2, nb, lb)
        result = [limbs_a[0] + limbs_b[0], limbs_a[1] + limbs_b[1]]

    state.write_reg_from_accumulated(rd, result, lb)

    bound = ValueBound.after_add(state.read_bound(rs1), state.read_bound(rs2))
    state.write_bound(rd, bound)
    # Range-check integration for deferred results happens at normalization
    # time (matching the reference's TODO at deferred.rs:128-134).
    state.advance_pc(4)


def execute_sub_deferred(state: VMState, rd: int, rs1: int, rs2: int,
                         config: DeferredConfig,
                         range_checker: RangeCheckTracker | None) -> None:
    """SUB with deferred borrow (reference deferred.rs:163-206): plain
    element-wise wrapping u64 subtraction — field constraints absorb the
    wrap-around."""
    nb, lb = config.normalized_bits, config.limb_bits
    limbs_a = state.read_reg_limbs_extended(rs1, nb, lb)
    limbs_b = state.read_reg_limbs_extended(rs2, nb, lb)
    result = [
        (limbs_a[0] - limbs_b[0]) & _U64,
        (limbs_a[1] - limbs_b[1]) & _U64,
    ]
    state.write_reg_from_accumulated(rd, result, lb)

    bound = ValueBound.after_sub(state.read_bound(rs1), state.read_bound(rs2))
    state.write_bound(rd, bound)
    state.advance_pc(4)


def execute_addi_deferred(state: VMState, rd: int, rs1: int, imm: int,
                          config: DeferredConfig,
                          range_checker: RangeCheckTracker | None) -> None:
    """ADDI with deferred carry (reference deferred.rs:220-274).

    ``imm`` is the sign-extended immediate reinterpreted as u64 (the
    reference passes ``*imm as u64``).
    """
    nb, lb = config.normalized_bits, config.limb_bits
    imm &= _U64
    limbs_a = state.read_reg_limbs_extended(rs1, nb, lb)
    nmask = (1 << nb) - 1
    imm_limbs = [imm & nmask, (imm >> nb) & nmask]
    result = [limbs_a[0] + imm_limbs[0], limbs_a[1] + imm_limbs[1]]

    if would_overflow(result, lb):
        normalize_register(state, rs1, nb, lb)
        limbs_a = state.read_reg_limbs_extended(rs1, nb, lb)
        result = [limbs_a[0] + imm_limbs[0], limbs_a[1] + imm_limbs[1]]

    state.write_reg_from_accumulated(rd, result, lb)

    bound = ValueBound.after_add(
        state.read_bound(rs1), ValueBound.from_constant(imm)
    )
    state.write_bound(rd, bound)
    state.advance_pc(4)
