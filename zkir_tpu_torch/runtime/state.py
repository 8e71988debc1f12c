"""VM state: PC, 16 registers with bounds and Normalized/Accumulated flags.

Parity target: reference ``zkir-runtime/src/state.rs`` (register file, R0
hardwiring, limb pack/unpack helpers) and ``register_state.rs`` (per-register
storage-state flags).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

from ..spec.bounds import ValueBound

NUM_REGISTERS = 16
_U64 = (1 << 64) - 1


class HaltReason(enum.Enum):
    EBREAK = "ebreak"
    EXIT = "exit"
    CYCLE_LIMIT = "cycle_limit"


@dataclass(frozen=True)
class Halt:
    reason: HaltReason
    code: int = 0  # exit code for EXIT

    def __eq__(self, other):
        if isinstance(other, Halt):
            return self.reason == other.reason and self.code == other.code
        return NotImplemented


class RegState(enum.IntEnum):
    """Register storage state for the deferred carry model
    (reference register_state.rs:18-50)."""

    NORMALIZED = 0
    ACCUMULATED = 1

    @property
    def is_normalized(self) -> bool:
        return self == RegState.NORMALIZED

    @property
    def needs_normalization(self) -> bool:
        return self == RegState.ACCUMULATED


class VMState:
    def __init__(self, entry_point: int, data_bits: int = 40):
        self.pc = entry_point
        self.regs: List[int] = [0] * NUM_REGISTERS
        # All bounds default to program width; R0 is constant zero
        # (reference state.rs:55-70).
        self.bounds: List[ValueBound] = (
            [ValueBound.from_constant(0)]
            + [ValueBound.from_program_width(data_bits)] * (NUM_REGISTERS - 1)
        )
        self.reg_states: List[RegState] = [RegState.NORMALIZED] * NUM_REGISTERS
        self.cycles = 0
        self.halt_reason: Optional[Halt] = None

    # ---- register access (state.rs:76-113) ----

    def read_reg(self, reg: int) -> int:
        return 0 if reg == 0 else self.regs[reg]

    def write_reg(self, reg: int, value: int) -> None:
        if reg != 0:
            self.regs[reg] = value & _U64

    def read_bound(self, reg: int) -> ValueBound:
        return self.bounds[reg]

    def write_bound(self, reg: int, bound: ValueBound) -> None:
        if reg != 0:
            self.bounds[reg] = bound

    def write_reg_with_bound(self, reg: int, value: int, bound: ValueBound) -> None:
        self.write_reg(reg, value)
        self.write_bound(reg, bound)

    # ---- halt / cycles / pc ----

    @property
    def is_halted(self) -> bool:
        return self.halt_reason is not None

    def halt(self, reason: HaltReason, code: int = 0) -> None:
        self.halt_reason = Halt(reason, code)

    def inc_cycles(self) -> None:
        self.cycles += 1

    def advance_pc(self, offset: int) -> None:
        self.pc = (self.pc + offset) & _U64

    # ---- register storage state (register_state.rs:65-118) ----

    def get_reg_state(self, reg: int) -> RegState:
        return RegState.NORMALIZED if reg == 0 else self.reg_states[reg]

    def mark_normalized(self, reg: int) -> None:
        if reg != 0:
            self.reg_states[reg] = RegState.NORMALIZED

    def mark_accumulated(self, reg: int) -> None:
        if reg != 0:
            self.reg_states[reg] = RegState.ACCUMULATED

    # ---- deferred-carry limb helpers (state.rs:149-261) ----

    def read_reg_as_limbs(self, reg: int, normalized_bits: int) -> List[int]:
        value = self.read_reg(reg)
        mask = (1 << normalized_bits) - 1
        return [value & mask, (value >> normalized_bits) & mask]

    def write_reg_from_limbs(self, reg: int, limbs, normalized_bits: int) -> None:
        if reg != 0:
            value = (limbs[0] | (limbs[1] << normalized_bits)) & _U64
            self.write_reg(reg, value)
            self.mark_normalized(reg)

    def write_reg_from_accumulated(self, reg: int, limbs, limb_bits: int) -> None:
        if reg != 0:
            value = (limbs[0] | (limbs[1] << limb_bits)) & _U64
            self.write_reg(reg, value)
            self.mark_accumulated(reg)

    def read_reg_limbs_extended(self, reg: int, normalized_bits: int,
                                limb_bits: int) -> List[int]:
        value = self.read_reg(reg)
        bits = normalized_bits if self.get_reg_state(reg).is_normalized else limb_bits
        mask = (1 << bits) - 1
        return [value & mask, (value >> bits) & mask]

    def get_normalized_regs(self, normalized_bits: int, limb_bits: int) -> List[int]:
        """All registers in normalized 40-bit form for trace capture
        (reference state.rs:230-261)."""
        out = []
        for reg in range(NUM_REGISTERS):
            value = self.read_reg(reg)
            if self.get_reg_state(reg).is_normalized:
                out.append(value)
            else:
                mask = (1 << limb_bits) - 1
                limb0 = value & mask
                limb1 = (value >> limb_bits) & mask
                value_60 = limb0 | (limb1 << limb_bits)
                out.append(value_60 & ((1 << 40) - 1))
        return out
