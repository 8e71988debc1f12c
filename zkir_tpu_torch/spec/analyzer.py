"""Static range-check placement analysis.

Reimplementation of the reference's *orphaned* analyzer
(``zkir-spec/src/analyzer.rs`` — 370 LoC of dead code: not declared in
lib.rs and referencing a ``BoundAnalysis``/``FIELD_BITS`` API that no
longer exists).  Per SURVEY §2.1, the *algorithm* (analyzer.rs:10-30) is
reimplemented here against the live ``ValueBound`` API:

1. initialize all register bounds to the program width (unknown caller
   state), r0 to the constant-zero bound;
2. walk instructions in order, propagating bounds with the live rules;
3. mark mandatory check sites — syscall returns, memory loads, memory
   store / jalr target addresses with oversized bounds, division
   quotients, and any write whose bound exceeds the program width;
4. return per-site masks plus elision statistics.

The output feeds the prover as static selector masks (check-site columns)
— no per-row dynamic decisions on device.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .bounds import ValueBound
from .isa import Instruction
from .opcodes import Op, is_branch, is_cmov, is_compare, is_load, is_store


class RangeCheckReason(enum.Enum):
    OVERFLOW = "overflow"
    DIVISION_QUOTIENT = "division_quotient"
    MEMORY_LOAD = "memory_load"
    MEMORY_STORE_ADDRESS = "memory_store_address"
    EXTERNAL_INPUT = "external_input"


@dataclass
class BoundAnalysis:
    """Result of the static analysis."""

    data_bits: int
    # (instruction index, register, reason) for each required check.
    required_checks: List[Tuple[int, int, RangeCheckReason]] = field(
        default_factory=list)
    # Per-instruction post-state register bounds (max_bits).
    bounds_after: List[List[int]] = field(default_factory=list)
    instructions: int = 0
    elided: int = 0

    def require_check(self, pc_index: int, reg: int,
                      reason: RangeCheckReason) -> None:
        self.required_checks.append((pc_index, reg, reason))

    @property
    def check_count(self) -> int:
        return len(self.required_checks)

    @property
    def elision_ratio(self) -> float:
        if self.instructions == 0:
            return 0.0
        return 1.0 - self.check_count / self.instructions

    def check_mask(self) -> List[bool]:
        """Static per-instruction needs-check mask (for selector columns)."""
        mask = [False] * self.instructions
        for pc_index, _, _ in self.required_checks:
            mask[pc_index] = True
        return mask


_LOAD_BITS = {Op.LB: 8, Op.LBU: 8, Op.LH: 16, Op.LHU: 16, Op.LW: 32, Op.LD: 40}


def analyze_program(instructions: List[Instruction],
                    data_bits: int = 40) -> BoundAnalysis:
    analysis = BoundAnalysis(data_bits=data_bits)
    bounds: List[ValueBound] = (
        [ValueBound.from_constant(0)]
        + [ValueBound.from_program_width(data_bits)] * 15
    )

    def get(reg: int) -> ValueBound:
        return bounds[reg]

    def put(reg: int, bound: ValueBound) -> None:
        if reg != 0:
            bounds[reg] = bound

    def check_overflow(pc_index: int, reg: int, bound: ValueBound) -> None:
        if bound.needs_range_check(data_bits):
            analysis.require_check(pc_index, reg, RangeCheckReason.OVERFLOW)
        else:
            analysis.elided += 1

    for pc_index, inst in enumerate(instructions):
        analysis.instructions += 1
        op = inst.op
        rd, rs1, rs2 = inst.rd, inst.rs1, inst.rs2

        if op == Op.ADD:
            bound = ValueBound.after_add(get(rs1), get(rs2))
            put(rd, bound)
            check_overflow(pc_index, rd, bound)
        elif op == Op.SUB:
            put(rd, ValueBound.after_sub(get(rs1), get(rs2)))
            analysis.elided += 1
        elif op == Op.MUL:
            bound = ValueBound.after_mul(get(rs1), get(rs2))
            put(rd, bound)
            check_overflow(pc_index, rd, bound)
        elif op == Op.MULH:
            put(rd, ValueBound.from_program_width(data_bits))
            analysis.elided += 1
        elif op in (Op.DIV, Op.DIVU):
            put(rd, ValueBound.after_div(
                get(rs1), ValueBound.from_program_width(data_bits)))
            analysis.require_check(pc_index, rd,
                                   RangeCheckReason.DIVISION_QUOTIENT)
        elif op in (Op.REM, Op.REMU):
            put(rd, ValueBound.after_rem(get(rs1), get(rs2)))
            analysis.elided += 1
        elif op == Op.ADDI:
            imm_bound = ValueBound.from_constant(abs(inst.imm))
            bound = ValueBound.after_add(get(rs1), imm_bound)
            put(rd, bound)
            check_overflow(pc_index, rd, bound)
        elif op == Op.AND:
            put(rd, ValueBound.after_and(get(rs1), get(rs2)))
            analysis.elided += 1
        elif op == Op.OR:
            put(rd, ValueBound.after_or(get(rs1), get(rs2)))
            analysis.elided += 1
        elif op == Op.XOR:
            put(rd, ValueBound.after_xor(get(rs1), get(rs2)))
            analysis.elided += 1
        elif op == Op.ANDI:
            put(rd, ValueBound.after_and(
                get(rs1), ValueBound.from_constant(inst.imm & ((1 << 64) - 1))))
            analysis.elided += 1
        elif op == Op.ORI:
            put(rd, ValueBound.after_or(
                get(rs1), ValueBound.from_constant(inst.imm & ((1 << 64) - 1))))
            analysis.elided += 1
        elif op == Op.XORI:
            put(rd, ValueBound.after_xor(
                get(rs1), ValueBound.from_constant(inst.imm & ((1 << 64) - 1))))
            analysis.elided += 1
        elif op == Op.SLL:
            # Shift amount unknown: worst case fills the program width.
            bound = ValueBound.after_shl(get(rs1), data_bits, data_bits)
            put(rd, bound)
            check_overflow(pc_index, rd, bound)
        elif op in (Op.SRL, Op.SRA):
            put(rd, ValueBound.after_srl(get(rs1), 1))
            analysis.elided += 1
        elif op == Op.SLLI:
            bound = ValueBound.after_shl(get(rs1), inst.imm, data_bits)
            put(rd, bound)
            check_overflow(pc_index, rd, bound)
        elif op in (Op.SRLI, Op.SRAI):
            put(rd, ValueBound.after_srl(get(rs1), inst.imm))
            analysis.elided += 1
        elif is_compare(op):
            put(rd, ValueBound.after_cmp())
            analysis.elided += 1
        elif is_cmov(op):
            put(rd, ValueBound.computed(
                max(get(rd).max_bits, get(rs1).max_bits)))
        elif is_load(op):
            put(rd, ValueBound.from_type_width(_LOAD_BITS[op]))
            analysis.require_check(pc_index, rd, RangeCheckReason.MEMORY_LOAD)
        elif is_store(op):
            if get(rs1).needs_range_check(data_bits):
                analysis.require_check(
                    pc_index, rs1, RangeCheckReason.MEMORY_STORE_ADDRESS)
            else:
                analysis.elided += 1
        elif is_branch(op):
            analysis.elided += 1
        elif op == Op.JAL:
            put(rd, ValueBound.from_program_width(data_bits))
            analysis.elided += 1
        elif op == Op.JALR:
            put(rd, ValueBound.from_program_width(data_bits))
            if get(rs1).needs_range_check(data_bits):
                analysis.require_check(
                    pc_index, rs1, RangeCheckReason.MEMORY_STORE_ADDRESS)
            else:
                analysis.elided += 1
        elif op == Op.ECALL:
            # Syscall results land in R10 from an external source
            # (runtime convention, syscall.rs:94-97).
            put(10, ValueBound.from_program_width(data_bits))
            analysis.require_check(pc_index, 10,
                                   RangeCheckReason.EXTERNAL_INPUT)
        elif op == Op.EBREAK:
            analysis.elided += 1

        analysis.bounds_after.append([b.max_bits for b in bounds])

    return analysis
