"""Per-instruction semantic validation.

Parity target: reference ``zkir-spec/src/validation.rs`` — the same error
rules (17-bit immediate range, 21-bit J offsets, shamt <= 63, 4-byte
branch/jump alignment; validation.rs:92-242) and the same warning classes
(write-to-R0, always/never-taken branches, no-ops).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from .isa import Instruction
from .opcodes import (
    Op,
    is_branch,
    is_cmov,
    is_compare,
    is_load,
    is_store,
)

I_TYPE_IMM_MAX = (1 << 16) - 1
I_TYPE_IMM_MIN = -(1 << 16)
B_TYPE_OFFSET_MAX = (1 << 16) - 1
B_TYPE_OFFSET_MIN = -(1 << 16)
J_TYPE_OFFSET_MAX = (1 << 20) - 1
J_TYPE_OFFSET_MIN = -(1 << 20)
MAX_SHIFT_AMOUNT = 63


@dataclass(frozen=True)
class ValidationError:
    kind: str  # "imm_range" | "shamt_range" | "branch_align" | "jump_align"
    message: str


@dataclass(frozen=True)
class ValidationWarning:
    kind: str  # "write_to_r0" | "unconditional_branch" | "noop"
    message: str


@dataclass
class ValidationResult:
    errors: List[ValidationError] = field(default_factory=list)
    warnings: List[ValidationWarning] = field(default_factory=list)

    @property
    def is_valid(self) -> bool:
        return not self.errors

    @property
    def has_warnings(self) -> bool:
        return bool(self.warnings)


_RTYPE_ARITH_LOGICAL = {
    Op.ADD, Op.SUB, Op.MUL, Op.MULH, Op.DIV, Op.DIVU, Op.REM, Op.REMU,
    Op.AND, Op.OR, Op.XOR,
}
_IMM_OPS = {Op.ADDI, Op.ANDI, Op.ORI, Op.XORI, Op.JALR}
_SHIFT_IMM = {Op.SLLI, Op.SRLI, Op.SRAI}
_SHIFT_R = {Op.SLL, Op.SRL, Op.SRA}
_ALWAYS_TAKEN = {Op.BEQ, Op.BGE, Op.BGEU}  # when rs1 == rs2
_NEVER_TAKEN = {Op.BNE, Op.BLT, Op.BLTU}


def validate_instruction(inst: Instruction) -> ValidationResult:
    """Validate one decoded instruction (reference validation.rs:108-242)."""
    result = ValidationResult()
    op = inst.op
    m = inst.mnemonic

    def warn_r0(rd: int) -> None:
        if rd == 0:
            result.warnings.append(
                ValidationWarning("write_to_r0", f"write to r0 in {m}")
            )

    def check_imm(value: int) -> None:
        if not (I_TYPE_IMM_MIN <= value <= I_TYPE_IMM_MAX):
            result.errors.append(ValidationError(
                "imm_range",
                f"immediate {value} out of range "
                f"[{I_TYPE_IMM_MIN}, {I_TYPE_IMM_MAX}] for {m}",
            ))

    if op in _RTYPE_ARITH_LOGICAL:
        warn_r0(inst.rd)
        if inst.rd == 0 and inst.rs1 == 0 and inst.rs2 == 0:
            result.warnings.append(ValidationWarning("noop", f"no-op {m}"))
    elif op in _IMM_OPS:
        warn_r0(inst.rd)
        check_imm(inst.imm)
    elif op in _SHIFT_IMM:
        warn_r0(inst.rd)
        if inst.imm > MAX_SHIFT_AMOUNT:
            result.errors.append(ValidationError(
                "shamt_range",
                f"shift amount {inst.imm} exceeds maximum "
                f"{MAX_SHIFT_AMOUNT} for {m}",
            ))
    elif op in _SHIFT_R or is_compare(op) or is_cmov(op):
        warn_r0(inst.rd)
    elif is_load(op):
        warn_r0(inst.rd)
        check_imm(inst.imm)
    elif is_store(op):
        check_imm(inst.imm)
    elif is_branch(op):
        off = inst.imm
        if not (B_TYPE_OFFSET_MIN <= off <= B_TYPE_OFFSET_MAX):
            result.errors.append(ValidationError(
                "imm_range",
                f"branch offset {off} out of range "
                f"[{B_TYPE_OFFSET_MIN}, {B_TYPE_OFFSET_MAX}]",
            ))
        if off % 4 != 0:
            result.errors.append(ValidationError(
                "branch_align", f"branch offset {off} not 4-byte aligned"
            ))
        if inst.rs1 == inst.rs2:
            if op in _ALWAYS_TAKEN:
                result.warnings.append(ValidationWarning(
                    "unconditional_branch", f"always-taken {m}"
                ))
            elif op in _NEVER_TAKEN:
                result.warnings.append(ValidationWarning(
                    "noop", f"never-taken {m}"
                ))
    elif op == Op.JAL:
        warn_r0(inst.rd)
        off = inst.imm
        if not (J_TYPE_OFFSET_MIN <= off <= J_TYPE_OFFSET_MAX):
            result.errors.append(ValidationError(
                "imm_range",
                f"jal offset {off} out of range "
                f"[{J_TYPE_OFFSET_MIN}, {J_TYPE_OFFSET_MAX}]",
            ))
        if off % 4 != 0:
            result.errors.append(ValidationError(
                "jump_align", f"jal offset {off} not 4-byte aligned"
            ))
    # ECALL / EBREAK: nothing to check

    return result


def validate_program(
    instructions,
) -> List[Tuple[int, ValidationResult]]:
    """Validate a list of instructions; return (index, result) for any
    instruction with errors or warnings (reference validation.rs:245-252)."""
    out = []
    for i, inst in enumerate(instructions):
        result = validate_instruction(inst)
        if result.errors or result.warnings:
            out.append((i, result))
    return out
