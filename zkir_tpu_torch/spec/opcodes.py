"""Opcode tables for the 50-instruction ZK-IR v3.4 ISA.

Host copy of ``zkir_tpu/spec/opcodes.py``.

Parity target: reference ``zkir-spec/src/opcode.rs:24-144`` (banked 7-bit
opcode numbering) and the family predicates at ``opcode.rs:242-453``.

Besides the scalar predicates, this module exports dense numpy lookup tables
(``FAMILY_TABLE``, ``IS_*_TABLE``) indexed by the raw 7-bit opcode value.
The host toolchain classifies instructions with them; the interpreter's
kernel decodes the opcode itself.
"""

from __future__ import annotations

import enum

import numpy as np


class Op(enum.IntEnum):
    """7-bit opcode values (reference opcode.rs:24-144)."""

    # Arithmetic 0x00-0x08
    ADD = 0x00
    SUB = 0x01
    MUL = 0x02
    MULH = 0x03
    DIVU = 0x04
    REMU = 0x05
    DIV = 0x06
    REM = 0x07
    ADDI = 0x08
    # Logical 0x10-0x15
    AND = 0x10
    OR = 0x11
    XOR = 0x12
    ANDI = 0x13
    ORI = 0x14
    XORI = 0x15
    # Shift 0x18-0x1D
    SLL = 0x18
    SRL = 0x19
    SRA = 0x1A
    SLLI = 0x1B
    SRLI = 0x1C
    SRAI = 0x1D
    # Compare 0x20-0x25
    SLTU = 0x20
    SGEU = 0x21
    SLT = 0x22
    SGE = 0x23
    SEQ = 0x24
    SNE = 0x25
    # Conditional move 0x26-0x28
    CMOV = 0x26
    CMOVZ = 0x27
    CMOVNZ = 0x28
    # Load 0x30-0x35
    LB = 0x30
    LBU = 0x31
    LH = 0x32
    LHU = 0x33
    LW = 0x34
    LD = 0x35
    # Store 0x38-0x3B
    SB = 0x38
    SH = 0x39
    SW = 0x3A
    SD = 0x3B
    # Branch 0x40-0x45
    BEQ = 0x40
    BNE = 0x41
    BLT = 0x42
    BGE = 0x43
    BLTU = 0x44
    BGEU = 0x45
    # Jump 0x48-0x49
    JAL = 0x48
    JALR = 0x49
    # System 0x50-0x51
    ECALL = 0x50
    EBREAK = 0x51


class Family(enum.IntEnum):
    """Instruction family selector classes (reference opcode.rs:515-566)."""

    ARITHMETIC = 0
    LOGICAL = 1
    SHIFT = 2
    COMPARE = 3
    CMOV = 4
    LOAD = 5
    STORE = 6
    BRANCH = 7
    JUMP = 8
    SYSTEM = 9

    COUNT = 10


# Display mnemonics (reference opcode.rs:456-511).
OPCODE_NAMES = {op: op.name.lower() for op in Op}

VALID_OPCODES = frozenset(int(op) for op in Op)

_ARITH = {Op.ADD, Op.SUB, Op.MUL, Op.MULH, Op.DIVU, Op.REMU, Op.DIV, Op.REM, Op.ADDI}
_LOGICAL = {Op.AND, Op.OR, Op.XOR, Op.ANDI, Op.ORI, Op.XORI}
_SHIFT = {Op.SLL, Op.SRL, Op.SRA, Op.SLLI, Op.SRLI, Op.SRAI}
_COMPARE = {Op.SLTU, Op.SGEU, Op.SLT, Op.SGE, Op.SEQ, Op.SNE}
_CMOV = {Op.CMOV, Op.CMOVZ, Op.CMOVNZ}
_LOAD = {Op.LB, Op.LBU, Op.LH, Op.LHU, Op.LW, Op.LD}
_STORE = {Op.SB, Op.SH, Op.SW, Op.SD}
_BRANCH = {Op.BEQ, Op.BNE, Op.BLT, Op.BGE, Op.BLTU, Op.BGEU}
_JUMP = {Op.JAL, Op.JALR}
_SYSTEM = {Op.ECALL, Op.EBREAK}

# I-type set per reference opcode.rs:333-357 (uses_immediate) and
# encoding.rs:229-243 (is_itype).
_USES_IMM = {
    Op.ADDI, Op.ANDI, Op.ORI, Op.XORI, Op.SLLI, Op.SRLI, Op.SRAI,
    Op.LB, Op.LBU, Op.LH, Op.LHU, Op.LW, Op.LD,
    Op.SB, Op.SH, Op.SW, Op.SD, Op.JALR,
}


def is_arithmetic(op: int) -> bool:
    return op in _ARITH


def is_logical(op: int) -> bool:
    return op in _LOGICAL


def is_shift(op: int) -> bool:
    return op in _SHIFT


def is_compare(op: int) -> bool:
    return op in _COMPARE


def is_cmov(op: int) -> bool:
    return op in _CMOV


def is_load(op: int) -> bool:
    return op in _LOAD


def is_store(op: int) -> bool:
    return op in _STORE


def is_branch(op: int) -> bool:
    return op in _BRANCH


def is_jump(op: int) -> bool:
    return op in _JUMP


def is_system(op: int) -> bool:
    return op in _SYSTEM


def uses_immediate(op: int) -> bool:
    return op in _USES_IMM


def family_of(op: int) -> Family:
    """Family of a valid opcode (reference opcode.rs:361-383)."""
    if op in _ARITH:
        return Family.ARITHMETIC
    if op in _LOGICAL:
        return Family.LOGICAL
    if op in _SHIFT:
        return Family.SHIFT
    if op in _COMPARE:
        return Family.COMPARE
    if op in _CMOV:
        return Family.CMOV
    if op in _LOAD:
        return Family.LOAD
    if op in _STORE:
        return Family.STORE
    if op in _BRANCH:
        return Family.BRANCH
    if op in _JUMP:
        return Family.JUMP
    if op in _SYSTEM:
        return Family.SYSTEM
    raise ValueError(f"invalid opcode: {op:#x}")


def _build_tables():
    """Dense per-opcode lookup tables over the 7-bit opcode space.

    FAMILY_TABLE[op] = family index, or -1 for invalid opcodes.
    """
    fam = np.full(128, -1, dtype=np.int32)
    valid = np.zeros(128, dtype=bool)
    imm = np.zeros(128, dtype=bool)
    for op in Op:
        fam[int(op)] = int(family_of(int(op)))
        valid[int(op)] = True
        imm[int(op)] = int(op) in {int(o) for o in _USES_IMM}
    return fam, valid, imm


FAMILY_TABLE, VALID_TABLE, USES_IMM_TABLE = _build_tables()
