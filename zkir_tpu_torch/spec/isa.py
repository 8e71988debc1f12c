"""Host-side decoded-instruction IR.

Host copy of ``zkir_tpu/spec/isa.py``.

Parity target: reference ``zkir-spec/src/instruction.rs`` (the decoded enum)
— here a single dataclass whose operand shape is determined by the opcode.
Only the host toolchain (assembler / disassembler / validation / oracle VM)
uses this type; the interpreter operates on raw u32 words and extracted
bitfields.

Shapes (reference instruction.rs:17-177):
  R-type (arith/logical/shift/compare/cmov): rd, rs1, rs2
  I-type (ADDI/logic-imm/loads/JALR):        rd, rs1, imm   (17-bit signed)
  shift-imm (SLLI/SRLI/SRAI):                rd, rs1, shamt
  S/B-type (stores/branches):                rs1, rs2, imm
  J-type (JAL):                              rd, imm        (21-bit signed)
  system (ECALL/EBREAK):                     no operands
"""

from __future__ import annotations

from dataclasses import dataclass

from . import encoding as enc
from .opcodes import (
    Op,
    OPCODE_NAMES,
    VALID_OPCODES,
    is_branch,
    is_jump,
    is_load,
    is_store,
)
from .registers import reg_name


class DecodeError(ValueError):
    """Unknown opcode or invalid encoding."""


_SHIFT_IMM = {Op.SLLI, Op.SRLI, Op.SRAI}


@dataclass(frozen=True)
class Instruction:
    op: Op
    rd: int = 0
    rs1: int = 0
    rs2: int = 0
    imm: int = 0  # signed immediate / branch offset / jump offset / shamt

    # ---- encode / decode (bit-exact vs reference encoder/decoder) ----

    def encode(self) -> int:
        """Encode to a 32-bit word (reference zkir-assembler/src/encoder.rs:18-151).

        Note JALR encodes as I-type and ECALL/EBREAK as zero-operand I-type
        (encoder.rs:90-94).
        """
        op = self.op
        if op in (Op.ECALL, Op.EBREAK):
            return enc.encode_itype(op, 0, 0, 0)
        if op == Op.JAL:
            return enc.encode_jtype(op, self.rd, self.imm)
        if is_store(op):
            return enc.encode_stype(op, self.rs1, self.rs2, self.imm)
        if is_branch(op):
            return enc.encode_btype(op, self.rs1, self.rs2, self.imm)
        if op == Op.JALR or op in _SHIFT_IMM or is_load(op) or op in (
            Op.ADDI, Op.ANDI, Op.ORI, Op.XORI,
        ):
            return enc.encode_itype(op, self.rd, self.rs1, self.imm)
        # R-type
        return enc.encode_rtype(op, self.rd, self.rs1, self.rs2, 0)

    @staticmethod
    def decode(word: int) -> "Instruction":
        """Decode a 32-bit word (reference zkir-disassembler/src/decoder.rs:20-180)."""
        opv = enc.extract_opcode(word)
        if opv not in VALID_OPCODES:
            # Reference message text: decoder.rs:26 via error.rs:11
            # ("Unknown opcode: 0x{:02X}").
            raise DecodeError(f"Unknown opcode: 0x{opv:02X}")
        op = Op(opv)
        if op in (Op.ECALL, Op.EBREAK):
            return Instruction(op)
        if op == Op.JAL:
            return Instruction(op, rd=enc.extract_rd(word),
                               imm=enc.extract_offset_signed(word))
        if is_store(op) or is_branch(op):
            return Instruction(
                op,
                rs1=enc.extract_stype_rs1(word),
                rs2=enc.extract_stype_rs2(word),
                imm=enc.sign_extend(enc.extract_stype_imm(word), enc.IMM_BITS),
            )
        if op in _SHIFT_IMM:
            # Reference decode_shift takes only the low 8 bits of the imm
            # field as shamt (decoder.rs:134-142).
            return Instruction(op, rd=enc.extract_rd(word),
                               rs1=enc.extract_rs1(word),
                               imm=(word >> enc.IMM_SHIFT) & 0xFF)
        if op == Op.JALR or is_load(op) or op in (Op.ADDI, Op.ANDI, Op.ORI, Op.XORI):
            return Instruction(op, rd=enc.extract_rd(word),
                               rs1=enc.extract_rs1(word),
                               imm=enc.extract_imm_signed(word))
        # R-type
        return Instruction(op, rd=enc.extract_rd(word),
                           rs1=enc.extract_rs1(word),
                           rs2=enc.extract_rs2(word))

    # ---- display ----

    @property
    def mnemonic(self) -> str:
        return OPCODE_NAMES[self.op]

    def format(self) -> str:
        """Assembly text, byte-identical to the reference formatter
        (zkir-disassembler/src/formatter.rs:6-167)."""
        op = self.op
        m = self.mnemonic
        if op in (Op.ECALL, Op.EBREAK):
            return m
        if op == Op.JAL:
            return f"{m} {reg_name(self.rd)}, {self.imm}"
        if op == Op.JALR:
            return f"{m} {reg_name(self.rd)}, {self.imm}({reg_name(self.rs1)})"
        if is_load(op):
            return f"{m} {reg_name(self.rd)}, {self.imm}({reg_name(self.rs1)})"
        if is_store(op):
            return f"{m} {reg_name(self.rs2)}, {self.imm}({reg_name(self.rs1)})"
        if is_branch(op):
            return f"{m} {reg_name(self.rs1)}, {reg_name(self.rs2)}, {self.imm}"
        if op in _SHIFT_IMM or op in (Op.ADDI, Op.ANDI, Op.ORI, Op.XORI):
            return f"{m} {reg_name(self.rd)}, {reg_name(self.rs1)}, {self.imm}"
        return (
            f"{m} {reg_name(self.rd)}, {reg_name(self.rs1)}, {reg_name(self.rs2)}"
        )

    def __str__(self) -> str:
        return self.format()
