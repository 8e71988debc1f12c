"""Canonical 32-bit instruction bit layout.

Host copy of ``zkir_tpu/spec/encoding.py``.

Parity target: reference ``zkir-spec/src/encoding.rs:23-66`` (field positions)
and ``:98-205`` (extract/encode helpers).  The exact layout:

    R-type: [opcode:7][rd:4][rs1:4][rs2:4][funct:13]
    I-type: [opcode:7][rd:4][rs1:4][imm:17]
    S/B:    [opcode:7][rs1:4][rs2:4][imm:17]   (rs1 sits at the rd position)
    J-type: [opcode:7][rd:4][offset:21]

All helpers accept either Python ints or numpy arrays.
"""

from __future__ import annotations

OPCODE_SHIFT = 0
RD_SHIFT = 7
RS1_SHIFT = 11
RS2_SHIFT = 15
IMM_SHIFT = 15
FUNCT_SHIFT = 19
OFFSET_SHIFT = 11

OPCODE_MASK = 0x7F
REGISTER_MASK = 0xF
IMM_MASK = 0x1FFFF
FUNCT_MASK = 0x1FFF
OFFSET_MASK = 0x1FFFFF

IMM_SIGN_BIT = 16
IMM_BITS = 17
OFFSET_BITS = 21


def extract_opcode(word):
    return word & OPCODE_MASK


def extract_rd(word):
    return (word >> RD_SHIFT) & REGISTER_MASK


def extract_rs1(word):
    return (word >> RS1_SHIFT) & REGISTER_MASK


def extract_rs2(word):
    return (word >> RS2_SHIFT) & REGISTER_MASK


def extract_imm(word):
    return (word >> IMM_SHIFT) & IMM_MASK


def extract_funct(word):
    return (word >> FUNCT_SHIFT) & FUNCT_MASK


def extract_offset(word):
    return (word >> OFFSET_SHIFT) & OFFSET_MASK


def sign_extend(value, bits: int):
    """Sign-extend an unsigned ``bits``-wide field (works on ints and arrays)."""
    sign = 1 << (bits - 1)
    return (value ^ sign) - sign


def extract_imm_signed(word):
    """17-bit signed immediate (reference encoding.rs:103-112)."""
    return sign_extend(extract_imm(word), IMM_BITS)


def extract_offset_signed(word):
    """21-bit signed J-type offset (reference encoding.rs:127-136)."""
    return sign_extend(extract_offset(word), OFFSET_BITS)


# S/B-type field positions (reference encoding.rs:142-159): rs1 at rd position.
def extract_stype_rs1(word):
    return (word >> RD_SHIFT) & REGISTER_MASK


def extract_stype_rs2(word):
    return (word >> RS1_SHIFT) & REGISTER_MASK


def extract_stype_imm(word):
    return (word >> IMM_SHIFT) & IMM_MASK


_U32 = 0xFFFFFFFF


def encode_rtype(opcode: int, rd: int, rs1: int, rs2: int, funct: int = 0) -> int:
    return (
        (opcode & OPCODE_MASK)
        | ((rd & REGISTER_MASK) << RD_SHIFT)
        | ((rs1 & REGISTER_MASK) << RS1_SHIFT)
        | ((rs2 & REGISTER_MASK) << RS2_SHIFT)
        | ((funct & FUNCT_MASK) << FUNCT_SHIFT)
    ) & _U32


def encode_itype(opcode: int, rd: int, rs1: int, imm: int) -> int:
    return (
        (opcode & OPCODE_MASK)
        | ((rd & REGISTER_MASK) << RD_SHIFT)
        | ((rs1 & REGISTER_MASK) << RS1_SHIFT)
        | ((imm & IMM_MASK) << IMM_SHIFT)
    ) & _U32


def encode_stype(opcode: int, rs1: int, rs2: int, imm: int) -> int:
    return (
        (opcode & OPCODE_MASK)
        | ((rs1 & REGISTER_MASK) << RD_SHIFT)
        | ((rs2 & REGISTER_MASK) << RS1_SHIFT)
        | ((imm & IMM_MASK) << IMM_SHIFT)
    ) & _U32


def encode_btype(opcode: int, rs1: int, rs2: int, offset: int) -> int:
    return encode_stype(opcode, rs1, rs2, offset)


def encode_jtype(opcode: int, rd: int, offset: int) -> int:
    return (
        (opcode & OPCODE_MASK)
        | ((rd & REGISTER_MASK) << RD_SHIFT)
        | ((offset & OFFSET_MASK) << OFFSET_SHIFT)
    ) & _U32
