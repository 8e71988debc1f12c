"""Two-pass assembler: text -> Program.

Host copy of ``zkir_tpu/asm/assembler.py``.

Parity target: reference ``zkir-assembler/src/assembler.rs`` — identical
grammar: per-mnemonic operand shapes with exact token-count checks
(assembler.rs:236-497), ``.config limb_bits/data_limbs/addr_limbs``
directives (assembler.rs:127-186), ``#`` comments, labels collected at
``pc = CODE_BASE + 4*i`` (assembler.rs:94-124).

Deliberate extension over the reference (whose second pass never uses the
label table — assembler.rs:198-209): branch/jump offset operands may be a
label name, resolved to the *relative byte offset* from the instruction.
Numeric-offset source assembles bit-identically to the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..spec.config import Config, ConfigError
from ..spec.isa import Instruction
from ..spec.memlayout import CODE_BASE
from ..spec.opcodes import Op
from ..spec.program import Program
from ..spec.registers import reg_from_name
from .lexer import LexError, Token, tokenize


class AssemblerError(ValueError):
    """Line-numbered assembler error whose display text matches the
    reference's ``AssemblerError`` enum per case (zkir-assembler/src/
    error.rs:8-62): each classmethod below is one enum variant and
    renders its exact ``#[error(...)]`` format string.  ``kind`` holds
    the variant name for structured matching."""

    def __init__(self, line: int, message: str, kind: str = "SyntaxError"):
        # SyntaxError variant: "Syntax error at line {line}: {message}"
        # (error.rs:10-11); other variants pre-render via the
        # classmethods and pass kind explicitly.
        if kind == "SyntaxError":
            text = f"Syntax error at line {line}: {message}"
        else:
            text = message
        super().__init__(text)
        self.line = line
        self.message = message
        self.kind = kind

    @classmethod
    def invalid_instruction(cls, line: int, instruction: str):
        return cls(line, f"Invalid instruction at line {line}: "
                   f"{instruction}", kind="InvalidInstruction")

    @classmethod
    def invalid_register(cls, line: int, register: str):
        return cls(line, f"Invalid register at line {line}: {register}",
                   kind="InvalidRegister")

    @classmethod
    def invalid_immediate(cls, line: int, value: str):
        return cls(line, f"Invalid immediate value at line {line}: "
                   f"{value}", kind="InvalidImmediate")

    @classmethod
    def undefined_label(cls, line: int, label: str):
        return cls(line, f"Undefined label at line {line}: {label}",
                   kind="UndefinedLabel")

    @classmethod
    def invalid_directive(cls, line: int, directive: str):
        return cls(line, f"Invalid directive at line {line}: {directive}",
                   kind="InvalidDirective")

    @classmethod
    def config_error(cls, line: int, source: str):
        return cls(line, f"Configuration error at line {line}: {source}",
                   kind="ConfigError")

    @classmethod
    def invalid_config_value(cls, line: int, key: str, value: str):
        return cls(line, f"Invalid config value at line {line}: "
                   f"{key}={value}", kind="InvalidConfigValue")


@dataclass
class _PendingInstr:
    """A parsed instruction, possibly with an unresolved label operand."""

    inst: Instruction
    pc: int
    label: Optional[str] = None  # to resolve into inst.imm (relative offset)
    line: int = 0


_R_TYPE = {
    "add": Op.ADD, "sub": Op.SUB, "mul": Op.MUL, "mulh": Op.MULH,
    "div": Op.DIV, "divu": Op.DIVU, "rem": Op.REM, "remu": Op.REMU,
    "and": Op.AND, "or": Op.OR, "xor": Op.XOR,
    "sll": Op.SLL, "srl": Op.SRL, "sra": Op.SRA,
    "slt": Op.SLT, "sltu": Op.SLTU, "sge": Op.SGE, "sgeu": Op.SGEU,
    "seq": Op.SEQ, "sne": Op.SNE,
    "cmov": Op.CMOV, "cmovz": Op.CMOVZ, "cmovnz": Op.CMOVNZ,
}
_I_TYPE = {"addi": Op.ADDI, "xori": Op.XORI, "ori": Op.ORI, "andi": Op.ANDI}
_SHIFT_IMM = {"slli": Op.SLLI, "srli": Op.SRLI, "srai": Op.SRAI}
_LOAD = {"lw": Op.LW, "lh": Op.LH, "lhu": Op.LHU, "lb": Op.LB,
         "lbu": Op.LBU, "ld": Op.LD}
_STORE = {"sw": Op.SW, "sh": Op.SH, "sb": Op.SB, "sd": Op.SD}
_BRANCH = {"beq": Op.BEQ, "bne": Op.BNE, "blt": Op.BLT, "bge": Op.BGE,
           "bltu": Op.BLTU, "bgeu": Op.BGEU}


def assemble(source: str) -> Program:
    """Assemble source text into a Program (reference assembler.rs:43-57)."""
    pending, labels, config = _first_pass(source)
    code = []
    for item in pending:
        inst = item.inst
        if item.label is not None:
            if item.label not in labels:
                raise AssemblerError.undefined_label(item.line, item.label)
            offset = labels[item.label] - item.pc
            inst = Instruction(inst.op, rd=inst.rd, rs1=inst.rs1,
                               rs2=inst.rs2, imm=offset)
        code.append(inst.encode())

    program = Program.with_config(config)
    program.code = code
    program.header.code_size = len(code) * 4
    return program


def _first_pass(source: str) -> Tuple[List[_PendingInstr], Dict[str, int], Config]:
    pending: List[_PendingInstr] = []
    labels: Dict[str, int] = {}
    limb_bits, data_limbs, addr_limbs = 20, 2, 2
    pc = CODE_BASE

    for line_idx, raw_line in enumerate(source.splitlines()):
        line_num = line_idx + 1
        text = raw_line.strip()
        if not text or text.startswith("#"):
            continue
        hash_pos = text.find("#")
        if hash_pos >= 0:
            text = text[:hash_pos].strip()
        if not text:
            continue

        try:
            tokens = tokenize(text)
        except LexError as e:
            raise AssemblerError(line_num, str(e)) from e
        if not tokens:
            continue

        # Label: identifier followed by colon (assembler.rs:94-124)
        if len(tokens) >= 2 and tokens[0].kind == "ident" and tokens[1].kind == "colon":
            name = tokens[0].text
            if not _is_valid_label(name):
                raise AssemblerError(line_num, f"Invalid label name: {name}")
            if name in labels:
                # The reference reports duplicates as a SyntaxError, not its
                # DuplicateLabel variant (assembler.rs:106-111).
                raise AssemblerError(line_num, f"Duplicate label: {name}")
            labels[name] = pc
            if len(tokens) > 2:
                pending.append(_parse_instruction(tokens[2:], line_num, pc))
                pc += 4
            continue

        # Directive (assembler.rs:127-186)
        if tokens[0].kind == "directive":
            if tokens[0].text == "config":
                if len(tokens) != 3:
                    raise AssemblerError(
                        line_num, ".config requires 2 arguments: key value"
                    )
                if tokens[1].kind != "ident":
                    raise AssemblerError(line_num,
                                         "Config key must be an identifier")
                key = tokens[1].text
                value = _extract_number(tokens[2], line_num)
                if key == "limb_bits":
                    limb_bits = value
                elif key == "data_limbs":
                    data_limbs = value
                elif key == "addr_limbs":
                    addr_limbs = value
                else:
                    raise AssemblerError.invalid_config_value(
                        line_num, key, str(value))
                try:
                    # Incremental validation after each mutation, matching
                    # the reference (assembler.rs:149-170).
                    Config(limb_bits, data_limbs, addr_limbs)
                except ConfigError as e:
                    raise AssemblerError.config_error(line_num, str(e)) from e
            # Other directives (.text, .data, ...) are ignored.
            continue

        pending.append(_parse_instruction(tokens, line_num, pc))
        pc += 4

    return pending, labels, Config(limb_bits, data_limbs, addr_limbs)


def _parse_instruction(tokens: List[Token], line: int, pc: int) -> _PendingInstr:
    if not tokens:
        raise AssemblerError(line, "Empty instruction")
    head = tokens[0]
    if head.kind != "ident":
        raise AssemblerError(
            line, f"Expected instruction mnemonic, got {head.rust_debug()}")
    mnemonic = head.text.lower()
    operands = tokens[1:]

    if mnemonic == "ecall":
        _expect_no_operands(operands, line)
        return _PendingInstr(Instruction(Op.ECALL), pc, line=line)
    if mnemonic == "ebreak":
        _expect_no_operands(operands, line)
        return _PendingInstr(Instruction(Op.EBREAK), pc, line=line)

    if mnemonic in _R_TYPE:
        rd, rs1, rs2 = _parse_three_regs(operands, line, "R-type")
        return _PendingInstr(
            Instruction(_R_TYPE[mnemonic], rd=rd, rs1=rs1, rs2=rs2), pc, line=line
        )

    if mnemonic in _I_TYPE:
        rd, rs1, imm = _parse_reg_reg_imm(operands, line, "I-type")
        return _PendingInstr(
            Instruction(_I_TYPE[mnemonic], rd=rd, rs1=rs1, imm=imm), pc, line=line
        )

    if mnemonic in _SHIFT_IMM:
        rd, rs1, shamt = _parse_reg_reg_imm(operands, line, "Shift",
                                            last="shamt")
        return _PendingInstr(
            Instruction(_SHIFT_IMM[mnemonic], rd=rd, rs1=rs1, imm=shamt & 0xFF),
            pc, line=line,
        )

    if mnemonic in _LOAD:
        rd, rs1, offset = _parse_mem_operands(operands, line, "Load")
        return _PendingInstr(
            Instruction(_LOAD[mnemonic], rd=rd, rs1=rs1, imm=offset), pc, line=line
        )

    if mnemonic in _STORE:
        rs2, rs1, offset = _parse_mem_operands(operands, line, "Store",
                                               reg_name="rs2")
        return _PendingInstr(
            Instruction(_STORE[mnemonic], rs1=rs1, rs2=rs2, imm=offset), pc, line=line
        )

    if mnemonic in _BRANCH:
        if len(operands) != 5:
            raise AssemblerError(line, "Branch requires 3 operands: rs1, rs2, offset")
        rs1 = _extract_register(operands[0], line)
        _expect(operands[1], "comma", line)
        rs2 = _extract_register(operands[2], line)
        _expect(operands[3], "comma", line)
        label = None
        imm = 0
        if operands[4].kind == "ident":
            label = operands[4].text  # label-resolution extension
        else:
            imm = _extract_number(operands[4], line)
        return _PendingInstr(
            Instruction(_BRANCH[mnemonic], rs1=rs1, rs2=rs2, imm=imm),
            pc, label=label, line=line,
        )

    if mnemonic == "jal":
        if len(operands) != 3:
            raise AssemblerError(line, "JAL requires 2 operands: rd, offset")
        rd = _extract_register(operands[0], line)
        _expect(operands[1], "comma", line)
        label = None
        imm = 0
        if operands[2].kind == "ident":
            label = operands[2].text
        else:
            imm = _extract_number(operands[2], line)
        return _PendingInstr(
            Instruction(Op.JAL, rd=rd, imm=imm), pc, label=label, line=line
        )

    if mnemonic == "jalr":
        rd, rs1, imm = _parse_reg_reg_imm(operands, line, "JALR",
                                          last="offset")
        return _PendingInstr(
            Instruction(Op.JALR, rd=rd, rs1=rs1, imm=imm), pc, line=line
        )

    raise AssemblerError.invalid_instruction(line, mnemonic)


# ---- operand shape helpers (assembler.rs:338-497) ----


def _expect_no_operands(operands: List[Token], line: int) -> None:
    if operands:
        raise AssemblerError(line, "Instruction takes no operands")


def _parse_three_regs(operands: List[Token], line: int, what: str):
    if len(operands) != 5:
        raise AssemblerError(line, f"{what} requires 3 operands: rd, rs1, rs2")
    rd = _extract_register(operands[0], line)
    _expect(operands[1], "comma", line)
    rs1 = _extract_register(operands[2], line)
    _expect(operands[3], "comma", line)
    rs2 = _extract_register(operands[4], line)
    return rd, rs1, rs2


def _parse_reg_reg_imm(operands: List[Token], line: int, what: str,
                       last: str = "imm"):
    if len(operands) != 5:
        raise AssemblerError(line, f"{what} requires 3 operands: rd, rs1, {last}")
    rd = _extract_register(operands[0], line)
    _expect(operands[1], "comma", line)
    rs1 = _extract_register(operands[2], line)
    _expect(operands[3], "comma", line)
    imm = _extract_number(operands[4], line)
    return rd, rs1, imm


def _parse_mem_operands(operands: List[Token], line: int, what: str,
                        reg_name: str = "rd"):
    """Parse ``reg, offset(base)`` shape; returns (reg, base, offset)."""
    if len(operands) != 6:
        raise AssemblerError(
            line, f"{what} requires format: {reg_name}, offset(rs1)")
    reg = _extract_register(operands[0], line)
    _expect(operands[1], "comma", line)
    offset = _extract_number(operands[2], line)
    _expect(operands[3], "lparen", line)
    base = _extract_register(operands[4], line)
    _expect(operands[5], "rparen", line)
    return reg, base, offset


def _extract_register(token: Token, line: int) -> int:
    if token.kind != "reg":
        raise AssemblerError(
            line, f"Expected register, got {token.rust_debug()}")
    try:
        return reg_from_name(token.text)
    except KeyError as e:
        raise AssemblerError.invalid_register(line, token.text) from e


def _extract_number(token: Token, line: int) -> int:
    if token.kind != "num":
        raise AssemblerError(
            line, f"Expected number, got {token.rust_debug()}")
    return token.value


def _expect(token: Token, kind: str, line: int) -> None:
    if token.kind != kind:
        want = {"comma": "comma", "lparen": "'('",
                "rparen": "')'"}.get(kind, kind)
        raise AssemblerError(
            line, f"Expected {want}, got {token.rust_debug()}")


def _is_valid_label(label: str) -> bool:
    if not label:
        return False
    first = label[0]
    if not (first.isalpha() or first == "_"):
        return False
    return all(c.isalnum() or c == "_" for c in label)
