"""Scalar instruction execution — the 50-way dispatch.

Parity target: reference ``zkir-runtime/src/execute.rs`` with *exactly* its
semantics, including the subtleties:

- arithmetic wraps at 40 bits on Value40-masked operands, while MULH /
  DIV / REM / SEQ / SNE / CMOV operate on *raw* u64 register contents
  (execute.rs:101-183, 409-474);
- LB/LH sign-extend through the full 64-bit register, LW zero-extends
  (execute.rs:477-546);
- branches BLT/BGE/BLTU/BGEU compare 40-bit-masked values (signed via the
  sign-bit XOR trick), but BEQ/BNE compare raw u64 (execute.rs:577-636);
- ADDI's immediate bound is computed from the *unsigned reinterpretation*
  of the sign-extended immediate (execute.rs:192).

``execute_with_deferred`` adds the deferred-carry model: pre-normalization
of observation-point sources (rs1 with witness, rs2 without — the one-
normalization-per-row prover limit, execute.rs:930-982) and deferred
ADD/SUB/ADDI (execute.rs:986-1000).
"""

from __future__ import annotations

from typing import List, Optional

from ..spec.bounds import ValueBound
from ..spec.isa import Instruction
from ..spec.opcodes import Op
from .deferred import (
    DeferredConfig,
    execute_add_deferred,
    execute_addi_deferred,
    execute_sub_deferred,
)
from .errors import DivisionByZero
from .memory import Memory
from .normalize import normalize_register, normalize_register_for_observation
from .range_check import RangeCheckTracker
from .state import HaltReason, VMState
from .witness import NormalizationEvent

_U64 = (1 << 64) - 1
_M40 = (1 << 40) - 1
DATA_BITS = 40


def _v40(x: int) -> int:
    return x & _M40


def _signed_lt_40(a: int, b: int) -> bool:
    sign = 1 << (DATA_BITS - 1)
    return (a ^ sign) < (b ^ sign)


def _sra_40(val: int, shift: int) -> int:
    """Arithmetic right shift at 40 bits (reference value.rs:676-697)."""
    sign_bit = 1 << (DATA_BITS - 1)
    negative = (val & sign_bit) != 0
    if shift >= DATA_BITS:
        return _M40 if negative else 0
    shifted = val >> shift
    if negative:
        mask = ((1 << shift) - 1) << (DATA_BITS - shift)
        return (shifted | mask) & _M40
    return shifted


def _as_i64(x: int) -> int:
    x &= _U64
    return x - (1 << 64) if x >= (1 << 63) else x


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _trunc_rem(a: int, b: int) -> int:
    return a - _trunc_div(a, b) * b


def execute(inst: Instruction, state: VMState, memory: Memory,
            range_checker: Optional[RangeCheckTracker] = None) -> None:
    """Execute one instruction (plain model)."""
    op = inst.op
    rd, rs1, rs2, imm = inst.rd, inst.rs1, inst.rs2, inst.imm

    # ===== Arithmetic =====
    if op == Op.ADD:
        a, b = _v40(state.read_reg(rs1)), _v40(state.read_reg(rs2))
        result = _v40(a + b)
        bound = ValueBound.after_add(state.read_bound(rs1), state.read_bound(rs2))
        state.write_reg_with_bound(rd, result, bound)
        if range_checker is not None and range_checker.needs_check(bound):
            range_checker.defer(result, bound, state.pc)
        state.advance_pc(4)
    elif op == Op.SUB:
        a, b = _v40(state.read_reg(rs1)), _v40(state.read_reg(rs2))
        result = _v40(a - b)
        bound = ValueBound.after_sub(state.read_bound(rs1), state.read_bound(rs2))
        state.write_reg_with_bound(rd, result, bound)
        state.advance_pc(4)
    elif op == Op.MUL:
        a, b = _v40(state.read_reg(rs1)), _v40(state.read_reg(rs2))
        result = _v40(a * b)
        bound = ValueBound.after_mul(state.read_bound(rs1), state.read_bound(rs2))
        state.write_reg_with_bound(rd, result, bound)
        if range_checker is not None and range_checker.needs_check(bound):
            range_checker.defer(result, bound, state.pc)
        state.advance_pc(4)
    elif op == Op.MULH:
        # Raw u64 operands; bits [40, 80) of the product (execute.rs:101-115).
        a, b = state.read_reg(rs1), state.read_reg(rs2)
        high = ((a * b) >> 40) & _M40
        bound = ValueBound.after_mul(state.read_bound(rs1), state.read_bound(rs2))
        state.write_reg_with_bound(rd, high, bound)
        state.advance_pc(4)
    elif op in (Op.DIV, Op.REM):
        dividend = _as_i64(state.read_reg(rs1))
        divisor = _as_i64(state.read_reg(rs2))
        if divisor == 0:
            raise DivisionByZero(state.pc)
        result = (_trunc_div if op == Op.DIV else _trunc_rem)(dividend, divisor)
        bound = ValueBound.after_div(state.read_bound(rs1), state.read_bound(rs2))
        state.write_reg_with_bound(rd, result & _U64, bound)
        state.advance_pc(4)
    elif op in (Op.DIVU, Op.REMU):
        dividend = state.read_reg(rs1)
        divisor = state.read_reg(rs2)
        if divisor == 0:
            raise DivisionByZero(state.pc)
        result = dividend // divisor if op == Op.DIVU else dividend % divisor
        bound = ValueBound.after_div(state.read_bound(rs1), state.read_bound(rs2))
        state.write_reg_with_bound(rd, result, bound)
        state.advance_pc(4)
    elif op == Op.ADDI:
        a = _v40(state.read_reg(rs1))
        b = _v40(imm & _U64)
        result = _v40(a + b)
        bound = ValueBound.after_add(
            state.read_bound(rs1), ValueBound.from_constant(imm & _U64)
        )
        state.write_reg_with_bound(rd, result, bound)
        state.advance_pc(4)

    # ===== Logical =====
    elif op in (Op.AND, Op.OR, Op.XOR):
        a, b = _v40(state.read_reg(rs1)), _v40(state.read_reg(rs2))
        result = {Op.AND: a & b, Op.OR: a | b, Op.XOR: a ^ b}[op]
        rule = {Op.AND: ValueBound.after_and, Op.OR: ValueBound.after_or,
                Op.XOR: ValueBound.after_xor}[op]
        bound = rule(state.read_bound(rs1), state.read_bound(rs2))
        state.write_reg_with_bound(rd, result, bound)
        state.advance_pc(4)
    elif op in (Op.ANDI, Op.ORI, Op.XORI):
        a = _v40(state.read_reg(rs1))
        b = _v40(imm & _U64)
        result = {Op.ANDI: a & b, Op.ORI: a | b, Op.XORI: a ^ b}[op]
        rule = {Op.ANDI: ValueBound.after_and, Op.ORI: ValueBound.after_or,
                Op.XORI: ValueBound.after_xor}[op]
        bound = rule(state.read_bound(rs1), ValueBound.from_constant(imm & _U64))
        state.write_reg_with_bound(rd, result, bound)
        state.advance_pc(4)

    # ===== Shifts =====
    elif op in (Op.SLL, Op.SRL, Op.SRA):
        a = _v40(state.read_reg(rs1))
        shift = state.read_reg(rs2) & 0x3F
        if op == Op.SLL:
            result = 0 if shift >= DATA_BITS else _v40(a << shift)
            bound = ValueBound.after_shl(state.read_bound(rs1), shift, DATA_BITS)
        elif op == Op.SRL:
            result = 0 if shift >= DATA_BITS else a >> shift
            bound = ValueBound.after_srl(state.read_bound(rs1), shift)
        else:
            result = _sra_40(a, shift)
            bound = ValueBound.after_sra(state.read_bound(rs1), shift, DATA_BITS)
        state.write_reg_with_bound(rd, result, bound)
        state.advance_pc(4)
    elif op in (Op.SLLI, Op.SRLI, Op.SRAI):
        a = _v40(state.read_reg(rs1))
        shift = imm
        if op == Op.SLLI:
            result = 0 if shift >= DATA_BITS else _v40(a << shift)
            bound = ValueBound.after_shl(state.read_bound(rs1), shift, DATA_BITS)
        elif op == Op.SRLI:
            result = 0 if shift >= DATA_BITS else a >> shift
            bound = ValueBound.after_srl(state.read_bound(rs1), shift)
        else:
            result = _sra_40(a, shift)
            bound = ValueBound.after_sra(state.read_bound(rs1), shift, DATA_BITS)
        state.write_reg_with_bound(rd, result, bound)
        state.advance_pc(4)

    # ===== Comparisons =====
    elif op in (Op.SLT, Op.SGE):
        a, b = _v40(state.read_reg(rs1)), _v40(state.read_reg(rs2))
        lt = _signed_lt_40(a, b)
        result = int(lt) if op == Op.SLT else int(not lt)
        state.write_reg_with_bound(rd, result, ValueBound.after_cmp())
        state.advance_pc(4)
    elif op in (Op.SLTU, Op.SGEU):
        a, b = _v40(state.read_reg(rs1)), _v40(state.read_reg(rs2))
        lt = a < b
        result = int(lt) if op == Op.SLTU else int(not lt)
        state.write_reg_with_bound(rd, result, ValueBound.after_cmp())
        state.advance_pc(4)
    elif op in (Op.SEQ, Op.SNE):
        # Raw u64 comparison (execute.rs:409-431).
        a, b = state.read_reg(rs1), state.read_reg(rs2)
        eq = a == b
        result = int(eq) if op == Op.SEQ else int(not eq)
        state.write_reg_with_bound(rd, result, ValueBound.after_cmp())
        state.advance_pc(4)

    # ===== Conditional moves =====
    elif op in (Op.CMOV, Op.CMOVZ, Op.CMOVNZ):
        cond_val = state.read_reg(rs2)
        cond = cond_val == 0 if op == Op.CMOVZ else cond_val != 0
        if cond:
            bound = ValueBound.computed(
                max(state.read_bound(rs1).max_bits, state.read_bound(rd).max_bits)
            )
            state.write_reg_with_bound(rd, state.read_reg(rs1), bound)
        state.advance_pc(4)

    # ===== Loads =====
    elif op in (Op.LB, Op.LBU, Op.LH, Op.LHU, Op.LW, Op.LD):
        addr = (state.read_reg(rs1) + (imm & _U64)) & _U64
        if op == Op.LB:
            byte = memory.read_u8(addr)
            value = (byte - 256 if byte >= 128 else byte) & _U64
            bound = ValueBound.from_type_width(8)
        elif op == Op.LBU:
            value = memory.read_u8(addr)
            bound = ValueBound.from_type_width(8)
        elif op == Op.LH:
            half = memory.read_u16(addr)
            value = (half - 65536 if half >= 32768 else half) & _U64
            bound = ValueBound.from_type_width(16)
        elif op == Op.LHU:
            value = memory.read_u16(addr)
            bound = ValueBound.from_type_width(16)
        elif op == Op.LW:
            value = memory.read_u32(addr)  # zero-extended (execute.rs:525-535)
            bound = ValueBound.from_type_width(32)
        else:  # LD
            value = memory.read_u64(addr)
            bound = ValueBound.from_type_width(40)
        state.write_reg_with_bound(rd, value, bound)
        state.advance_pc(4)

    # ===== Stores =====
    elif op in (Op.SB, Op.SH, Op.SW, Op.SD):
        addr = (state.read_reg(rs1) + (imm & _U64)) & _U64
        value = state.read_reg(rs2)
        if op == Op.SB:
            memory.write_u8(addr, value & 0xFF)
        elif op == Op.SH:
            memory.write_u16(addr, value & 0xFFFF)
        elif op == Op.SW:
            memory.write_u32(addr, value & 0xFFFFFFFF)
        else:
            memory.write_u64(addr, value)
        state.advance_pc(4)

    # ===== Branches =====
    elif op in (Op.BEQ, Op.BNE):
        # Raw u64 equality (execute.rs:578-596).
        a, b = state.read_reg(rs1), state.read_reg(rs2)
        taken = (a == b) if op == Op.BEQ else (a != b)
        state.advance_pc(imm if taken else 4)
    elif op in (Op.BLT, Op.BGE):
        a, b = _v40(state.read_reg(rs1)), _v40(state.read_reg(rs2))
        lt = _signed_lt_40(a, b)
        taken = lt if op == Op.BLT else not lt
        state.advance_pc(imm if taken else 4)
    elif op in (Op.BLTU, Op.BGEU):
        a, b = _v40(state.read_reg(rs1)), _v40(state.read_reg(rs2))
        lt = a < b
        taken = lt if op == Op.BLTU else not lt
        state.advance_pc(imm if taken else 4)

    # ===== Jumps =====
    elif op == Op.JAL:
        return_addr = state.pc + 4
        state.write_reg_with_bound(
            rd, return_addr, ValueBound.from_constant(return_addr)
        )
        state.advance_pc(imm)
    elif op == Op.JALR:
        return_addr = state.pc + 4
        target = (state.read_reg(rs1) + (imm & _U64)) & _U64
        state.write_reg_with_bound(
            rd, return_addr, ValueBound.from_constant(return_addr)
        )
        state.pc = target & ~1

    # ===== System =====
    elif op == Op.ECALL:
        state.advance_pc(4)  # syscall body dispatched by the VM loop
    elif op == Op.EBREAK:
        state.halt(HaltReason.EBREAK)
    else:  # pragma: no cover
        raise AssertionError(f"unhandled opcode {op}")


# Observation-point pre-normalization classes (execute.rs:934-982):
# "norm_two" ops normalize rs1 (with witness) and rs2 (without);
# "norm_one" ops normalize rs1 only.  Derived from the shared observation
# tables (runtime/observation.py) so there is one source of truth.
from .observation import OBSERVATION_POINTS as _OBS

_NORM_ONE = {Op.ANDI, Op.ORI, Op.XORI, Op.SLLI, Op.SRLI, Op.SRAI}
_NORM_TWO = _OBS - _NORM_ONE


def execute_with_deferred(
    inst: Instruction,
    state: VMState,
    memory: Memory,
    range_checker: Optional[RangeCheckTracker],
    config: Optional[DeferredConfig],
    cycle: int,
    pc: int,
) -> List[NormalizationEvent]:
    """Execute with the deferred-carry model (execute.rs:888-1003)."""
    events: List[NormalizationEvent] = []
    cfg = config if config is not None else DeferredConfig()
    nb, lb = cfg.normalized_bits, cfg.limb_bits
    op = inst.op

    def norm_witnessed(reg: int) -> None:
        if reg != 0:
            result = normalize_register_for_observation(state, reg, nb, lb)
            if result is not None:
                events.append(NormalizationEvent.observation_point(
                    cycle, pc, reg, result, nb, lb, int(op)
                ))

    def norm_silent(reg: int) -> None:
        if reg != 0:
            normalize_register(state, reg, nb, lb)

    if op in _NORM_TWO:
        norm_witnessed(inst.rs1)
        norm_silent(inst.rs2)
    elif op in _NORM_ONE:
        norm_witnessed(inst.rs1)

    if op == Op.ADD:
        execute_add_deferred(state, inst.rd, inst.rs1, inst.rs2, cfg, range_checker)
    elif op == Op.SUB:
        execute_sub_deferred(state, inst.rd, inst.rs1, inst.rs2, cfg, range_checker)
    elif op == Op.ADDI:
        execute_addi_deferred(state, inst.rd, inst.rs1, inst.imm & _U64, cfg,
                              range_checker)
    else:
        execute(inst, state, memory, range_checker)

    return events
