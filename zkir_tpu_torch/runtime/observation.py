"""Observation-point classification for the deferred-carry model.

Parity target: reference ``zkir-runtime/src/observation.rs`` — the same
opcode classes (is_observation_point :24-50, get_normalize_sources :64-101,
can_defer_output :107-113, categorize_instruction :127-135), plus dense
numpy masks used by the batched interpreter.
"""

from __future__ import annotations

import enum
from typing import List

import numpy as np

from ..spec.opcodes import Op

_BRANCHES = {Op.BEQ, Op.BNE, Op.BLT, Op.BGE, Op.BLTU, Op.BGEU}
_COMPARES = {Op.SEQ, Op.SNE, Op.SLT, Op.SLTU, Op.SGE, Op.SGEU}
_STORES_OBS = {Op.SW, Op.SH, Op.SB}  # note: SD is NOT an observation point
_BITWISE_R = {Op.AND, Op.OR, Op.XOR}
_BITWISE_I = {Op.ANDI, Op.ORI, Op.XORI}
_SHIFTS_R = {Op.SLL, Op.SRL, Op.SRA}
_SHIFTS_I = {Op.SLLI, Op.SRLI, Op.SRAI}
_MULDIV = {Op.MUL, Op.MULH, Op.DIV, Op.DIVU, Op.REM, Op.REMU}
_LOADS_OBS = {Op.LW, Op.LH, Op.LB, Op.LHU, Op.LBU}  # LD excluded (obs.rs:89)

OBSERVATION_POINTS = frozenset(
    _BRANCHES | _COMPARES | _STORES_OBS | _BITWISE_R | _BITWISE_I
    | _SHIFTS_R | _SHIFTS_I | _MULDIV
)

DEFERRABLE_OUTPUT = frozenset({Op.ADD, Op.SUB, Op.ADDI, Op.MUL})


def is_observation_point(op: int) -> bool:
    return op in OBSERVATION_POINTS


def get_normalize_sources(op: int, rs1: int, rs2: int) -> List[int]:
    """Source registers needing normalization (observation.rs:64-101)."""
    if op in (_BRANCHES | _COMPARES | _BITWISE_R | _SHIFTS_R | _MULDIV
              | _STORES_OBS):
        return [rs1, rs2]
    if op in (_BITWISE_I | _SHIFTS_I) or op in _LOADS_OBS:
        return [rs1]
    return []


def can_defer_output(op: int) -> bool:
    return op in DEFERRABLE_OUTPUT


class InstructionCategory(enum.Enum):
    DEFERRED_ARITHMETIC = "deferred_arithmetic"
    OBSERVATION_POINT = "observation_point"
    OTHER = "other"


def categorize_instruction(op: int) -> InstructionCategory:
    if op in (Op.ADD, Op.SUB, Op.ADDI):
        return InstructionCategory.DEFERRED_ARITHMETIC
    if is_observation_point(op):
        return InstructionCategory.OBSERVATION_POINT
    return InstructionCategory.OTHER


def _build_masks():
    obs = np.zeros(128, dtype=bool)
    defer = np.zeros(128, dtype=bool)
    for op in OBSERVATION_POINTS:
        obs[int(op)] = True
    for op in DEFERRABLE_OUTPUT:
        defer[int(op)] = True
    return obs, defer


OBS_POINT_MASK, DEFERRABLE_MASK = _build_masks()
