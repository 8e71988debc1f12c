"""Host-side data model (copies of the ``zkir_tpu.spec`` modules the
toolchain, the oracle VM, the interpreter and the prover need)."""

from .config import Config
from .registers import (
    NUM_REGISTERS,
    REG_ALIASES,
    REG_NAMES,
    reg_from_name,
    reg_name,
)
from .opcodes import Op, OPCODE_NAMES, VALID_OPCODES
from .isa import DecodeError, Instruction
from .memlayout import CODE_BASE, STACK_TOP
from .program import Program, ProgramHeader
from .bounds import BoundSource, CryptoType, ValueBound
from .validation import validate_program, validate_instruction, ValidationError
