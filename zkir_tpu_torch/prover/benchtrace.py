"""Exact-length benchmark traces for the prover.

Counterpart of ``zkir_tpu/prover/benchtrace.py``.  A proved trace must END
AT ITS HALT ROW: truncating a longer execution mid-loop glues a fabricated
next-row transition onto the final row and the AIR (correctly) rejects it.
The program below executes a counted ALU/branch loop plus straight-line
filler so the committed trace is EXACTLY 2^log_rows rows with the EBREAK
last.
"""

from __future__ import annotations

import numpy as np

from ..interp import InterpConfig, TpuInterpreter
from ..spec import Instruction, Op, Program
from .trace import trace_to_matrix


def exact_trace_program(log_rows: int) -> Program:
    n = 1 << log_rows
    # Loop counter r6 = iters, built with SLLI so counts beyond the
    # 17-bit immediate range (log_rows >= 19) still express: r6 =
    # (hi << 10) + lo.  Pre-loop = 3 rows, loop = 4 rows/iter, filler +
    # EBREAK close the count exactly.
    iters = (n - 4) // 4
    extra = n - (4 * iters + 4)            # 0..3 (0 for powers of two)
    hi, lo = iters >> 10, iters & 1023
    ins = [
        Instruction(Op.ADDI, rd=6, rs1=0, imm=hi),
        Instruction(Op.SLLI, rd=6, rs1=6, imm=10),
        Instruction(Op.ADDI, rd=6, rs1=6, imm=lo),
        Instruction(Op.ADD, rd=3, rs1=3, rs2=2),
        Instruction(Op.XOR, rd=4, rs1=3, rs2=1),
        Instruction(Op.ADDI, rd=1, rs1=1, imm=1),
        Instruction(Op.BNE, rs1=1, rs2=6, imm=-12),
    ]
    ins += [Instruction(Op.ADDI, rd=7, rs1=0, imm=0)] * extra
    ins.append(Instruction(Op.EBREAK))
    return Program.from_instructions(ins)


def exact_trace_matrix(log_rows: int, chunk: int = 1024, *,
                       device) -> np.ndarray:
    """The trace matrix of ``exact_trace_program(log_rows)``, interpreted
    on ``device``."""
    n = 1 << log_rows
    program = exact_trace_program(log_rows)
    interp = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=chunk, collect_trace=True), device=device)
    result = interp.run([[]], max_cycles=2 * n)
    matrix = trace_to_matrix(result["trace"])
    if matrix.shape[0] != n:
        raise RuntimeError(f"trace has {matrix.shape[0]} rows, not {n}")
    return matrix
