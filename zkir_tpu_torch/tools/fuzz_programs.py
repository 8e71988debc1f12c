"""Seeded random ZK-IR programs for differential tests of the interpreter.

``generate_program(seed)`` is the generator of the reference's
``tests/test_fuzz_differential.py``, copied so that the port's tests and
its GPU smoke test can draw the same programs without the JAX package:
structured control flow (forward branches, forward JALs, bounded counted
loops), guarded DIV/REM, all memory widths and READ/WRITE syscalls, a pure
function of the seed.  ``result_digest`` hashes one lane of an interpreter
result the way the reference pins its oracle in ``tests/fuzz_corpus.json``.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..spec import Instruction, Op, Program

ALU_OPS = [
    Op.ADD, Op.SUB, Op.MUL, Op.MULH, Op.AND, Op.OR, Op.XOR,
    Op.SLL, Op.SRL, Op.SRA, Op.SLT, Op.SLTU, Op.SGE, Op.SGEU,
    Op.SEQ, Op.SNE, Op.CMOV, Op.CMOVZ, Op.CMOVNZ,
]
IMM_OPS = [Op.ADDI, Op.ANDI, Op.ORI, Op.XORI]
SHIFT_I_OPS = [Op.SLLI, Op.SRLI, Op.SRAI]
DIV_OPS = [Op.DIV, Op.DIVU, Op.REM, Op.REMU]
STORE_OPS = [Op.SB, Op.SH, Op.SW, Op.SD]
LOAD_OPS = [Op.LB, Op.LBU, Op.LH, Op.LHU, Op.LW, Op.LD]
BRANCH_OPS = [Op.BEQ, Op.BNE, Op.BLT, Op.BGE, Op.BLTU, Op.BGEU]

I = Instruction  # noqa: E741


def _alu(rng, n):
    """n random computation instructions over r1..r9 (r9 = guarded
    divisor scratch)."""
    out = []
    for _ in range(n):
        pick = rng.random()
        rd = int(rng.integers(1, 9))
        rs1 = int(rng.integers(0, 10))
        rs2 = int(rng.integers(0, 10))
        if pick < 0.55:
            out.append(I(ALU_OPS[int(rng.integers(len(ALU_OPS)))],
                         rd=rd, rs1=rs1, rs2=rs2))
        elif pick < 0.75:
            out.append(I(IMM_OPS[int(rng.integers(len(IMM_OPS)))], rd=rd,
                         rs1=rs1, imm=int(rng.integers(-(1 << 16), 1 << 16))))
        elif pick < 0.85:
            out.append(I(SHIFT_I_OPS[int(rng.integers(3))], rd=rd,
                         rs1=rs1, imm=int(rng.integers(0, 64))))
        else:
            # guarded division: divisor forced nonzero via ORI ..., 1
            out.append(I(Op.ORI, rd=9, rs1=rs2, imm=1))
            out.append(I(DIV_OPS[int(rng.integers(4))],
                         rd=rd, rs1=rs1, rs2=9))
    return out


def generate_program(seed: int):
    """Deterministic structured random program; always terminates."""
    rng = np.random.default_rng(seed)
    instrs = []
    for r in range(1, 10):
        instrs.append(I(Op.ADDI, rd=r, rs1=0,
                        imm=int(rng.integers(-(1 << 16), 1 << 16))))
    n_inputs = int(rng.integers(0, 6))
    for _ in range(int(rng.integers(8, 16))):
        kind = int(rng.integers(6))
        if kind == 0:
            instrs += _alu(rng, int(rng.integers(3, 9)))
        elif kind == 1:
            # forward conditional branch over a random body
            body = _alu(rng, int(rng.integers(1, 5)))
            op = BRANCH_OPS[int(rng.integers(len(BRANCH_OPS)))]
            instrs.append(I(op, rs1=int(rng.integers(0, 10)),
                            rs2=int(rng.integers(0, 10)),
                            imm=4 * (len(body) + 1)))
            instrs += body
        elif kind == 2:
            # forward JAL over a body; link register exercises rd=pc+4
            body = _alu(rng, int(rng.integers(1, 4)))
            instrs.append(I(Op.JAL, rd=int(rng.integers(0, 9)),
                            imm=4 * (len(body) + 1)))
            instrs += body
        elif kind == 3:
            # bounded counted loop (r14 = counter)
            iters = int(rng.integers(1, 9))
            body = _alu(rng, int(rng.integers(1, 4)))
            instrs.append(I(Op.ADDI, rd=14, rs1=0, imm=iters))
            instrs += body
            instrs.append(I(Op.ADDI, rd=14, rs1=14, imm=-1))
            instrs.append(I(Op.BNE, rs1=14, rs2=0,
                            imm=-4 * (len(body) + 1)))
        elif kind == 4:
            # memory: store then load at a scratch slot, random widths
            instrs.append(I(Op.ADDI, rd=15, rs1=0, imm=0x6000))
            offset = int(rng.integers(0, 32)) * 8
            instrs.append(I(STORE_OPS[int(rng.integers(4))], rs1=15,
                            rs2=int(rng.integers(0, 10)), imm=offset))
            instrs.append(I(LOAD_OPS[int(rng.integers(6))],
                            rd=int(rng.integers(1, 9)), rs1=15, imm=offset))
        else:
            # I/O: READ into r10, write r11 back out
            instrs.append(I(Op.ADDI, rd=10, rs1=0, imm=1))   # READ
            instrs.append(I(Op.ECALL))
            instrs.append(I(Op.ADDI, rd=11, rs1=10, imm=0))
            instrs.append(I(Op.ADDI, rd=10, rs1=0, imm=2))   # WRITE
            instrs.append(I(Op.ECALL))
    instrs += [I(Op.ADDI, rd=10, rs1=0, imm=0),
               I(Op.ADDI, rd=11, rs1=1, imm=0),  # exit code = r1 & ...
               I(Op.ANDI, rd=11, rs1=11, imm=0xFF),
               I(Op.ADDI, rd=10, rs1=0, imm=0),
               I(Op.ECALL)]
    inputs = [int(v) for v in rng.integers(0, 1 << 32, size=n_inputs)]
    return Program.from_instructions(instrs), inputs


def result_digest(result, lane: int = 0) -> str:
    """sha256 over (cycles, halt, exit code, outputs, final registers) of
    one lane of ``TpuInterpreter.run``'s result, in the corpus's format (a
    lane that left by the EXIT syscall hashes as ``exit``)."""
    from ..interp import HALT_EBREAK, HALT_EXIT

    halt = {HALT_EXIT: "exit", HALT_EBREAK: "ebreak"}.get(
        int(result["halted"][lane]), "cycle_limit")
    h = hashlib.sha256()
    h.update(str(int(result["cycles"][lane])).encode())
    h.update(halt.encode())
    h.update(str(int(result["exit_code"][lane])).encode())
    h.update(",".join(str(int(x)) for x in result["outputs"][lane]).encode())
    h.update(",".join(str(int(x)) for x in result["regs"][lane]).encode())
    return h.hexdigest()
