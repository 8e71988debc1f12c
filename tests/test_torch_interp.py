"""The port's interpreter (``zkir_tpu_torch.interp``) against the JAX
package's on the CPU, tolerance 0.

On the CPU the port runs the plain torch version of kernel K3
(``interp_chunk_plain``); the reference runs its jitted scan.  The same
programs and input tapes go through both: result dicts and trace dicts
must agree in keys, shapes and dtypes, in ``valid`` everywhere and in every
column where ``valid`` is true.  Every parity program ends in the same
unreachable filler (one instruction of each opcode family), so that the
reference compiles one step per code-size bucket instead of one per
family set.  The 64 seeds of ``tests/fuzz_corpus.json`` are held to their
pinned digests without the reference.

The reference's results of the parity runs (``run_both``) are stored in
``tests/fixtures/torch_port/interp_reference.npz``, by a digest of the
program, tapes, configuration and cycle limit; ``make_fixtures.py interp``
runs these tests with ``ZKIR_RECORD_INTERP_REFERENCE`` set to the file,
and ``run_both`` then runs the reference and records its results.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu.interp import InterpConfig as RefConfig
from zkir_tpu.interp import MachineState as RefState
from zkir_tpu.interp import TpuInterpreter as RefInterpreter
from zkir_tpu.interp.columnar import _merge_trace_host as ref_merge_trace
from zkir_tpu.spec import Program as RefProgram
from zkir_tpu_torch.asm import assemble
from zkir_tpu_torch.convert import (fixture_from_reference,
                                    machine_state_from_reference,
                                    machine_state_to_reference)
from zkir_tpu_torch.interp import (HALT_CYCLE_LIMIT, HALT_EBREAK, HALT_ERROR,
                                   HALT_EXIT, InterpConfig, TpuInterpreter)
from zkir_tpu_torch.interp import columnar as C
from zkir_tpu_torch.interp.checkpoint import load_state, save_state
from zkir_tpu_torch.prover import trace_to_matrix
from zkir_tpu_torch.prover.benchtrace import exact_trace_matrix
from zkir_tpu_torch.spec import Instruction, Op, Program
from zkir_tpu_torch.tools.fuzz_programs import generate_program, result_digest

from reference_runs import RunStore

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
# One small configuration shared by every parity case.
CFG = dict(lanes=2, chunk=64, low_bytes=1 << 15, stack_bytes=1 << 12,
           collect_trace=True)


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def I(op, **kw):  # noqa: E743
    return Instruction(op, **kw)


# One instruction of each opcode family, never reached: every program that
# ends in it has the reference's full feature set.
FILLER = [I(Op.MUL, rd=1, rs1=1, rs2=1), I(Op.MULH, rd=1, rs1=1, rs2=1),
          I(Op.DIVU, rd=1, rs1=1, rs2=1), I(Op.SLL, rd=1, rs1=1, rs2=1),
          I(Op.LB, rd=1, rs1=1, imm=0), I(Op.ECALL)]


def program_of(instrs, raw_tail=()):
    program = Program.from_instructions(list(instrs) + FILLER)
    program.code += list(raw_tail)
    program.header.code_size = len(program.code) * 4
    return program


REFERENCE_RUNS = RunStore(FIXTURES / "interp_reference.npz",
                          "ZKIR_RECORD_INTERP_REFERENCE")


@pytest.fixture(scope="module", autouse=True)
def _record_reference():
    """While recording, write the reference runs at the end."""
    yield
    REFERENCE_RUNS.write()


def run_both(program, tapes, max_cycles=100_000, **cfg):
    """The port's run and the reference's (stored; run and recorded while
    recording) of one program, tapes and configuration."""
    cfg = {**CFG, **cfg}
    port = TpuInterpreter(program, InterpConfig(**cfg), device="cpu").run(
        tapes, max_cycles=max_cycles)
    ref = REFERENCE_RUNS.result(
        program, tapes, max_cycles, cfg,
        lambda: RefInterpreter(RefProgram.from_bytes(program.to_bytes()),
                               RefConfig(**cfg)).run(
                                   tapes, max_cycles=max_cycles))
    return port, ref


def assert_same_trace(port, ref):
    assert set(port) == set(ref)
    valid = ref["valid"]
    for key, want in ref.items():
        got = port[key]
        assert got.dtype == want.dtype, key
        assert got.shape == want.shape, key
        if key == "valid":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(got[valid], want[valid], key)


def assert_same_result(port, ref):
    assert set(port) == set(ref)
    for key in ("halted", "exit_code", "cycles", "regs", "bound_bits"):
        assert port[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(port[key], ref[key], key)
    assert port["outputs"] == ref["outputs"]
    if "trace" in ref:
        assert_same_trace(port["trace"], ref["trace"])


# ============================================================================
# Unsigned 64-bit helpers of the plain version against Python integers
# ============================================================================

M64 = (1 << 64) - 1
EDGES = [0, 1, 2, (1 << 39), (1 << 40) - 1, (1 << 40), (1 << 62) + 5,
         (1 << 63) - 1, 1 << 63, (1 << 63) + 1, M64 - 1, M64]


def _pairs():
    rng = np.random.default_rng(20261016)
    vals = EDGES + [int(v) for v in rng.integers(0, 1 << 64, size=60,
                                                 dtype=np.uint64)]
    vals += [int(v) >> int(s) for v, s in zip(
        rng.integers(0, 1 << 64, size=40, dtype=np.uint64),
        rng.integers(0, 64, size=40))]
    a = [x for x in vals for _ in vals]
    b = [y for _ in vals for y in vals]
    return a, b


def _bits(values):
    return torch.from_numpy(np.asarray(values, dtype=np.uint64).view(np.int64))


def _unsigned(t):
    return [int(v) for v in t.numpy().view(np.uint64)]


class TestUnsigned64Helpers:
    def test_srl(self):
        a, _ = _pairs()
        a = a[::7]
        for s in (0, 1, 8, 20, 39, 40, 56, 63):
            assert _unsigned(C.u64_srl(_bits(a), s)) == [x >> s for x in a]
        shifts = [(x * 7 + 3) % 64 for x in range(len(a))]
        got = C.u64_srl(_bits(a), torch.tensor(shifts))
        assert _unsigned(got) == [x >> s for x, s in zip(a, shifts)]

    def test_ltu(self):
        a, b = _pairs()
        assert C.u64_ltu(_bits(a), _bits(b)).tolist() == [
            x < y for x, y in zip(a, b)]

    def test_divmod(self):
        a, b = _pairs()
        keep = [k for k, y in enumerate(b) if y != 0]
        a, b = [a[k] for k in keep], [b[k] for k in keep]
        q, r = C.u64_divmod(_bits(a), _bits(b))
        assert _unsigned(q) == [x // y for x, y in zip(a, b)]
        assert _unsigned(r) == [x % y for x, y in zip(a, b)]

    def test_mul_bits_40_80(self):
        a, b = _pairs()
        got = C.u64_mul_bits_40_80(_bits(a), _bits(b))
        assert _unsigned(got) == [((x * y) >> 40) & ((1 << 40) - 1)
                                  for x, y in zip(a, b)]

    def test_bit_length(self):
        a, _ = _pairs()
        a = a[::5]
        got = C.u64_bit_length(_bits(a))
        assert got.dtype == torch.int32
        assert got.tolist() == [x.bit_length() for x in a]


# ============================================================================
# Program by program against the reference interpreter
# ============================================================================


def _sha_like(num, message, ptr=0x3000, out=0x4000):
    """Store ``message`` byte by byte, hash it with syscall ``num``, WRITE
    the first digest word."""
    ins = []
    for i, byte in enumerate(message):
        ins += [I(Op.ADDI, rd=1, rs1=0, imm=ptr + i),
                I(Op.ADDI, rd=2, rs1=0, imm=byte),
                I(Op.SB, rs1=1, rs2=2, imm=0)]
    return ins + [
        I(Op.ADDI, rd=10, rs1=0, imm=num), I(Op.ADDI, rd=11, rs1=0, imm=ptr),
        I(Op.ADDI, rd=12, rs1=0, imm=len(message)),
        I(Op.ADDI, rd=13, rs1=0, imm=out), I(Op.ECALL),
        I(Op.ADDI, rd=1, rs1=0, imm=out), I(Op.LW, rd=11, rs1=1, imm=0),
        I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL)]


PROGRAMS = {
    "arith": [
        I(Op.ADDI, rd=1, rs1=0, imm=10), I(Op.ADDI, rd=2, rs1=0, imm=20),
        I(Op.ADD, rd=3, rs1=1, rs2=2), I(Op.SUB, rd=4, rs1=1, rs2=2),
        I(Op.MUL, rd=5, rs1=1, rs2=2), I(Op.MULH, rd=6, rs1=1, rs2=2),
        I(Op.EBREAK)],
    "wrap_40_bits": [
        I(Op.ADDI, rd=1, rs1=0, imm=-1), I(Op.ADDI, rd=2, rs1=0, imm=1),
        I(Op.ADD, rd=3, rs1=1, rs2=2), I(Op.SUB, rd=4, rs1=2, rs2=1),
        I(Op.MUL, rd=5, rs1=1, rs2=1), I(Op.MULH, rd=6, rs1=1, rs2=1),
        I(Op.EBREAK)],
    "div_family": [
        I(Op.ADDI, rd=1, rs1=0, imm=1000), I(Op.ADDI, rd=2, rs1=0, imm=7),
        I(Op.DIV, rd=3, rs1=1, rs2=2), I(Op.DIVU, rd=4, rs1=1, rs2=2),
        I(Op.REM, rd=5, rs1=1, rs2=2), I(Op.REMU, rd=6, rs1=1, rs2=2),
        I(Op.ADDI, rd=7, rs1=0, imm=-9), I(Op.DIV, rd=8, rs1=7, rs2=2),
        I(Op.EBREAK)],
    "logic_shift_compare": [
        I(Op.ADDI, rd=1, rs1=0, imm=0x5A5A), I(Op.ADDI, rd=2, rs1=0, imm=0x0F0F),
        I(Op.AND, rd=3, rs1=1, rs2=2), I(Op.OR, rd=4, rs1=1, rs2=2),
        I(Op.XOR, rd=5, rs1=1, rs2=2), I(Op.ANDI, rd=6, rs1=1, imm=-1),
        I(Op.ORI, rd=7, rs1=1, imm=0x33), I(Op.XORI, rd=8, rs1=1, imm=-256),
        I(Op.SLLI, rd=9, rs1=1, imm=8), I(Op.SRLI, rd=11, rs1=9, imm=3),
        I(Op.SRAI, rd=12, rs1=8, imm=4), I(Op.ADDI, rd=13, rs1=0, imm=3),
        I(Op.SLL, rd=14, rs1=1, rs2=13), I(Op.SRL, rd=14, rs1=14, rs2=13),
        I(Op.SRA, rd=15, rs1=8, rs2=13),
        I(Op.SLT, rd=3, rs1=8, rs2=1), I(Op.SLTU, rd=4, rs1=8, rs2=1),
        I(Op.SGE, rd=5, rs1=8, rs2=1), I(Op.SGEU, rd=6, rs1=8, rs2=1),
        I(Op.SEQ, rd=7, rs1=1, rs2=1), I(Op.SNE, rd=9, rs1=1, rs2=2),
        I(Op.EBREAK)],
    # Amounts of 40 and more clear (SLL, SRL) or fill (SRA of a negative);
    # a register amount is taken mod 64, an immediate one is 8 bits wide.
    "shift_edges": [
        I(Op.ADDI, rd=1, rs1=0, imm=-3), I(Op.ADDI, rd=2, rs1=0, imm=0x1234),
        I(Op.SLLI, rd=3, rs1=2, imm=39), I(Op.SLLI, rd=4, rs1=2, imm=40),
        I(Op.SRLI, rd=5, rs1=1, imm=45), I(Op.SRAI, rd=6, rs1=1, imm=63),
        I(Op.SRAI, rd=7, rs1=2, imm=200), I(Op.SRAI, rd=8, rs1=1, imm=39),
        I(Op.ADDI, rd=9, rs1=0, imm=64 + 50),
        I(Op.SLL, rd=11, rs1=2, rs2=9), I(Op.SRL, rd=12, rs1=1, rs2=9),
        I(Op.SRA, rd=13, rs1=1, rs2=9), I(Op.SRAI, rd=14, rs1=1, imm=0),
        I(Op.SLLI, rd=15, rs1=1, imm=1), I(Op.EBREAK)],
    # Words wider than 40 bits (a sign-extended LB, a signed quotient):
    # SEQ/SNE/BEQ/BNE see all 64 bits, CMOV and SD move the raw word, MULH
    # multiplies the raw words, JALR clears bit 0 of its target.
    "raw_64_bits": [
        I(Op.ADDI, rd=1, rs1=0, imm=0x3000), I(Op.ADDI, rd=2, rs1=0, imm=-1),
        I(Op.SB, rs1=1, rs2=2, imm=0), I(Op.LB, rd=3, rs1=1, imm=0),
        I(Op.SEQ, rd=4, rs1=2, rs2=3), I(Op.SNE, rd=5, rs1=2, rs2=3),
        I(Op.SLTU, rd=6, rs1=2, rs2=3), I(Op.SLT, rd=7, rs1=3, rs2=0),
        I(Op.BEQ, rs1=2, rs2=3, imm=8), I(Op.ADDI, rd=8, rs1=0, imm=77),
        I(Op.BNE, rs1=2, rs2=3, imm=8), I(Op.ADDI, rd=8, rs1=8, imm=1),
        I(Op.CMOV, rd=9, rs1=3, rs2=2), I(Op.SD, rs1=1, rs2=3, imm=8),
        I(Op.LD, rd=11, rs1=1, imm=8), I(Op.LH, rd=12, rs1=1, imm=8),
        I(Op.MULH, rd=13, rs1=3, rs2=3), I(Op.MULH, rd=14, rs1=3, rs2=2),
        I(Op.ADDI, rd=15, rs1=0, imm=5), I(Op.DIV, rd=13, rs1=3, rs2=15),
        I(Op.REM, rd=14, rs1=3, rs2=15), I(Op.DIVU, rd=4, rs1=3, rs2=15),
        I(Op.REMU, rd=5, rs1=3, rs2=15), I(Op.DIV, rd=6, rs1=15, rs2=3),
        I(Op.ADD, rd=7, rs1=3, rs2=3), I(Op.SRAI, rd=7, rs1=3, imm=4),
        I(Op.ADDI, rd=1, rs1=0, imm=0x1000 + 4 * 30 + 1),
        I(Op.JALR, rd=2, rs1=1, imm=0), I(Op.ADDI, rd=8, rs1=0, imm=-1),
        I(Op.EBREAK),                                   # word 30
        I(Op.ADDI, rd=8, rs1=0, imm=-1)],
    "cmov": [
        I(Op.ADDI, rd=1, rs1=0, imm=42), I(Op.ADDI, rd=2, rs1=0, imm=1),
        I(Op.ADDI, rd=3, rs1=0, imm=7), I(Op.CMOV, rd=3, rs1=1, rs2=2),
        I(Op.ADDI, rd=4, rs1=0, imm=7), I(Op.CMOV, rd=4, rs1=1, rs2=0),
        I(Op.CMOVZ, rd=5, rs1=1, rs2=0), I(Op.CMOVNZ, rd=6, rs1=1, rs2=2),
        I(Op.CMOVZ, rd=7, rs1=1, rs2=2), I(Op.CMOVNZ, rd=8, rs1=1, rs2=0),
        I(Op.EBREAK)],
    "memory_all_widths": [
        I(Op.ADDI, rd=1, rs1=0, imm=0x6000), I(Op.ADDI, rd=2, rs1=0, imm=-2),
        I(Op.SB, rs1=1, rs2=2, imm=0), I(Op.SH, rs1=1, rs2=2, imm=2),
        I(Op.SW, rs1=1, rs2=2, imm=4), I(Op.SD, rs1=1, rs2=2, imm=8),
        I(Op.LB, rd=3, rs1=1, imm=0), I(Op.LBU, rd=4, rs1=1, imm=0),
        I(Op.LH, rd=5, rs1=1, imm=2), I(Op.LHU, rd=6, rs1=1, imm=2),
        I(Op.LW, rd=7, rs1=1, imm=4), I(Op.LD, rd=8, rs1=1, imm=8),
        I(Op.LW, rd=9, rs1=1, imm=-0x5000),              # the code itself
        # The stack window, away from its last bytes (the reference's
        # clamped 8-byte store window is order-dependent there).
        I(Op.ADDI, rd=11, rs1=0, imm=-1), I(Op.ADDI, rd=11, rs1=11, imm=-255),
        I(Op.SD, rs1=11, rs2=2, imm=0), I(Op.SB, rs1=11, rs2=1, imm=9),
        I(Op.SH, rs1=11, rs2=1, imm=-2), I(Op.LD, rd=12, rs1=11, imm=8),
        I(Op.LW, rd=13, rs1=11, imm=-4), I(Op.LBU, rd=14, rs1=11, imm=7),
        I(Op.EBREAK)],
    "branches_and_jumps": [
        I(Op.ADDI, rd=1, rs1=0, imm=5), I(Op.ADDI, rd=2, rs1=2, imm=1),
        I(Op.ADDI, rd=1, rs1=1, imm=-1), I(Op.BNE, rs1=1, rs2=0, imm=-8),
        I(Op.ADDI, rd=6, rs1=0, imm=-5),
        I(Op.BLT, rs1=6, rs2=2, imm=8), I(Op.ADDI, rd=7, rs1=7, imm=1),
        I(Op.BGE, rs1=6, rs2=2, imm=8), I(Op.ADDI, rd=7, rs1=7, imm=2),
        I(Op.BLTU, rs1=6, rs2=2, imm=8), I(Op.ADDI, rd=7, rs1=7, imm=4),
        I(Op.BGEU, rs1=6, rs2=2, imm=8), I(Op.ADDI, rd=7, rs1=7, imm=8),
        I(Op.BEQ, rs1=2, rs2=2, imm=8), I(Op.ADDI, rd=7, rs1=7, imm=16),
        I(Op.JAL, rd=3, imm=8), I(Op.EBREAK),
        I(Op.ADDI, rd=4, rs1=0, imm=0x1000 + 4 * 16),
        I(Op.JALR, rd=5, rs1=4, imm=0)],
    # An ADD chain whose bound passes the data width: rc_valid fires.
    "range_check_witness": [
        I(Op.ADDI, rd=1, rs1=0, imm=-1), I(Op.ADD, rd=2, rs1=1, rs2=1),
        I(Op.ADD, rd=3, rs1=2, rs2=2), I(Op.MUL, rd=4, rs1=1, rs2=3),
        I(Op.ANDI, rd=5, rs1=4, imm=0xFF), I(Op.ADD, rd=6, rs1=5, rs2=5),
        I(Op.EBREAK)],
    "io_syscalls": [
        I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),
        I(Op.ADDI, rd=11, rs1=10, imm=0), I(Op.ADDI, rd=10, rs1=0, imm=2),
        I(Op.ECALL), I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),
        I(Op.ADDI, rd=11, rs1=10, imm=0), I(Op.ADDI, rd=10, rs1=0, imm=2),
        I(Op.ECALL), I(Op.ADDI, rd=11, rs1=0, imm=3),
        I(Op.ADDI, rd=10, rs1=0, imm=0), I(Op.ECALL)],
    "sha256_syscall": _sha_like(3, b"hello") + [I(Op.EBREAK)],
    "all_crypto_syscalls": (_sha_like(4, b"poseidon2 in") + _sha_like(
        5, b"keccak", ptr=0x3100, out=0x4100) + _sha_like(
            6, b"blake3", ptr=0x3200, out=0x4200) + [
                I(Op.LD, rd=3, rs1=1, imm=8), I(Op.EBREAK)]),
    # Faults: nothing but ``halted`` changes in the faulting cycle.
    "fault_div_by_zero": [
        I(Op.ADDI, rd=1, rs1=0, imm=5), I(Op.DIV, rd=3, rs1=1, rs2=2),
        I(Op.EBREAK)],
    "fault_pc_out_of_code": [
        I(Op.ADDI, rd=1, rs1=0, imm=5), I(Op.JAL, rd=2, imm=4000),
        I(Op.EBREAK)],
    "fault_pc_misaligned": [
        I(Op.ADDI, rd=1, rs1=0, imm=0x1002), I(Op.JALR, rd=2, rs1=1, imm=0),
        I(Op.EBREAK)],
    "fault_misaligned_access": [
        I(Op.ADDI, rd=1, rs1=0, imm=0x3001), I(Op.SB, rs1=1, rs2=1, imm=0),
        I(Op.LW, rd=2, rs1=1, imm=0), I(Op.EBREAK)],
    "fault_out_of_window": [
        I(Op.ADDI, rd=1, rs1=0, imm=0x9000), I(Op.SW, rs1=1, rs2=1, imm=0),
        I(Op.EBREAK)],
    "fault_below_stack_window": [
        I(Op.ADDI, rd=1, rs1=0, imm=-1), I(Op.ADDI, rd=1, rs1=1, imm=-4095),
        I(Op.LB, rd=2, rs1=1, imm=0), I(Op.LB, rd=3, rs1=1, imm=-1),
        I(Op.EBREAK)],
    "fault_bad_syscall": [                  # 6 is the last syscall number
        I(Op.ADDI, rd=10, rs1=0, imm=7), I(Op.ECALL), I(Op.EBREAK)],
    # r10 = 2^64 - 1: the sign-extended top byte (0xFF) of the first word.
    "fault_huge_syscall_number": [
        I(Op.ADDI, rd=1, rs1=0, imm=-1), I(Op.LB, rd=10, rs1=0, imm=0x1003),
        I(Op.ECALL), I(Op.EBREAK)],
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_parity(name):
    tapes = [[77], [1 << 39, 5]]
    port, ref = run_both(program_of(PROGRAMS[name]), tapes)
    assert_same_result(port, ref)
    want = HALT_ERROR if name.startswith("fault_") else None
    if want is not None:
        assert port["halted"].tolist() == [want, want]


def test_bad_opcode_parity():
    program = program_of([I(Op.ADDI, rd=1, rs1=0, imm=5),
                          I(Op.JAL, rd=0, imm=4 * (1 + len(FILLER)))],
                         raw_tail=[0x0000007F])
    port, ref = run_both(program, [[], []])
    assert_same_result(port, ref)
    assert port["halted"].tolist() == [HALT_ERROR, HALT_ERROR]
    assert port["cycles"].tolist() == [2, 2]


def test_cycle_limit_parity():
    port, ref = run_both(program_of([I(Op.JAL, rd=0, imm=0)]), [[], []],
                         max_cycles=128)
    assert_same_result(port, ref)
    assert port["halted"].tolist() == [HALT_CYCLE_LIMIT] * 2


def test_crypto_syscall_with_no_input_bytes():
    """SHA-256 of zero bytes from an input pointer outside both memory
    windows (2^21): the reference reads no input byte and halts 1 with
    0xe3b0c442, the first word of SHA-256 of the empty string; the port's
    interpreter (whose host services K3's paused syscalls too) and its
    oracle VM must give the same."""
    from zkir_tpu_torch.runtime import VM, VMConfig

    program = program_of([
        I(Op.ADDI, rd=11, rs1=0, imm=1), I(Op.SLLI, rd=11, rs1=11, imm=21),
        I(Op.ADDI, rd=10, rs1=0, imm=3), I(Op.ADDI, rd=12, rs1=0, imm=0),
        I(Op.ADDI, rd=13, rs1=0, imm=0x4000), I(Op.ECALL),
        I(Op.ADDI, rd=1, rs1=0, imm=0x4000), I(Op.LW, rd=11, rs1=1, imm=0),
        I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL), I(Op.EBREAK)])
    cfg = dict(lanes=1, chunk=16)
    port = TpuInterpreter(program, InterpConfig(**cfg), device="cpu").run(
        [[]])
    ref = REFERENCE_RUNS.result(
        program, [[]], "run", cfg,
        lambda: RefInterpreter(RefProgram.from_bytes(program.to_bytes()),
                               RefConfig(**cfg)).run([[]]))
    oracle = VM(program, [], VMConfig()).run()
    assert ref["halted"].tolist() == [HALT_EBREAK]
    assert ref["outputs"] == [[0xE3B0C442]]
    for key in ("halted", "cycles"):
        np.testing.assert_array_equal(port[key], ref[key], key)
    assert port["outputs"] == ref["outputs"]
    assert oracle.cycles == int(ref["cycles"][0])
    assert oracle.outputs == ref["outputs"][0]
    assert oracle.halt_reason.reason.value == "ebreak"


def test_four_hash_syscalls_batched_over_lanes():
    """Four lanes fill a buffer from their tapes, then call SHA-256,
    Keccak-256, BLAKE3 and Poseidon2 in turn over tape-given spans (block
    edges, a chunk edge, empty, low and stack windows), each digest written
    over the start of its input so that the next input begins with it, and
    WRITE each digest's first word.  Each service round hashes all paused
    lanes of a kind in one batch; result dicts (and traces) must equal the
    reference's, whose host services one lane at a time."""
    stack = (1 << 40) - 2048                # STACK_TOP + 1 - 2048
    ins = [I(Op.ADDI, rd=15, rs1=0, imm=0x3000)]
    for i in range(4):                      # four tape words into the buffer
        ins += [I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),
                I(Op.SD, rs1=15, rs2=10, imm=8 * i)]
    for kind in (3, 5, 6, 4):
        ins += [I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),   # length
                I(Op.ADDI, rd=12, rs1=10, imm=0),
                I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),   # pointer
                I(Op.ADDI, rd=11, rs1=10, imm=0),
                I(Op.ADDI, rd=13, rs1=10, imm=0),
                I(Op.ADDI, rd=10, rs1=0, imm=kind), I(Op.ECALL),
                I(Op.LW, rd=11, rs1=13, imm=0),
                I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL)]
    ins.append(I(Op.EBREAK))
    spans = [[(0, 0x3000), (55, 0x3000), (136, stack), (1025, 0x3000)],
             [(56, stack), (64, 0x3000), (137, 0x3000), (0, 0x3008)],
             [(3, 0x3000), (135, stack), (1024, stack), (200, 0x3004)],
             [(64, 0x3000), (1, 0x3000), (2048, stack), (57, stack)]]
    rng = np.random.default_rng(11)
    tapes = [[int(v) for v in rng.integers(0, 1 << 63, size=4)]
             + [x for span in lane for x in span] for lane in spans]
    port, ref = run_both(program_of(ins), tapes, lanes=4)
    assert_same_result(port, ref)
    assert port["halted"].tolist() == [HALT_EBREAK] * 4
    assert all(len(o) == 4 for o in port["outputs"])


def test_fibonacci_multi_lane_parity():
    program = assemble((ROOT / "examples" / "fibonacci.zkasm").read_text())
    tapes = [[5], [10], [15], [20]]
    port, ref = run_both(program_of([Instruction.decode(w)
                                     for w in program.code]),
                         tapes, lanes=4)
    assert_same_result(port, ref)
    assert [[int(x) for x in o] for o in port["outputs"]] == [
        [5], [55], [610], [6765]]
    assert port["halted"].tolist() == [HALT_EXIT] * 4


def test_no_memory_image_without_memory_ops():
    """A program with no load, store or ECALL carries a 1-byte image, as
    in the reference, and a trace all the same."""
    program = Program.from_instructions(
        [I(Op.ADDI, rd=1, rs1=0, imm=3), I(Op.SLLI, rd=2, rs1=1, imm=4),
         I(Op.EBREAK)])
    interp = TpuInterpreter(program, InterpConfig(**CFG), device="cpu")
    assert not interp.config.enable_memory
    assert interp.init_state([[], []]).mem.shape == (2, 1)
    port, ref = run_both(program, [[], []])
    assert_same_result(port, ref)
    assert port["halted"].tolist() == [HALT_EBREAK] * 2


@pytest.mark.parametrize("seed", [0, 7, 13, 21, 42, 63])
def test_fuzz_seed_parity(seed):
    """Fuzz programs against the reference, trace and all, two lanes with
    different tapes."""
    program, inputs = generate_program(seed)
    program = program_of([Instruction.decode(w) for w in program.code])
    port, ref = run_both(program,
                         [inputs, [x ^ 0x5A5A for x in inputs[::-1]]])
    assert_same_result(port, ref)
    assert port["halted"][0] == HALT_EXIT


@pytest.fixture(scope="module")
def corpus():
    return json.loads((ROOT / "tests" / "fuzz_corpus.json").read_text())


@pytest.mark.parametrize("seed", range(64))
def test_fuzz_corpus_digest(corpus, seed):
    """The port's digest of (cycles, halt, exit code, outputs, registers)
    equals the one pinned for the oracle VM."""
    program, inputs = generate_program(seed)
    interp = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=128, low_bytes=1 << 15, stack_bytes=1 << 12),
        device="cpu")
    result = interp.run([inputs], max_cycles=200_000)
    assert result_digest(result) == corpus[str(seed)]


# ============================================================================
# State carried across, checkpoints, matrices
# ============================================================================


def _ref_fields(state):
    return {name: np.asarray(value)
            for name, value in zip(RefState._fields, state)}


def reference_two_chunks(program, tapes, cfg):
    """Two chunks of the reference from the initial state: the states'
    fields after each (``first.<field>``, ``second.<field>``) and the
    second chunk's trace merged on the host (stored in
    ``REFERENCE_RUNS``)."""
    def run():
        import jax.numpy as jnp

        ref = RefInterpreter(RefProgram.from_bytes(program.to_bytes()),
                             RefConfig(**cfg))
        n_words = jnp.int32(ref.n_words)
        first, _ = ref._chunk_fn(ref.code, n_words, ref.init_state(tapes))
        second, trace = ref._chunk_fn(ref.code, n_words, first)
        return {**{f"first.{k}": v for k, v in _ref_fields(first).items()},
                **{f"second.{k}": v for k, v in _ref_fields(second).items()},
                "trace": ref_merge_trace({k: np.asarray(v)
                                          for k, v in trace.items()})}

    out = REFERENCE_RUNS.result(program, tapes, "two chunks", cfg, run)
    return tuple({k[len(p):]: v for k, v in out.items() if k.startswith(p)}
                 for p in ("first.", "second.")) + (out["trace"],)


def test_machine_state_carried_over_from_reference():
    """One chunk in the reference, its state carried across, one more
    chunk in both: equal states and traces."""
    program, inputs = generate_program(3)
    program = program_of([Instruction.decode(w) for w in program.code])
    tapes = [inputs, inputs[::-1]]
    cfg = {**CFG, "chunk": 32}
    first, second, ref_trace = reference_two_chunks(program, tapes, cfg)
    port = TpuInterpreter(program, InterpConfig(**cfg), device="cpu")
    state = machine_state_from_reference(first, device="cpu")
    assert int(state.cycles[0]) == 32

    state, trace = port.chunk_fn(state)
    back = machine_state_to_reference(state)
    for name, want in second.items():
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, name)
    assert_same_trace(
        C._merge_trace_host({k: v.numpy() for k, v in trace.items()}),
        ref_trace)


def test_checkpoint_round_trip_and_resume(tmp_path):
    program, inputs = generate_program(5)
    cfg = InterpConfig(**{**CFG, "chunk": 32})
    interp = TpuInterpreter(program, cfg, device="cpu")
    tapes = [inputs, inputs[::-1]]
    unbroken = interp.run(tapes)

    state, first = interp.chunk_fn(interp.init_state(tapes))
    path = str(tmp_path / "state.npz")
    save_state(path, interp, state)
    loaded_interp, loaded = load_state(path, device="cpu")
    assert loaded_interp.config == interp.config
    assert loaded_interp.program.to_bytes() == program.to_bytes()
    for name, a, b in zip(state._fields, state, loaded):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    resumed = loaded_interp.resume(loaded)
    for key in ("halted", "exit_code", "cycles", "regs", "bound_bits"):
        np.testing.assert_array_equal(resumed[key], unbroken[key], key)
    assert resumed["outputs"] == unbroken["outputs"]
    whole = C._merge_trace_host({k: v.numpy() for k, v in first.items()})
    for key, want in unbroken["trace"].items():
        got = np.concatenate([whole[key], resumed["trace"][key]])
        np.testing.assert_array_equal(got, want, key)


def test_reference_checkpoint_resumed_by_the_port(tmp_path):
    """A checkpoint ``.npz`` the reference wrote (its arrays stored in
    ``REFERENCE_RUNS``) is resumed by the port."""
    program = program_of(PROGRAMS["io_syscalls"])
    cfg = {**CFG, "chunk": 4}
    tapes = [[77], [5, 6]]

    def checkpoint():
        from zkir_tpu.interp.checkpoint import save_state as ref_save_state
        import jax.numpy as jnp

        ref = RefInterpreter(RefProgram.from_bytes(program.to_bytes()),
                             RefConfig(**cfg))
        ref_state, _ = ref._chunk_fn(ref.code, jnp.int32(ref.n_words),
                                     ref.init_state(tapes))
        path = str(tmp_path / "ref.npz")
        ref_save_state(path, ref, ref_state)
        with np.load(path) as arrays:
            return {k: arrays[k] for k in arrays.files}

    arrays = REFERENCE_RUNS.result(program, tapes, "checkpoint", cfg,
                                   checkpoint)
    port = TpuInterpreter(program, InterpConfig(**cfg), device="cpu")
    state = machine_state_from_reference(arrays, device="cpu")
    resumed = port.resume(state)
    whole = port.run(tapes)
    for key in ("halted", "exit_code", "cycles", "regs", "bound_bits"):
        np.testing.assert_array_equal(resumed[key], whole[key], key)
    assert resumed["outputs"] == whole["outputs"] == [[77, 0], [5, 6]]


@pytest.mark.parametrize("name,tape,chunk", [
    ("golden_a", [10], 256), ("golden_d", [10], 256), ("golden_e", [], 16)])
def test_port_trace_gives_the_golden_matrix(name, tape, chunk):
    """``trace_to_matrix`` of the port's trace equals the matrix the
    reference CLI (A, D) or the reference interpreter (E) made."""
    fx = fixture_from_reference(FIXTURES, name)
    program = fx["program"] or assemble(
        (ROOT / "examples" / "fibonacci.zkasm").read_text())
    interp = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=chunk, collect_trace=True), device="cpu")
    result = interp.run([tape], max_cycles=100_000)
    matrix = trace_to_matrix(result["trace"], program=program)
    assert matrix.dtype == fx["matrix"].dtype
    np.testing.assert_array_equal(matrix, fx["matrix"])


@pytest.mark.parametrize("name,log_rows", [("golden_b", 8), ("golden_c", 10)])
def test_exact_trace_matrix_equals_golden(name, log_rows):
    fx = fixture_from_reference(FIXTURES, name)
    np.testing.assert_array_equal(
        exact_trace_matrix(log_rows, chunk=256, device="cpu"), fx["matrix"])
