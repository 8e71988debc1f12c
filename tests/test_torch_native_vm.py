"""The port's native engine (``zkir_tpu_torch.runtime.native_vm``) and
``run --engine`` against the JAX package's, on the CPU.

The cases of ``tests/test_native_vm.py`` (but its speed test) run through
both packages' ``run_native``, which must give the same result; the
reference's ``run`` line and exit code at a cycle limit; crypto syscalls
halt with ``HALT_UNSUPPORTED_SYSCALL``; a host engine needs no GPU.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu.cli import main as ref_main
from zkir_tpu.runtime.native_vm import run_native as ref_run_native
from zkir_tpu.spec import Program as RefProgram
from zkir_tpu_torch.asm import assemble
from zkir_tpu_torch.cli import main
from zkir_tpu_torch.runtime import native_vm
from zkir_tpu_torch.spec import Instruction, Op, Program

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIB = str(ROOT / "examples" / "fibonacci.zkasm")


def I(op, **kw):  # noqa: E743
    return Instruction(op, **kw)


def both(program, inputs, max_cycles=100_000):
    """The port's result, held equal to the reference's."""
    port = native_vm.run_native(program, list(inputs), max_cycles=max_cycles)
    ref = ref_run_native(RefProgram.from_bytes(program.to_bytes()),
                         list(inputs), max_cycles=max_cycles)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    return port


@pytest.mark.parametrize("n", [0, 1, 10, 30])
def test_fibonacci(n):
    result = both(assemble(pathlib.Path(FIB).read_text()), [n])
    assert result.halt == native_vm.HALT_EXIT


def test_all_widths_memory():
    result = both(Program.from_instructions([
        I(Op.ADDI, rd=1, rs1=0, imm=0x8000),
        I(Op.ADDI, rd=2, rs1=0, imm=-2),
        I(Op.SB, rs1=1, rs2=2, imm=0),
        I(Op.SH, rs1=1, rs2=2, imm=2),
        I(Op.SW, rs1=1, rs2=2, imm=4),
        I(Op.SD, rs1=1, rs2=2, imm=8),
        I(Op.LB, rd=3, rs1=1, imm=0),
        I(Op.LBU, rd=4, rs1=1, imm=0),
        I(Op.LH, rd=5, rs1=1, imm=2),
        I(Op.LHU, rd=6, rs1=1, imm=2),
        I(Op.LW, rd=7, rs1=1, imm=4),
        I(Op.LD, rd=8, rs1=1, imm=8),
        I(Op.EBREAK),
    ]), [])
    assert result.halt == native_vm.HALT_EBREAK


def test_div_semantics():
    both(Program.from_instructions([
        I(Op.ADDI, rd=1, rs1=0, imm=-9),
        I(Op.ADDI, rd=2, rs1=0, imm=7),
        I(Op.DIV, rd=3, rs1=1, rs2=2),
        I(Op.REM, rd=4, rs1=1, rs2=2),
        I(Op.DIVU, rd=5, rs1=1, rs2=2),
        I(Op.REMU, rd=6, rs1=1, rs2=2),
        I(Op.EBREAK),
    ]), [])


def test_cycle_limit():
    result = both(Program.from_instructions([I(Op.JAL, rd=0, imm=0)]), [],
                  max_cycles=500)
    assert (result.halt, result.cycles) == (native_vm.HALT_CYCLE_LIMIT, 500)


def test_div_zero_errors():
    result = both(Program.from_instructions([
        I(Op.ADDI, rd=1, rs1=0, imm=5),
        I(Op.DIV, rd=3, rs1=1, rs2=2),
    ]), [])
    assert result.halt == native_vm.HALT_ERROR


@pytest.mark.parametrize("seed", [77, 78, 79])
def test_random_programs(seed):
    rng = np.random.default_rng(seed)
    safe = [Op.ADD, Op.SUB, Op.MUL, Op.MULH, Op.AND, Op.OR, Op.XOR,
            Op.SLL, Op.SRL, Op.SRA, Op.SLT, Op.SLTU, Op.SGE, Op.SGEU,
            Op.SEQ, Op.SNE, Op.CMOV, Op.CMOVZ, Op.CMOVNZ,
            Op.ADDI, Op.ANDI, Op.ORI, Op.XORI, Op.SLLI, Op.SRLI, Op.SRAI]
    instrs = [I(Op.ADDI, rd=r, rs1=0,
                imm=int(rng.integers(-(1 << 16), 1 << 16)))
              for r in range(1, 16)]
    for _ in range(200):
        op = safe[int(rng.integers(len(safe)))]
        rd, rs1, rs2 = (int(rng.integers(1, 16)), int(rng.integers(16)),
                        int(rng.integers(16)))
        if op in (Op.SLLI, Op.SRLI, Op.SRAI):
            instrs.append(I(op, rd=rd, rs1=rs1, imm=int(rng.integers(64))))
        elif op in (Op.ADDI, Op.ANDI, Op.ORI, Op.XORI):
            instrs.append(I(op, rd=rd, rs1=rs1, imm=int(
                rng.integers(-(1 << 16), 1 << 16))))
        else:
            instrs.append(I(op, rd=rd, rs1=rs1, rs2=rs2))
    instrs.append(I(Op.EBREAK))
    assert both(Program.from_instructions(instrs), []).halt == \
        native_vm.HALT_EBREAK


def test_crypto_syscall_halts_unsupported():
    result = both(Program.from_instructions([
        I(Op.ADDI, rd=10, rs1=0, imm=4), I(Op.ECALL), I(Op.EBREAK)]), [])
    assert result.halt == native_vm.HALT_UNSUPPORTED_SYSCALL == 6


def test_run_stops_at_the_cycle_limit_as_the_reference(capsys):
    """At a cycle limit both CLIs print the native engine's line and exit
    1 (the port's native engine: named, or the default with ``--device
    cpu``); ``--engine gpu`` prints the batched interpreter's line (its
    limit is checked between chunks) and exits 0."""
    args = ["run", FIB, "--input", "10", "--max-cycles", "5"]
    assert ref_main(["--platform", "cpu", *args]) == 1
    want = "halt=3 cycles=5 exit=0 outputs=[]\n"
    assert capsys.readouterr().out == want
    assert main([*args, "--engine", "native"]) == 1
    assert capsys.readouterr().out == want
    assert main(["--device", "cpu", *args]) == 1
    assert capsys.readouterr().out == want
    assert main(["--device", "cpu", *args, "--engine", "gpu"]) == 0
    assert capsys.readouterr().out == "halt=2 cycles=62 exit=0 outputs=[55]\n"


def test_host_engine_needs_no_gpu(capsys):
    """``--engine native`` runs without a card; with an explicit
    ``--device cuda`` it is refused rather than run on the host; without
    a card, ``--engine gpu`` fails with a message."""
    assert main(["run", FIB, "--input", "10", "--engine", "native"]) == 0
    assert capsys.readouterr().out == "halt=2 cycles=62 exit=0 outputs=[55]\n"
    with pytest.raises(SystemExit, match="--engine native runs on the host"):
        main(["--device", "cuda", "run", FIB, "--engine", "native"])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["run", FIB, "--input", "10", "--engine", "gpu"])


def test_library_builds_from_the_ports_copy(tmp_path, monkeypatch):
    """The port builds its own copy of the reference's source (equal below
    the note that heads it) into ``zkir_tpu_torch/_build/``; a source that
    does not compile raises ``NativeBuildError``."""
    port_src = native_vm._SRC.read_text()
    ref_src = (ROOT / "native" / "zkir_vm.cpp").read_text()
    assert port_src.endswith(ref_src) and len(port_src) > len(ref_src)
    native_vm.ensure_built()
    assert native_vm.library_path().exists()
    assert native_vm.library_path().parent == ROOT / "zkir_tpu_torch" / "_build"
    bad = tmp_path / "zkir_vm.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_vm, "_SRC", bad)
    monkeypatch.setattr(native_vm, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native_vm, "_lib", None)
    with pytest.raises(native_vm.NativeBuildError):
        native_vm.ensure_built()
