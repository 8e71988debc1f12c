"""The port's toolchain and CLI against the JAX package's, on the CPU.

Assembler and disassembler: the same sources give the same bytes, the same
listings and the same error texts in both packages.  CLI: ``main([...,
"--device", "cpu", ...])`` in-process reproduces the reference CLI's
golden proofs and printed lines, also on a mesh of two gloo ranks
(``prove --mesh 2``), and ``warm`` prints the reference's line.
"""

import json
import pathlib

import pytest
import torch

from zkir_tpu.asm import AssemblerError as RefAssemblerError
from zkir_tpu.asm import assemble as ref_assemble
from zkir_tpu.asm import disassemble as ref_disassemble
from zkir_tpu.spec import Program as RefProgram
from zkir_tpu_torch.asm import AssemblerError, assemble, decode, disassemble
from zkir_tpu_torch.cli import main
from zkir_tpu_torch.spec import Op, Program

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
FIB = str(EXAMPLES / "fibonacci.zkasm")


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SOURCES = {
    "fibonacci": (EXAMPLES / "fibonacci.zkasm").read_text(),
    "add": (EXAMPLES / "add.zkasm").read_text(),
    "config": (".config limb_bits 20\n.config data_limbs 2\n"
               ".config addr_limbs 2\nadd r1, r2, r3\necall\n"),
    "labels": ("    addi r1, r0, 1\nloop:\n    addi r1, r1, 1\n"
               "    bne r1, r2, loop\n    jal r3, loop\n    ebreak\n"),
    "aliases": "start:\n add a0, t0, s0\n beq a0, zero, 8\nend:\n ebreak\n",
    "every_shape": ("mulh r1, r2, r3\nxori r4, r5, -256\nsrai r6, r7, 63\n"
                    "lhu r8, -4(r9)\nsd r10, 0x10(r11)\nbgeu r12, r13, -8\n"
                    "jalr r14, r15, 0b101\ncmovnz r1, r2, r3\n"),
}

MALFORMED = [
    "add r1, r2\n", "add r1, r2, r3, r4\n", "add r1 r2 r3\n",
    "add r1, r2, 5\n", "addi r1, r2, r3\n", "lw r1, r2, 4\n",
    "bogus r1, r2, r3\n", "add r16, r2, r3\n", "ecall r1\n",
    ".config limb_bits 15\n", ".config data_limbs 5\n", ".config bogus 1\n",
    "a:\na:\n", "beq r1, r2, nowhere\n", "add r1, r2, $\n",
]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_assembles_to_the_reference_bytes(name):
    program = assemble(SOURCES[name])
    want = ref_assemble(SOURCES[name])
    assert program.to_bytes() == want.to_bytes()
    assert program.code == want.code
    assert Program.from_bytes(want.to_bytes()).to_bytes() == want.to_bytes()


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_disassembles_to_the_reference_listing(name):
    binary = ref_assemble(SOURCES[name]).to_bytes()
    listing = disassemble(Program.from_bytes(binary))
    assert listing == ref_disassemble(RefProgram.from_bytes(binary))
    # The instruction words survive a decode/encode round trip.
    program = Program.from_bytes(binary)
    assert [decode(w).encode() for w in program.code] == program.code


def test_listing_matches_its_words():
    """Each listing line holds the address, the word and the mnemonic of
    the instruction it stands for (the formatter prints the spec's display
    names for registers, which the assembler's alias map does not share,
    so the round trip is held through ``decode``)."""
    program = assemble(SOURCES["every_shape"] + SOURCES["add"])
    lines = [line.split() for line in disassemble(program).splitlines()
             if line.startswith("0x")]
    assert len(lines) == len(program.code)
    for k, (word, fields) in enumerate(zip(program.code, lines)):
        assert fields[0] == f"0x{0x1000 + 4 * k:08X}:"
        assert fields[1] == f"{word:08X}"
        assert fields[2] == decode(word).op.name.lower()
        assert decode(word).encode() == word


@pytest.mark.parametrize("src", MALFORMED)
def test_rejects_with_the_reference_message(src):
    with pytest.raises(RefAssemblerError) as want:
        ref_assemble(src)
    with pytest.raises(AssemblerError) as got:
        assemble(src)
    assert str(got.value) == str(want.value)


def test_label_resolves_to_a_relative_offset():
    inst = decode(assemble(SOURCES["labels"]).code[2])
    assert inst.op == Op.BNE and inst.imm == -4


# ============================================================================
# CLI, in-process, on the CPU
# ============================================================================


def cli(*args):
    return main(["--device", "cpu", *args])


def test_asm_disasm_commands(tmp_path, capsys):
    out = tmp_path / "fib.zkir"
    assert cli("asm", FIB, "-o", str(out)) == 0
    assert out.read_bytes() == ref_assemble(SOURCES["fibonacci"]).to_bytes()
    n = len(assemble(SOURCES["fibonacci"]).code)
    assert capsys.readouterr().out == f"assembled {n} instructions -> {out}\n"
    assert cli("disasm", str(out)) == 0
    assert capsys.readouterr().out == ref_disassemble(
        ref_assemble(SOURCES["fibonacci"]))


def test_run_prints_the_reference_line(capsys):
    assert cli("run", str(EXAMPLES / "add.zkasm"), "--input", "2",
               "--input", "3") == 0
    assert capsys.readouterr().out == "halt=2 cycles=11 exit=0 outputs=[5]\n"
    assert cli("run", FIB, "--input", "0x0a", "--engine", "gpu") == 0
    assert capsys.readouterr().out == "halt=2 cycles=62 exit=0 outputs=[55]\n"


@pytest.fixture(scope="module")
def bound_proof(tmp_path_factory):
    """``prove --bind`` of the Fibonacci example: (path, printed text)."""
    path = tmp_path_factory.mktemp("cli") / "d.json"
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli("prove", FIB, "--input", "10", "--bind", "-o", str(path))
    assert rc == 0
    return path, buf.getvalue()


def test_prove_bind_reproduces_golden_d(bound_proof):
    path, printed = bound_proof
    assert printed == f"proved 62 trace rows (62 cycles) -> {path}\n"
    want = json.loads((FIXTURES / "golden_d.proof.json").read_text())
    assert json.loads(path.read_text()) == want


def test_verify_accepts_with_the_program(bound_proof, capsys):
    assert cli("verify", str(bound_proof[0]), "--binary", FIB) == 0
    assert capsys.readouterr().out == "VALID\n"


def test_verify_refuses_another_program(bound_proof, capsys):
    assert cli("verify", str(bound_proof[0]), "--binary",
               str(FIXTURES / "golden_e.program.zkir")) == 1
    assert capsys.readouterr().out == "INVALID\n"


def test_bound_proof_needs_the_program(bound_proof, capsys):
    assert cli("verify", str(bound_proof[0])) == 1
    assert capsys.readouterr().out == (
        "error: program-bound proof requires the public program "
        "(pass --binary); the memory argument's init demand is "
        "recomputed from its code/data segments\n")


def test_prove_without_bind_reproduces_golden_a(tmp_path, capsys):
    path = tmp_path / "a.json"
    assert cli("prove", FIB, "--input", "10", "-o", str(path)) == 0
    want = json.loads((FIXTURES / "golden_a.proof.json").read_text())
    assert json.loads(path.read_text()) == want
    assert cli("verify", str(path)) == 0
    assert capsys.readouterr().out.endswith("VALID\n")


def test_prove_streaming_bind_reproduces_golden_d(tmp_path, capsys):
    """The streaming prover behind ``--streaming``: the same proof, the
    same printed line."""
    path = tmp_path / "ds.json"
    assert cli("prove", FIB, "--input", "10", "--streaming", "--bind",
               "--col-block", "100", "-o", str(path)) == 0
    assert capsys.readouterr().out == \
        f"proved 62 trace rows (62 cycles) -> {path}\n"
    want = json.loads((FIXTURES / "golden_d.proof.json").read_text())
    assert json.loads(path.read_text()) == want


@pytest.mark.parametrize("flags", [
    ["--bind"], ["--streaming", "--bind", "--col-block", "100"]],
    ids=["one-shot", "streaming"])
def test_prove_on_a_mesh_of_two_reproduces_golden_d(tmp_path, capfd, flags):
    """``prove --mesh 2`` on the CPU: two gloo ranks, a process each, prove
    over ``make_mesh(2)``; rank 0 writes golden D and prints the line, the
    other rank prints nothing."""
    path = tmp_path / "d.json"
    assert cli("prove", FIB, "--input", "10", *flags, "--mesh", "2", "-o",
               str(path)) == 0
    assert capfd.readouterr().out == \
        f"proved 62 trace rows (62 cycles) -> {path}\n"
    want = json.loads((FIXTURES / "golden_d.proof.json").read_text())
    assert json.loads(path.read_text()) == want


@pytest.mark.parametrize("n", ["3", "6"])
def test_prove_refuses_a_mesh_of_no_power_of_two(n):
    with pytest.raises(SystemExit, match="power of two"):
        cli("prove", FIB, "--input", "10", "--mesh", n)


def test_prove_refuses_more_ranks_than_cards(monkeypatch):
    """On ``cuda`` every rank needs a card of its own: a mesh larger than
    the card count is refused before any rank starts (the card count is
    faked here; no process is spawned)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit,
                       match="requested 2 devices, only 1 available"):
        main(["prove", FIB, "--input", "10", "--mesh", "2"])


def test_a_failing_rank_fails_the_prove(tmp_path):
    """Both ranks of ``prove --mesh 2`` fail to read a missing program: the
    command raises with a rank's traceback (``python -m`` exits 1)."""
    import torch.multiprocessing as mp

    with pytest.raises(mp.ProcessRaisedException, match="FileNotFoundError"):
        cli("prove", str(tmp_path / "missing.zkasm"), "--mesh", "2")


@pytest.mark.parametrize("flags", [[], ["--streaming"]],
                         ids=["one-shot", "streaming"])
def test_warm_proves_and_prints_the_reference_line(
        monkeypatch, tmp_path, capsys, flags):
    """``warm --log-rows 10``: a synthetic 2^10-row trace proved and
    verified, the reference's line printed; ``--cache-dir`` moves the
    quotient's build directory (on the CPU nothing is built there)."""
    import re

    from zkir_tpu_torch.prover import quotient_codegen

    monkeypatch.delenv("ZKIR_CACHE_DIR", raising=False)
    assert cli("warm", "--log-rows", "10", "--cache-dir", str(tmp_path),
               *flags) == 0
    assert re.fullmatch(r"warmed prove kernels for 2\^10 rows in \d+\.\ds\n",
                        capsys.readouterr().out)
    assert quotient_codegen.build_dir() == tmp_path / "quotient"
    assert not (tmp_path / "quotient").exists()


def test_cache_dir_names_the_quotient_build_directory(monkeypatch, tmp_path):
    from zkir_tpu_torch.prover import quotient_codegen

    monkeypatch.delenv("ZKIR_CACHE_DIR", raising=False)
    assert quotient_codegen.build_dir() == quotient_codegen.BUILD
    monkeypatch.setenv("ZKIR_CACHE_DIR", str(tmp_path))
    assert quotient_codegen.build_dir() == tmp_path / "quotient"


def test_default_device_needs_a_gpu(capsys):
    """Without ``--device cpu`` and without a GPU the CLI fails with a
    message; it never runs quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as exc:
        main(["run", FIB, "--input", "10"])
    assert "--device cpu" in str(exc.value)
    assert exc.value.code not in (0, None)
