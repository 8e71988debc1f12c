"""The port's scalar oracle VM (``zkir_tpu_torch.runtime``) and its spec
modules against the JAX package's, on the CPU, tolerance 0.

Both oracles are pure Python.  The programs of ``tests/test_oracle_vm.py``
and the four crypto syscalls run through both ``VM``s, with the witness
collection off and all on (execution trace, range checks, the deferred
model): every field of the ``ExecutionResult`` and of the final
``VMState`` must agree.  Then the deferred model's vectors of
``tests/test_deferred.py`` on the port's own modules, the validator, the
value classes and the static analyzer beside the reference's, the 64
seeds of ``tests/fuzz_corpus.json`` held to their pinned oracle digests,
and ``run --engine oracle`` through both CLIs.
"""

import dataclasses
import enum
import hashlib
import json
import pathlib

import pytest

from zkir_tpu.cli import main as ref_main
from zkir_tpu.runtime import VM as RefVM
from zkir_tpu.runtime import VMConfig as RefVMConfig
from zkir_tpu.spec import Program as RefProgram
from zkir_tpu.spec import analyzer as ref_analyzer
from zkir_tpu.spec import validation as ref_validation
from zkir_tpu.spec import values as ref_values
from zkir_tpu_torch.asm import assemble
from zkir_tpu_torch.cli import main
from zkir_tpu_torch.runtime import (VM, DeferredConfig, HaltReason, RegState,
                                    VMConfig, VMState, run)
from zkir_tpu_torch.runtime.deferred import (execute_add_deferred,
                                             execute_addi_deferred,
                                             execute_sub_deferred)
from zkir_tpu_torch.runtime.normalize import normalize_register, would_overflow
from zkir_tpu_torch.spec import (Instruction, Op, Program, ValidationError,
                                 validate_instruction, validate_program)
from zkir_tpu_torch.spec import analyzer, values
from zkir_tpu_torch.tools.fuzz_programs import generate_program

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def I(op, **kw):  # noqa: E743
    return Instruction(op, **kw)


def prog(*instrs, data=b""):
    program = Program.from_instructions(list(instrs))
    program.data = bytes(data)
    program.header.data_size = len(data)
    return program


def canon(x):
    """A value of either package as plain Python: enums by class name and
    value, dataclasses and objects by class name and fields."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: canon(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if hasattr(x, "__dict__"):
        return (type(x).__name__, {k: canon(v) for k, v in vars(x).items()})
    return x


def run_both(program, inputs, **config):
    """The port's oracle and the reference's on one program: (result,
    final state) of each as plain Python, or the error each raised."""
    out = []
    for vm_cls, cfg_cls, prog_of in (
            (VM, VMConfig, lambda p: p),
            (RefVM, RefVMConfig,
             lambda p: RefProgram.from_bytes(p.to_bytes()))):
        vm = vm_cls(prog_of(program), list(inputs), cfg_cls(**config))
        try:
            result = vm.run()
        except Exception as exc:  # the same error from both
            out.append(("raised", type(exc).__name__, str(exc)))
            continue
        state = {k: canon(v) for k, v in vars(vm.state).items()}
        out.append((canon(result), state))
    return out


FULL = dict(enable_execution_trace=True, enable_range_checking=True,
            enable_deferred_model=True)


def crypto_program(num, message):
    """The syscall ``num`` over ``message`` (in the data section), its
    32-byte digest at 0x4000, its first two words written out."""
    code = [
        I(Op.ADDI, rd=10, rs1=0, imm=num),
        I(Op.ADDI, rd=12, rs1=0, imm=len(message)),
        I(Op.ADDI, rd=13, rs1=0, imm=0x4000),
        None,                                    # r11 = the data's address
        I(Op.ECALL),
        I(Op.ADDI, rd=1, rs1=0, imm=0x4000),
        I(Op.LW, rd=11, rs1=1, imm=0),
        I(Op.ADDI, rd=10, rs1=0, imm=2),
        I(Op.ECALL),
        I(Op.LD, rd=11, rs1=1, imm=8),
        I(Op.ECALL),
        I(Op.EBREAK),
    ]
    code[3] = I(Op.ADDI, rd=11, rs1=0, imm=0x1000 + 4 * len(code))
    return prog(*code, data=message)


def _long(n):
    return bytes((7 * k + 3) & 0xFF for k in range(n))


# The programs of tests/test_oracle_vm.py (name -> program, tape, limit).
PROGRAMS = {
    "basic": (prog(I(Op.ADDI, rd=1, rs1=0, imm=10),
                   I(Op.ADDI, rd=2, rs1=0, imm=20),
                   I(Op.ADD, rd=3, rs1=1, rs2=2), I(Op.EBREAK)), [], None),
    "exit_syscall": (prog(I(Op.ADDI, rd=10, rs1=0, imm=0),
                          I(Op.ADDI, rd=11, rs1=0, imm=42), I(Op.ECALL)),
                     [], None),
    "io_syscalls": (prog(I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),
                         I(Op.ADDI, rd=11, rs1=10, imm=0),
                         I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),
                         I(Op.ADDI, rd=11, rs1=0, imm=0),
                         I(Op.ADDI, rd=10, rs1=0, imm=0), I(Op.ECALL)),
                    [123], None),
    "read_exhausted": (prog(I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),
                            I(Op.ADDI, rd=11, rs1=10, imm=0),
                            I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),
                            I(Op.EBREAK)), [], None),
    "cycle_limit": (prog(I(Op.JAL, rd=0, imm=0)), [], 100),
    "branch_skips": (prog(I(Op.ADDI, rd=1, rs1=0, imm=10),
                          I(Op.ADDI, rd=2, rs1=0, imm=10),
                          I(Op.BEQ, rs1=1, rs2=2, imm=8),
                          I(Op.ADDI, rd=3, rs1=0, imm=99), I(Op.EBREAK)),
                     [], None),
    "invalid_syscall": (prog(I(Op.ADDI, rd=10, rs1=0, imm=999),
                             I(Op.ECALL)), [], None),
    "div_by_zero": (prog(I(Op.ADDI, rd=1, rs1=0, imm=5),
                         I(Op.DIV, rd=3, rs1=1, rs2=2), I(Op.EBREAK)),
                    [], None),
    "memory_ops": (prog(I(Op.ADDI, rd=1, rs1=0, imm=0x42),
                        I(Op.ADDI, rd=3, rs1=0, imm=0x1000),
                        I(Op.SW, rs1=3, rs2=1, imm=0),
                        I(Op.LW, rd=4, rs1=3, imm=0), I(Op.EBREAK)),
                   [], None),
    "all_widths": (prog(I(Op.ADDI, rd=1, rs1=0, imm=0x8000),
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
                        I(Op.LD, rd=8, rs1=1, imm=8), I(Op.EBREAK)),
                   [], None),
    "trace_count": (prog(*[I(Op.ADDI, rd=1, rs1=0, imm=i)
                           for i in range(10)], I(Op.EBREAK)), [], None),
    "range_accumulated": (prog(I(Op.ADDI, rd=1, rs1=0, imm=(1 << 15) - 1),
                               *[I(Op.ADD, rd=1, rs1=1, rs2=1)] * 30,
                               I(Op.ADDI, rd=2, rs1=0, imm=0x1000),
                               I(Op.SW, rs1=2, rs2=1, imm=0), I(Op.EBREAK)),
                          [], None),
    "range_small": (prog(I(Op.ADDI, rd=1, rs1=0, imm=100),
                         I(Op.ADDI, rd=2, rs1=0, imm=200),
                         I(Op.ADD, rd=3, rs1=1, rs2=2),
                         I(Op.ADDI, rd=4, rs1=0, imm=0x2000),
                         I(Op.SW, rs1=4, rs2=3, imm=0), I(Op.EBREAK)),
                    [], None),
    "long_program": (prog(*[I(Op.ADDI, rd=1 + (i % 15), rs1=0, imm=i % 1000)
                            for i in range(1000)], I(Op.EBREAK)), [], None),
    "tight_loop": (prog(I(Op.ADDI, rd=1, rs1=0, imm=100),
                        I(Op.ADDI, rd=1, rs1=1, imm=-1),
                        I(Op.BNE, rs1=1, rs2=0, imm=-4), I(Op.EBREAK)),
                   [], None),
    "nested_loops": (prog(I(Op.ADDI, rd=1, rs1=0, imm=10),
                          I(Op.ADDI, rd=2, rs1=0, imm=10),
                          I(Op.ADDI, rd=3, rs1=3, imm=1),
                          I(Op.ADDI, rd=2, rs1=2, imm=-1),
                          I(Op.BNE, rs1=2, rs2=0, imm=-8),
                          I(Op.ADDI, rd=1, rs1=1, imm=-1),
                          I(Op.BNE, rs1=1, rs2=0, imm=-20), I(Op.EBREAK)),
                     [], None),
    "fibonacci_20": (assemble((EXAMPLES / "fibonacci.zkasm").read_text()),
                     [20], None),
    "add": (assemble((EXAMPLES / "add.zkasm").read_text()), [2, 3], None),
    "sha256": (crypto_program(3, b"hello"), [], None),
    "sha256_two_blocks": (crypto_program(3, _long(100)), [], None),
    "poseidon2": (crypto_program(4, b"hello"), [], None),
    "poseidon2_long": (crypto_program(4, _long(45)), [], None),
    "keccak256": (crypto_program(5, b"hello"), [], None),
    "keccak256_two_blocks": (crypto_program(5, _long(200)), [], None),
    "blake3": (crypto_program(6, b"hello"), [], None),
    "blake3_two_chunks": (crypto_program(6, _long(1100)), [], None),
}


@pytest.mark.parametrize("witnesses", ["off", "all"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_vm_matches_reference(name, witnesses):
    program, tape, limit = PROGRAMS[name]
    config = dict(FULL) if witnesses == "all" else {}
    if limit is not None:
        config["max_cycles"] = limit
    port, ref = run_both(program, tape, **config)
    assert port == ref
    if name.startswith(("sha", "poseidon", "keccak", "blake")):
        result = port[0][1]
        assert result["outputs"] and result["halt_reason"][1]["reason"] \
            == ("HaltReason", "ebreak")
        # BLAKE3 records no witness, SHA-256 none past one block (as in
        # the reference).
        if witnesses == "all" and name not in (
                "blake3", "blake3_two_chunks", "sha256_two_blocks"):
            assert result["crypto_witnesses"], name


def test_crypto_digests_in_memory():
    """The digests the syscalls leave in memory: hashlib's SHA-256, the
    Keccak-256 of the empty-free "hello", and the sponge the port's
    interpreter and prover use for Poseidon2."""
    from zkir_tpu_torch.ops.poseidon2_ref import poseidon2_sponge_hash_bytes
    from zkir_tpu_torch.runtime.crypto import keccak256_digest

    outs = {num: run(crypto_program(num, b"hello"), []).outputs
            for num in (3, 4, 5)}
    sha = hashlib.sha256(b"hello").digest()
    assert outs[3][0] == int.from_bytes(sha[:4], "big")
    assert outs[4][0] == poseidon2_sponge_hash_bytes(b"hello")[0]
    assert outs[5][0] == int.from_bytes(keccak256_digest(b"hello")[:4],
                                        "little")


# ============================================================================
# The deferred model's vectors (tests/test_deferred.py) on the port
# ============================================================================

CFG = DeferredConfig()


def test_deferred_config_defaults():
    assert (CFG.normalized_bits, CFG.limb_bits, CFG.headroom_bits,
            CFG.max_deferred_ops) == (20, 30, 10, 1024)


def test_deferred_add_sub_addi():
    state = VMState(0)
    state.write_reg_from_limbs(1, [100, 0], 20)
    state.write_reg_from_limbs(2, [200, 0], 20)
    execute_add_deferred(state, 3, 1, 2, CFG, None)
    assert state.get_reg_state(3) == RegState.ACCUMULATED
    assert state.read_reg_limbs_extended(3, 20, 30) == [300, 0]
    result = normalize_register(state, 3, 20, 30)
    assert (result.normalized, result.carries) == ((300, 0), (0, 0))

    state = VMState(0)
    state.write_reg_from_limbs(1, [(1 << 20) - 10, 0], 20)
    state.write_reg_from_limbs(2, [20, 0], 20)
    execute_add_deferred(state, 3, 1, 2, CFG, None)
    assert state.read_reg_limbs_extended(3, 20, 30)[0] == (1 << 20) + 10
    result = normalize_register(state, 3, 20, 30)
    assert result.normalized == (10, 1) and result.carries[0] == 1

    state = VMState(0)
    state.write_reg_from_limbs(1, [500, 0], 20)
    state.write_reg_from_limbs(2, [200, 0], 20)
    execute_sub_deferred(state, 3, 1, 2, CFG, None)
    normalize_register(state, 3, 20, 30)
    assert state.read_reg(3) == 300

    state = VMState(0)
    state.write_reg_from_limbs(1, [1000, 0], 20)
    execute_addi_deferred(state, 2, 1, 234, CFG, None)
    normalize_register(state, 2, 20, 30)
    assert state.read_reg(2) == 1234
    execute_add_deferred(state, 0, 1, 1, CFG, None)
    assert state.read_reg(0) == 0


def test_deferred_accumulation_and_overflow():
    state = VMState(0)
    state.write_reg_from_limbs(1, [(1 << 20) - 1, 0], 20)
    state.write_reg_from_limbs(2, [0, 0], 20)
    for _ in range(100):
        execute_add_deferred(state, 2, 2, 1, CFG, None)
    normalize_register(state, 2, 20, 30)
    assert state.read_reg(2) == 100 * ((1 << 20) - 1)

    state = VMState(0)
    state.write_reg_from_accumulated(1, [(1 << 30) - 5, 0], 30)
    state.write_reg_from_accumulated(2, [100, 0], 30)
    execute_add_deferred(state, 3, 1, 2, CFG, None)
    normalize_register(state, 3, 20, 30)
    assert state.read_reg(3) == ((1 << 30) - 5 + 100) & ((1 << 40) - 1)


@pytest.mark.parametrize("limbs,normalized,carries", [
    ([1048676, 5], (100, 6), (1, 0)),
    # normalize.rs:331-360: the carry out of limb 1 is dropped.
    ([1081328, 1048575], (1081328 & 0xFFFFF, (1048575 + 1) & 0xFFFFF),
     (1, 1))])
def test_normalize_vectors(limbs, normalized, carries):
    state = VMState(0)
    state.write_reg_from_accumulated(1, limbs, 30)
    result = normalize_register(state, 1, 20, 30)
    assert result.accumulated == tuple(limbs)
    assert (result.normalized, result.carries) == (normalized, carries)
    assert state.get_reg_state(1) == RegState.NORMALIZED
    assert state.read_reg(1) == normalized[0] | (normalized[1] << 20)


def test_normalize_edges():
    state = VMState(0)
    state.write_reg_from_limbs(1, [5, 5], 20)
    assert normalize_register(state, 1, 20, 30) is None
    assert would_overflow([1 << 30, 0], 30)
    assert not would_overflow([(1 << 30) - 1, 0], 30)
    state.write_reg_from_accumulated(1, [100, 0], 30)
    assert state.get_normalized_regs(20, 30)[1] == 100
    state.write_reg_from_accumulated(2, [1048660, 1048575], 30)
    assert state.get_normalized_regs(20, 30)[2] == \
        (1048660 | (1048575 << 30)) & ((1 << 40) - 1)


def test_deferred_add_then_branch_and_witness_stamps():
    config = VMConfig(enable_deferred_model=True)
    result = run(prog(
        I(Op.ADDI, rd=1, rs1=0, imm=100), I(Op.ADDI, rd=2, rs1=0, imm=100),
        I(Op.ADD, rd=3, rs1=1, rs2=2), I(Op.ADDI, rd=4, rs1=0, imm=200),
        I(Op.BEQ, rs1=3, rs2=4, imm=8), I(Op.EBREAK),
        I(Op.ADDI, rd=5, rs1=0, imm=1), I(Op.EBREAK)), [], config)
    assert result.cycles == 7
    result = run(prog(
        I(Op.ADDI, rd=1, rs1=0, imm=5), I(Op.ADDI, rd=2, rs1=0, imm=5),
        I(Op.ADD, rd=3, rs1=1, rs2=2), I(Op.BEQ, rs1=3, rs2=3, imm=4),
        I(Op.EBREAK)), [], config)
    beq = [e for e in result.normalization_witnesses
           if e.witness.pc == 0x100C]
    assert beq and beq[0].witness.cycle == 3
    assert all(e.witness.verify() for e in result.normalization_witnesses)


def test_deferred_matches_plain_execution():
    instrs = [I(Op.ADDI, rd=1, rs1=0, imm=7)]
    for i in range(50):
        instrs += [I(Op.ADD, rd=2, rs1=2, rs2=1),
                   I(Op.ADDI, rd=1, rs1=1, imm=3)]
        if i % 7 == 0:
            instrs.append(I(Op.SUB, rd=3, rs1=2, rs2=1))
    instrs += [I(Op.ADDI, rd=11, rs1=2, imm=0),
               I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),
               I(Op.ADDI, rd=11, rs1=3, imm=0), I(Op.ECALL), I(Op.EBREAK)]
    program = prog(*instrs)
    plain = run(program, [])
    deferred = run(program, [], VMConfig(enable_deferred_model=True))
    assert (plain.outputs, plain.cycles) == (deferred.outputs,
                                             deferred.cycles)
    port, ref = run_both(program, [], **FULL)
    assert port == ref


# ============================================================================
# Validator, value classes, analyzer
# ============================================================================

SPEC_PROGRAMS = [
    [I(Op.ADDI, rd=0, rs1=0, imm=5), I(Op.ADD, rd=1, rs1=2, rs2=3),
     I(Op.SLLI, rd=1, rs1=1, imm=70), I(Op.LW, rd=0, rs1=1, imm=0),
     I(Op.ECALL), I(Op.EBREAK)],
    [I(Op.ADDI, rd=1, rs1=0, imm=100), I(Op.ADDI, rd=2, rs1=0, imm=7),
     I(Op.DIV, rd=3, rs1=1, rs2=2), I(Op.MUL, rd=4, rs1=3, rs2=3),
     I(Op.LW, rd=5, rs1=0, imm=0x2000), I(Op.SW, rs1=5, rs2=4, imm=8),
     I(Op.BEQ, rs1=4, rs2=5, imm=-8), I(Op.EBREAK)],
    [I(Op.ADD, rd=1, rs1=1, rs2=1)] * 45 + [I(Op.EBREAK)],
]


def _ref_instrs(instrs):
    from zkir_tpu.spec import Instruction as RefInstruction

    return [RefInstruction.decode(i.encode()) for i in instrs]


@pytest.mark.parametrize("k", range(len(SPEC_PROGRAMS)))
def test_validation_and_analyzer_match_reference(k):
    instrs = SPEC_PROGRAMS[k]
    ref = _ref_instrs(instrs)
    assert canon(validate_program(instrs)) == canon(
        ref_validation.validate_program(ref))
    assert [canon(validate_instruction(i)) for i in instrs] == [
        canon(ref_validation.validate_instruction(i)) for i in ref]
    assert canon(analyzer.analyze_program(instrs)) == canon(
        ref_analyzer.analyze_program(ref))
    assert canon(analyzer.analyze_program(instrs, data_bits=30)) == canon(
        ref_analyzer.analyze_program(ref, data_bits=30))
    assert ValidationError.__name__ == ref_validation.ValidationError.__name__


def test_value_classes_match_reference():
    pairs = [(0, 0), (1, (1 << 40) - 1), ((1 << 39) + 5, (1 << 20) + 3),
             ((1 << 64) - 1, 12345), (0xABCDEF0123, 0x3210FEDCBA)]
    for name in ("Value30", "Value40", "Value60", "Value64"):
        cls, ref_cls = getattr(values, name), getattr(ref_values, name)
        for a, b in pairs:
            x, y = cls.from_u64(a), cls.from_u64(b)
            rx, ry = ref_cls.from_u64(a), ref_cls.from_u64(b)
            got = [x.wrapping_add(y).to_int(), x.wrapping_sub(y).to_int(),
                   x.wrapping_mul(y).to_int(), x.bitwise_xor(y).to_int(),
                   x.left_shift(7).to_int(), x.right_shift(9).to_int(),
                   x.arithmetic_right_shift(3, 40).to_int(),
                   x.signed_lt(y, 40), x.unsigned_lt(y),
                   x.sign_extend(8, 40).to_int(), x.truncate(20).to_int()]
            want = [rx.wrapping_add(ry).to_int(),
                    rx.wrapping_sub(ry).to_int(),
                    rx.wrapping_mul(ry).to_int(),
                    rx.bitwise_xor(ry).to_int(), rx.left_shift(7).to_int(),
                    rx.right_shift(9).to_int(),
                    rx.arithmetic_right_shift(3, 40).to_int(),
                    rx.signed_lt(ry, 40), rx.unsigned_lt(ry),
                    rx.sign_extend(8, 40).to_int(), rx.truncate(20).to_int()]
            assert got == want, (name, a, b)
    assert values.GenericValue(20, 2) is values.Value40


# ============================================================================
# The fuzz corpus and the CLI
# ============================================================================


def oracle_digest(program, inputs):
    """sha256 over (cycles, halt, exit code, outputs, final regs): the
    digest ``tests/test_fuzz_differential.py`` pins for the oracle."""
    vm = VM(program, list(inputs), VMConfig(max_cycles=200_000))
    res = vm.run()
    h = hashlib.sha256()
    h.update(str(res.cycles).encode())
    h.update(res.halt_reason.reason.value.encode())
    h.update(str(res.halt_reason.code).encode())
    h.update(",".join(map(str, res.outputs)).encode())
    h.update(",".join(map(str, vm.state.regs)).encode())
    return h.hexdigest()


@pytest.fixture(scope="module")
def corpus():
    return json.loads((ROOT / "tests" / "fuzz_corpus.json").read_text())


@pytest.mark.parametrize("seed", range(64))
def test_fuzz_corpus_oracle_digest(corpus, seed):
    program, inputs = generate_program(seed)
    assert oracle_digest(program, inputs) == corpus[str(seed)]
    assert run(program, inputs).halt_reason.reason == HaltReason.EXIT


@pytest.mark.parametrize("args", [
    ["examples/fibonacci.zkasm", "--input", "10"],
    ["examples/fibonacci.zkasm", "--input", "25"],
    ["examples/add.zkasm", "--input", "2", "--input", "3"],
    ["examples/fibonacci.zkasm", "--input", "10", "--max-cycles", "5"],
    ["examples/add.zkasm", "--max-cycles", "1"]])
def test_run_engine_oracle_as_the_reference(capsys, args, monkeypatch):
    monkeypatch.chdir(ROOT)
    args = ["run", *args, "--engine", "oracle"]
    want_code = ref_main(["--platform", "cpu", *args])
    want = capsys.readouterr().out
    assert want.startswith("halt=")
    assert main(args) == want_code == 0
    assert capsys.readouterr().out == want
    assert main(["--device", "cpu", *args]) == 0
    assert capsys.readouterr().out == want


def test_run_engine_oracle_refuses_the_gpu():
    with pytest.raises(SystemExit, match="runs on the host"):
        main(["--device", "cuda", "run", "examples/add.zkasm", "--engine",
              "oracle"])
