"""The deferred-carry model of the port's interpreter
(``InterpConfig(deferred=True)``) against the JAX package's and against
the port's oracle VM, on the CPU, tolerance 0.

On the CPU the port runs the plain torch version of kernel K3.  Result
and trace dicts must agree with the reference's in keys, shapes, dtypes,
``valid`` everywhere and every column where ``valid`` is true, the
deferred model's ``accum_mask`` and ``norm_*`` included.  Every parity
program ends in the unreachable filler of ``tests/test_torch_interp.py``
and stays below 128 words, so that the reference compiles its deferred
step for at most two code-size buckets.  The same programs run through
the port's oracle VM (``runtime.VM`` with the deferred model): cycles,
outputs, final registers and bounds, every trace row's pre-state and the
normalization witnesses.  Then ``accum`` carried across by ``convert``
and the checkpoint, the deferred trace's matrix (equal to the plain
one's), and golden C proved from a deferred trace.  The reference's runs
(``run_ref``) are stored in ``tests/fixtures/torch_port/
deferred_reference.npz`` (``make_fixtures.py deferred`` records them).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from zkir_tpu.interp import InterpConfig as RefConfig
from zkir_tpu.interp import MachineState as RefState
from zkir_tpu.interp import TpuInterpreter as RefInterpreter
from zkir_tpu.spec import Program as RefProgram
from zkir_tpu_torch.asm import assemble
from zkir_tpu_torch.convert import (fixture_from_reference, proof_from_json,
                                    proof_to_json,
                                    machine_state_from_reference,
                                    machine_state_to_reference)
from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
from zkir_tpu_torch.interp import columnar as C
from zkir_tpu_torch.interp.checkpoint import load_state, save_state
from zkir_tpu_torch.prover import prove_trace, trace_to_matrix, verify_trace
from zkir_tpu_torch.prover.benchtrace import exact_trace_program
from zkir_tpu_torch.runtime import VM, HaltReason, VMConfig
from zkir_tpu_torch.spec import Instruction, Op, Program
from zkir_tpu_torch.tools.fuzz_programs import generate_program

from reference_runs import RunStore

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
CFG = dict(lanes=2, chunk=64, low_bytes=1 << 15, stack_bytes=1 << 12,
           collect_trace=True, deferred=True)


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """Several pytest workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def I(op, **kw):  # noqa: E743
    return Instruction(op, **kw)


# One instruction of each opcode family, never reached (as in
# tests/test_torch_interp.py): the reference compiles one step a bucket.
FILLER = [I(Op.MUL, rd=1, rs1=1, rs2=1), I(Op.MULH, rd=1, rs1=1, rs2=1),
          I(Op.DIVU, rd=1, rs1=1, rs2=1), I(Op.SLL, rd=1, rs1=1, rs2=1),
          I(Op.LB, rd=1, rs1=1, imm=0), I(Op.ECALL)]


def program_of(instrs):
    return Program.from_instructions(list(instrs) + FILLER)


def corners():
    """The deferred model's corners (``chip_smoke.deferred_program``):
    tape values in a register ADDI marked accumulated, doubling registers
    that take the overflow path, SUB wrapping its limbs, a negative ADDI,
    observation points with rs1 == rs2 and with R0, accumulated words
    written out."""
    loop = [I(Op.ADD, rd=2, rs1=2, rs2=2), I(Op.ADD, rd=6, rs1=6, rs2=2),
            I(Op.SUB, rd=3, rs1=3, rs2=6), I(Op.ADDI, rd=4, rs1=4, imm=-3),
            I(Op.ADDI, rd=14, rs1=14, imm=-1)]
    loop.append(I(Op.BNE, rs1=14, rs2=0, imm=-4 * len(loop)))
    return program_of(
        [I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),
         I(Op.ADDI, rd=2, rs1=10, imm=0),
         I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),
         I(Op.ADD, rd=6, rs1=10, rs2=0), I(Op.ADDI, rd=14, rs1=0, imm=24)]
        + loop
        + [I(Op.XOR, rd=7, rs1=2, rs2=3), I(Op.SLT, rd=8, rs1=6, rs2=6),
           I(Op.AND, rd=9, rs1=4, rs2=4), I(Op.SRAI, rd=12, rs1=3, imm=5),
           I(Op.SLTU, rd=13, rs1=0, rs2=3), I(Op.ADD, rd=11, rs1=7, rs2=12),
           I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),
           I(Op.ADD, rd=11, rs1=2, rs2=4), I(Op.ECALL),
           I(Op.SB, rs1=0, rs2=11, imm=0x2000),
           I(Op.LW, rd=5, rs1=0, imm=0x2000),
           I(Op.DIVU, rd=8, rs1=5, rs2=4),
           I(Op.ANDI, rd=11, rs1=6, imm=0xFF),
           I(Op.ADDI, rd=10, rs1=0, imm=0), I(Op.ECALL)])


def random_program(seed, n=80):
    """tests/test_interp.py's straight-line random programs."""
    ops = [Op.ADD, Op.SUB, Op.MUL, Op.MULH, Op.AND, Op.OR, Op.XOR, Op.SLL,
           Op.SRL, Op.SRA, Op.SLT, Op.SLTU, Op.SGE, Op.SGEU, Op.SEQ, Op.SNE,
           Op.CMOV, Op.CMOVZ, Op.CMOVNZ, Op.ADDI, Op.ANDI, Op.ORI, Op.XORI,
           Op.SLLI, Op.SRLI, Op.SRAI]
    rng = np.random.default_rng(seed)
    instrs = [I(Op.ADDI, rd=r, rs1=0, imm=int(rng.integers(-(1 << 16),
                                                           1 << 16)))
              for r in range(1, 16)]
    for _ in range(n):
        op = ops[int(rng.integers(len(ops)))]
        rd, rs1, rs2 = (int(rng.integers(1, 16)), int(rng.integers(0, 16)),
                        int(rng.integers(0, 16)))
        if op in (Op.SLLI, Op.SRLI, Op.SRAI):
            instrs.append(I(op, rd=rd, rs1=rs1, imm=int(rng.integers(64))))
        elif op in (Op.ADDI, Op.ANDI, Op.ORI, Op.XORI):
            instrs.append(I(op, rd=rd, rs1=rs1, imm=int(
                rng.integers(-(1 << 16), 1 << 16))))
        else:
            instrs.append(I(op, rd=rd, rs1=rs1, rs2=rs2))
    return program_of(instrs + [I(Op.EBREAK)])


def fibonacci():
    fib = assemble((ROOT / "examples" / "fibonacci.zkasm").read_text())
    return program_of([Instruction.decode(w) for w in fib.code])


def fuzz(seed):
    program, inputs = generate_program(seed)
    return program_of([Instruction.decode(w) for w in program.code]), inputs


# name -> (program, the two lanes' tapes)
PROGRAMS = {
    "deferred_matches_oracle": (program_of([
        I(Op.ADDI, rd=1, rs1=0, imm=(1 << 16) - 1),
        I(Op.ADD, rd=2, rs1=2, rs2=1), I(Op.ADD, rd=2, rs1=2, rs2=1),
        I(Op.ADD, rd=2, rs1=2, rs2=1), I(Op.SUB, rd=3, rs1=2, rs2=1),
        I(Op.BEQ, rs1=2, rs2=2, imm=4), I(Op.ADDI, rd=4, rs1=2, imm=5),
        I(Op.AND, rd=5, rs1=2, rs2=3), I(Op.EBREAK)]), [[], []]),
    "witnesses": (program_of([
        I(Op.ADDI, rd=1, rs1=0, imm=100), I(Op.ADDI, rd=2, rs1=0, imm=100),
        I(Op.ADD, rd=3, rs1=1, rs2=2), I(Op.BEQ, rs1=3, rs2=3, imm=4),
        I(Op.EBREAK)]), [[], []]),
    "corners": (corners(), [[0x3FFFFFFFFF, 0xFFFFF], [123456789, 1 << 39]]),
    "fibonacci": (fibonacci(), [[15], [20]]),
    "random_11": (random_program(11), [[], []]),
    "random_12": (random_program(12), [[], []]),
    "fuzz_16": (fuzz(16)[0], [fuzz(16)[1], fuzz(16)[1][::-1]]),
    "fuzz_59": (fuzz(59)[0], [fuzz(59)[1], fuzz(59)[1][::-1]]),
}


def run_port(program, tapes, **cfg):
    return TpuInterpreter(program, InterpConfig(**{**CFG, **cfg}),
                          device="cpu").run(tapes)


# The reference's runs, stored in tests/fixtures/torch_port/
# deferred_reference.npz (make_fixtures.py deferred records them).
REFERENCE_RUNS = RunStore(FIXTURES / "deferred_reference.npz",
                          "ZKIR_RECORD_DEFERRED_REFERENCE")


@pytest.fixture(scope="module", autouse=True)
def _record_reference():
    """While recording, write the reference runs at the end."""
    yield
    REFERENCE_RUNS.write()


def run_ref(program, tapes, **cfg):
    cfg = {**CFG, **cfg}
    return REFERENCE_RUNS.result(
        program, tapes, None, cfg,
        lambda: RefInterpreter(RefProgram.from_bytes(program.to_bytes()),
                               RefConfig(**cfg)).run(tapes))


def assert_same_trace(port, ref):
    assert set(port) == set(ref)
    valid = ref["valid"]
    for key, want in ref.items():
        got = port[key]
        assert (got.dtype, got.shape) == (want.dtype, want.shape), key
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
    assert_same_trace(port["trace"], ref["trace"])


def assert_same_as_oracle(program, tape, result, lane):
    """One lane of the port's deferred run against the port's oracle VM."""
    vm = VM(program, list(tape), VMConfig(
        enable_deferred_model=True, enable_execution_trace=True,
        enable_range_checking=True))
    oracle = vm.run()
    assert int(result["cycles"][lane]) == oracle.cycles
    assert int(result["halted"][lane]) == {
        HaltReason.EBREAK: C.HALT_EBREAK,
        HaltReason.EXIT: C.HALT_EXIT}[oracle.halt_reason.reason]
    if oracle.halt_reason.reason == HaltReason.EXIT:
        assert int(result["exit_code"][lane]) == oracle.halt_reason.code
    assert [int(v) for v in result["outputs"][lane]] == oracle.outputs
    assert [int(v) for v in result["regs"][lane]] == vm.state.regs
    assert [int(v) for v in result["bound_bits"][lane]] == [
        b.max_bits for b in vm.state.bounds]
    t = result["trace"]
    rows = np.nonzero(t["valid"][:, lane])[0]
    assert len(rows) == len(oracle.execution_trace)
    for i, row in zip(rows, oracle.execution_trace):
        assert (int(t["cycle"][i, lane]), int(t["pc"][i, lane]),
                int(t["word"][i, lane])) == (row.cycle, row.pc,
                                             row.instruction)
        assert [int(v) for v in t["regs"][i, lane]] == row.registers
        assert [int(v) for v in t["bounds"][i, lane]] == [
            b.max_bits for b in row.bounds]
        assert int(t["accum_mask"][i, lane]) == sum(
            int(s) << r for r, s in enumerate(row.register_states))
    keys = ("cycle", "norm_reg", "norm_acc0", "norm_acc1", "norm_n0",
            "norm_n1", "norm_c0", "norm_c1")
    events = [tuple(int(t[k][i, lane]) for k in keys)
              for i in np.nonzero(t["norm_valid"][:, lane])[0]]
    assert events == [
        (e.witness.cycle, e.witness.register, *e.witness.accumulated_limbs,
         *e.witness.normalized_limbs, *e.witness.carries)
        for e in oracle.normalization_witnesses]
    return oracle


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_deferred_matches_reference_and_oracle(name):
    program, tapes = PROGRAMS[name]
    port = run_port(program, tapes)
    assert_same_result(port, run_ref(program, tapes))
    events = 0
    for lane, tape in enumerate(tapes):
        events += len(assert_same_as_oracle(program, tape, port,
                                            lane).normalization_witnesses)
    assert events > 0
    assert port["trace"]["accum_mask"].any()


def _slots():
    src = (ROOT / "zkir_tpu_torch" / "csrc" / "interp.cu").read_text()
    body = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    return [name.strip() for name in body.split(",") if name.strip()]


def test_descriptor_carries_the_deferred_model():
    """The kernel's slots of the deferred model: the flag, the limb
    widths, the observation points (the reference step's classes), the
    state's accum and the trace's accum_mask; and the rows' widths."""
    program, tapes = PROGRAMS["corners"]
    interp = TpuInterpreter(program, InterpConfig(**CFG), device="cpu")
    state = interp.init_state(tapes)
    trace = C._new_trace(64, 2, "cpu", deferred=True)
    at = dict(zip(_slots(), C._descriptor(
        interp.code, interp.n_words, state, interp.config, trace)))
    observes = sum(1 << op for op in (
        *range(0x02, 0x08), *range(0x10, 0x16), *range(0x18, 0x1E),
        *range(0x20, 0x26), 0x38, 0x39, 0x3A, *range(0x40, 0x46)))
    assert (at["D_DEFERRED"], at["D_NORM_BITS"], at["D_LIMB_BITS"]) == (
        1, 20, 30)
    assert (at["D_OBS_LO"] % (1 << 64)) | at["D_OBS_HI"] << 64 == observes
    assert at["D_ACCUM"] == state.accum.data_ptr()
    assert at["T_ACCUM_MASK"] == trace["accum_mask"].data_ptr()
    plain = dict(zip(_slots(), C._descriptor(
        interp.code, interp.n_words, state,
        InterpConfig(**{**CFG, "deferred": False}),
        C._new_trace(64, 2, "cpu"))))
    assert (plain["D_DEFERRED"], plain["T_ACCUM_MASK"]) == (0, 0)
    assert C.TRACE_ROW_BYTES == sum(
        dt.itemsize * int(np.prod(tail, dtype=np.int64))
        for dt, tail in C.trace_columns(False).values())
    assert C.DEFERRED_ROW_BYTES == sum(
        dt.itemsize * int(np.prod(tail, dtype=np.int64))
        for dt, tail in C.trace_columns(True).values()) == 248


def test_limb_widths_are_checked():
    program = program_of([I(Op.EBREAK)])
    with pytest.raises(ValueError, match="limb_bits <= 31"):
        TpuInterpreter(program, InterpConfig(deferred=True, limb_bits=32),
                       device="cpu")
    TpuInterpreter(program, InterpConfig(limb_bits=32), device="cpu")


# ============================================================================
# accum carried across
# ============================================================================


def _ref_fields(state):
    return {name: np.asarray(value)
            for name, value in zip(RefState._fields, state)}


def test_machine_state_with_accum_carried_both_ways():
    """One deferred chunk in the reference (accumulated registers left),
    its state carried across, one more chunk in both: equal states, accum
    included, and equal traces."""
    program, tapes = PROGRAMS["corners"]

    def run():
        import jax.numpy as jnp

        from zkir_tpu.interp.columnar import _merge_trace_host as ref_merge

        ref = RefInterpreter(RefProgram.from_bytes(program.to_bytes()),
                             RefConfig(**CFG))
        n_words = jnp.int32(ref.n_words)
        first, _ = ref._chunk_fn(ref.code, n_words, ref.init_state(tapes))
        second, trace = ref._chunk_fn(ref.code, n_words, first)
        return {**{f"first.{k}": v for k, v in _ref_fields(first).items()},
                **{f"second.{k}": v for k, v in _ref_fields(second).items()},
                "trace": ref_merge({k: np.asarray(v)
                                    for k, v in trace.items()})}

    out = REFERENCE_RUNS.result(program, tapes, "two chunks", CFG, run)
    first, second = ({k[len(p):]: v for k, v in out.items()
                      if k.startswith(p)} for p in ("first.", "second."))
    assert first["accum"].any()
    state = machine_state_from_reference(first, device="cpu")
    assert torch.equal(state.accum, torch.from_numpy(np.array(
        first["accum"])))
    port = TpuInterpreter(program, InterpConfig(**CFG), device="cpu")
    state, trace = port.chunk_fn(state)
    back = machine_state_to_reference(state)
    for name, want in second.items():
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, name)
    assert_same_trace(
        C._merge_trace_host({k: v.numpy() for k, v in trace.items()},
                            port.config),
        out["trace"])


def test_checkpoint_carries_accum(tmp_path):
    program, tapes = PROGRAMS["corners"]
    interp = TpuInterpreter(program, InterpConfig(**{**CFG, "chunk": 32}),
                            device="cpu")
    unbroken = interp.run(tapes)
    state, first = interp.chunk_fn(interp.init_state(tapes))
    assert bool(state.accum.any())
    path = str(tmp_path / "state.npz")
    save_state(path, interp, state)
    loaded_interp, loaded = load_state(path, device="cpu")
    assert loaded_interp.config == interp.config
    for name, a, b in zip(state._fields, state, loaded):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    resumed = loaded_interp.resume(loaded)
    for key in ("halted", "exit_code", "cycles", "regs", "bound_bits"):
        np.testing.assert_array_equal(resumed[key], unbroken[key], key)
    assert resumed["outputs"] == unbroken["outputs"]
    whole = C._merge_trace_host({k: v.numpy() for k, v in first.items()},
                                interp.config)
    for key, want in unbroken["trace"].items():
        np.testing.assert_array_equal(
            np.concatenate([whole[key], resumed["trace"][key]]), want, key)


# ============================================================================
# Matrices and a prove
# ============================================================================


def test_deferred_matrix_equals_reference_and_plain():
    """``exact_trace_program(9)`` (the filler appended): the deferred
    trace's matrix equals the reference's deferred one and the plain
    trace's, though its rows normalize registers."""
    program = program_of(list(map(Instruction.decode,
                                  exact_trace_program(9).code)))
    port = run_port(program, [[], []])
    ref = run_ref(program, [[], []])
    assert_same_result(port, ref)
    assert int(port["trace"]["norm_valid"][:, 0].sum()) == 255
    matrix = trace_to_matrix(port["trace"], program=program)
    plain = trace_to_matrix(run_port(program, [[]], lanes=1,
                                     deferred=False)["trace"],
                            program=program)
    assert matrix.shape == (512, 493)
    np.testing.assert_array_equal(matrix, plain)
    from zkir_tpu.prover import trace_to_matrix as ref_trace_to_matrix

    np.testing.assert_array_equal(
        matrix, ref_trace_to_matrix(ref["trace"], program=RefProgram
                                    .from_bytes(program.to_bytes())))


def test_deferred_trace_proves_golden_c():
    """Golden C is ``exact_trace_program(10)``'s matrix proved with
    ``range_lookup``: the deferred trace gives the same matrix, its proof
    is the stored one, and the port's verifier accepts it."""
    fx = fixture_from_reference(FIXTURES, "golden_c")
    trace = TpuInterpreter(exact_trace_program(10), InterpConfig(
        lanes=1, chunk=256, collect_trace=True, deferred=True),
        device="cpu").run([[]])["trace"]
    matrix = trace_to_matrix(trace)
    np.testing.assert_array_equal(matrix, fx["matrix"])
    proof = prove_trace(matrix, fx["config"], range_lookup=True,
                        device="cpu")
    assert proof_to_json(proof) == proof_to_json(
        proof_from_json(proof_to_json(fx["want"])))
    assert verify_trace(proof, None, device="cpu")
