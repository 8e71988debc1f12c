"""The port's host loop (``TpuInterpreter.resume`` over ``interp_run``)
against the JAX package's interpreter on the CPU, tolerance 0.

On the CPU ``interp_run`` takes ``interp_run_plain``: the plain chunk over
the lanes at the lowest chunk index, the others held still.  The loop's
segments, pauses and cycle limit are the ones the kernel runs on a card,
so these cases hold them to the reference's host loop: lanes that pause on
Poseidon2 syscalls at different chunks, a ``max_cycles`` that is not a
multiple of the chunk, and a run over several doubling segments.  The
kernel's decoded program is held to the word fields it replaces, and its
fast instruction classes, translated into Python, to the plain step.  The
reference's runs are stored in ``tests/fixtures/torch_port/
interp_run_reference.npz`` (``make_fixtures.py interp_run`` records them).
"""

import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu.interp import InterpConfig as RefConfig
from zkir_tpu.interp import TpuInterpreter as RefInterpreter
from zkir_tpu.spec import Program as RefProgram
from zkir_tpu_torch.interp import (HALT_CYCLE_LIMIT, HALT_EXIT, HALT_NONE,
                                   PAUSE_CRYPTO, InterpConfig, TpuInterpreter,
                                   decode_table, interp_chunk_plain)
from zkir_tpu_torch.interp import columnar as C
from zkir_tpu_torch.spec import Instruction as I, Op, Program

from reference_runs import RunStore

CFG = dict(lanes=2, chunk=64, low_bytes=1 << 15, stack_bytes=1 << 12,
           collect_trace=True)
# Lane 0: a busy loop of one trip and one round; lane 1: 63 trips (two
# chunks later) and three rounds, each round a Poseidon2 pause.
TAPES = [[0x40, 11, 12], [0x3E, 21, 22, 23]]
# One instruction of each opcode family, never reached (the reference then
# compiles one step for every parity program of this size).
FILLER = [I(Op.MUL, rd=1, rs1=1, rs2=1), I(Op.MULH, rd=1, rs1=1, rs2=1),
          I(Op.DIVU, rd=1, rs1=1, rs2=1), I(Op.SLL, rd=1, rs1=1, rs2=1),
          I(Op.LB, rd=1, rs1=1, imm=0), I(Op.ECALL)]


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def staggered_program():
    """A busy loop of a tape-dependent length, then a tape-dependent number
    of rounds of READ, a store, a Poseidon2 syscall over it, a load of the
    digest and a WRITE; then EXIT."""
    ins = [
        I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),        # READ -> r10
        I(Op.ANDI, rd=7, rs1=10, imm=0x3F),
        I(Op.ADDI, rd=7, rs1=7, imm=1),
        I(Op.ANDI, rd=9, rs1=10, imm=0x3),
        I(Op.ADDI, rd=9, rs1=9, imm=1),
        I(Op.ADDI, rd=7, rs1=7, imm=-1),                     # busy loop
        I(Op.BNE, rs1=7, rs2=0, imm=-4),
        I(Op.ADDI, rd=15, rs1=0, imm=0x6000),
    ]
    loop = [
        I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),        # READ -> r10
        I(Op.SD, rs1=15, rs2=10, imm=0),
        I(Op.ADDI, rd=11, rs1=15, imm=0),
        I(Op.ADDI, rd=12, rs1=0, imm=8),
        I(Op.ADDI, rd=13, rs1=0, imm=0x6100),
        I(Op.ADDI, rd=10, rs1=0, imm=4), I(Op.ECALL),        # POSEIDON2
        I(Op.LD, rd=11, rs1=13, imm=0),
        I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),        # WRITE r11
        I(Op.ADDI, rd=15, rs1=15, imm=8),
        I(Op.ADDI, rd=9, rs1=9, imm=-1),
    ]
    loop.append(I(Op.BNE, rs1=9, rs2=0, imm=-4 * len(loop)))
    tail = [I(Op.ADDI, rd=11, rs1=15, imm=0),
            I(Op.ADDI, rd=10, rs1=0, imm=0), I(Op.ECALL)]    # EXIT
    return Program.from_instructions(ins + loop + tail + FILLER)


def chunk_loop(interp, tapes, max_cycles):
    """The reference's host loop over the plain chunk, invalid rows 0: the
    result the run must give word for word."""
    cfg = interp.config
    state, traces = interp.init_state(tapes), []
    for _ in range(max(1, -(-max_cycles // cfg.chunk))):
        state, trace = interp_chunk_plain(interp.code, interp.n_words,
                                          state, cfg)
        valid = trace["valid"]
        traces.append({k: torch.where(
            valid.reshape(*valid.shape, *[1] * (v.dim() - 2)), v,
            torch.zeros_like(v)) for k, v in trace.items()})
        if bool((state.halted == PAUSE_CRYPTO).any()):
            state = interp._service_crypto(state)
        if not bool((state.halted == HALT_NONE).any()):
            break
    else:
        state = state._replace(halted=torch.where(
            state.halted == HALT_NONE,
            torch.full_like(state.halted, HALT_CYCLE_LIMIT), state.halted))
    return interp._collect(state, traces, len(traces) * cfg.chunk)


def assert_equal(got, want, valid_rows_only=False):
    """Result dicts equal: every key; every trace column in shape and
    dtype, and in value (on valid rows only where the reference's invalid
    rows hold what its scan computed for halted lanes)."""
    assert set(got) == set(want)
    assert got["outputs"] == want["outputs"]
    for key in ("halted", "exit_code", "cycles", "regs", "bound_bits"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], key)
    valid = want["trace"]["valid"]
    for key, w in want["trace"].items():
        g = got["trace"][key]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), key
        if valid_rows_only and key != "valid":
            g, w = g[valid], w[valid]
        np.testing.assert_array_equal(g, w, key)


REFERENCE_RUNS = RunStore(
    pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port" /
    "interp_run_reference.npz", "ZKIR_RECORD_INTERP_RUN_REFERENCE")


@pytest.fixture(scope="module", autouse=True)
def _record_reference():
    """While recording, write the reference runs at the end."""
    yield
    REFERENCE_RUNS.write()


def reference(program, tapes, max_cycles):
    return REFERENCE_RUNS.result(
        program, tapes, max_cycles, CFG,
        lambda: RefInterpreter(RefProgram.from_bytes(program.to_bytes()),
                               RefConfig(**CFG)).run(
                                   tapes, max_cycles=max_cycles))


@pytest.mark.parametrize("max_cycles", [100_000, 100],
                         ids=["to_the_end", "limit_not_a_chunk_multiple"])
def test_staggered_pauses_equal_the_reference(max_cycles):
    program = staggered_program()
    interp = TpuInterpreter(program, InterpConfig(**CFG), device="cpu")
    got = interp.run(TAPES, max_cycles=max_cycles)
    assert_equal(got, chunk_loop(interp, TAPES, max_cycles))
    assert_equal(got, reference(program, TAPES, max_cycles),
                 valid_rows_only=True)
    cycles = got["cycles"].tolist()
    if max_cycles == 100:
        # Lane 1 is cut after two chunks; lane 0 exited in the first.
        assert got["halted"].tolist() == [HALT_EXIT, HALT_CYCLE_LIMIT]
        assert got["trace"]["valid"].shape == (128, 2)
    else:
        assert got["halted"].tolist() == [HALT_EXIT, HALT_EXIT]
        assert cycles[1] > cycles[0] + 2 * CFG["chunk"]
        assert [len(o) for o in got["outputs"]] == [1, 3]


def test_run_over_doubling_segments(monkeypatch):
    """A first segment of one chunk: the run takes segments of 1, 2 and 4
    chunks, each one launch (again after each round of paused lanes), and
    gives the one-segment run's dicts."""
    program = staggered_program()
    interp = TpuInterpreter(program, InterpConfig(**CFG), device="cpu")
    whole = interp.run(TAPES)
    segments = []
    real = C.interp_run

    def spy(code, n_words, state, lane_chunk, seg_lo, seg_hi, *a, **kw):
        segments.append((seg_lo, seg_hi, lane_chunk.tolist()))
        return real(code, n_words, state, lane_chunk, seg_lo, seg_hi, *a,
                    **kw)

    monkeypatch.setattr(C, "FIRST_SEGMENT_BYTES",
                        C.TRACE_ROW_BYTES * CFG["chunk"] * CFG["lanes"])
    monkeypatch.setattr(C, "interp_run", spy)
    assert_equal(interp.run(TAPES), whole)
    # Lane 0 pauses in chunk 0 and exits in chunk 1; lane 1 pauses in
    # chunks 2, 3 and 4: each pause relaunches the segment [3, 7), lane 1
    # at its own next chunk and lane 0 (halted) left where it stopped.
    assert segments == [(0, 1, [0, 0]), (1, 3, [1, 1]), (3, 7, [2, 3]),
                        (3, 7, [2, 4]), (3, 7, [2, 5])]


M40 = (1 << 40) - 1
M64 = (1 << 64) - 1


def fast_path(entry, regs, bounds, pc):
    """The fast classes of ``csrc/interp.cu`` (its ``switch (cls)``), case
    by case, on Python integers: (result, new bound, writes, next pc,
    rc_value) of one lane from its decoded word (four uint32), registers
    and bounds."""
    x, y, z, w = entry
    cls, use_imm, kind, neg = x & 0xF, (x >> 4) & 1, (x >> 5) & 3, (x >> 7) & 1
    rd, rs1, rs2 = (x >> 8) & 0xF, (x >> 12) & 0xF, (x >> 16) & 0xF
    imm_bits = (x >> 20) & 0x7F
    imm = (y - (1 << 32) if y >> 31 else y) & M64
    a_raw, b_raw = regs[rs1], regs[rs2]
    a_b, b_b, rd_b = bounds[rs1], bounds[rs2], bounds[rd]
    a40, b40 = a_raw & M40, b_raw & M40
    c40 = imm & M40 if use_imm else b40
    c_b = imm_bits if use_imm else b_b
    add40 = (a40 + b40) & M40
    prod = (a40 * b40) & M40
    link = (pc + 4) & M64
    shamt = z if use_imm else b_raw & 0x3F
    srl = 0 if shamt >= 40 else a40 >> shamt
    fill = M40 ^ (M40 >> min(shamt, 40))
    cond = neg != (a40 < b40 if kind == 0 else
                   (a40 ^ 1 << 39) < (b40 ^ 1 << 39) if kind == 1 else
                   a_raw == b_raw)
    results = [(a40 + c40) & M40, (a40 - b40) & M40, prod, a40 & c40,
               a40 | c40, a40 ^ c40,
               0 if shamt >= 40 else (a40 << shamt) & M40, srl,
               (srl | fill) if (a40 >> 39) & 1 else srl, int(cond), a_raw,
               link]
    new_bounds = [max(a_b, c_b) + 1, max(a_b, b_b), a_b + b_b, min(a_b, c_b),
                  max(a_b, c_b), max(a_b, c_b), min(a_b + shamt, 40),
                  max(a_b - shamt, 0),
                  40 if a_b >= 40 else max(a_b - shamt, 0), 1, max(a_b, rd_b),
                  link.bit_length()]
    writes = (b_raw != 0) != neg if cls == 10 else cls < 12
    alt = z - (1 << 32) if z >> 31 else z
    next_pc = ((pc + imm if cond else link) if cls == 12 else
               link if cls != 11 else
               (a_raw + imm) & (M64 - 1) if neg else pc + alt) & M64
    return (results[cls] if cls < 12 else None,
            new_bounds[cls] if cls < 12 else None, writes, next_pc,
            prod if cls == 2 else add40)


FAST_OPS = [Op.ADD, Op.SUB, Op.MUL, Op.ADDI, Op.AND, Op.OR, Op.XOR, Op.ANDI,
            Op.ORI, Op.XORI, Op.SLL, Op.SRL, Op.SRA, Op.SLLI, Op.SRLI,
            Op.SRAI, Op.SLTU, Op.SGEU, Op.SLT, Op.SGE, Op.SEQ, Op.SNE,
            Op.CMOV, Op.CMOVZ, Op.CMOVNZ, Op.BEQ, Op.BNE, Op.BLT, Op.BGE,
            Op.BLTU, Op.BGEU, Op.JAL, Op.JALR]


@pytest.mark.parametrize("op", FAST_OPS, ids=lambda op: op.name)
def test_fast_path_equals_the_plain_step(op):
    """64 random words of ``op``, one a lane, on random registers (values
    near the 40- and 64-bit edges, equal pairs) and bounds: the kernel's
    case for the decoded word's class gives the plain step's rd, bound,
    next pc and range-check value."""
    rng = np.random.default_rng(int(op))
    n = 64
    words = [(int(v) & ~0x7F) | int(op)
             for v in rng.integers(0, 1 << 32, size=n, dtype=np.uint64)]
    pool = [0, 1, 5, 39, 40, 63, (1 << 39) - 1, 1 << 39, M40, M40 + 1,
            (1 << 63) - 1, 1 << 63, M64]
    regs = [[0] + [pool[int(rng.integers(len(pool)))] if rng.random() < 0.5
                   else int(rng.integers(0, 1 << 64, dtype=np.uint64))
                   for _ in range(15)] for _ in range(n)]
    for lane in range(0, n, 4):                 # equal operand pairs
        regs[lane][1:] = [regs[lane][1]] * 15
    bounds = rng.integers(0, 65, size=(n, 16)).tolist()
    code = torch.tensor(np.array(words, dtype=np.uint32).view(np.int32))
    cfg = InterpConfig(lanes=n, low_bytes=1 << 13, stack_bytes=1 << 12,
                       enable_memory=False, collect_trace=True)
    pcs = [C.CODE_BASE + 4 * lane for lane in range(n)]
    state = C.MachineState(
        pc=torch.tensor(pcs), regs=torch.tensor(
            np.array(regs, dtype=np.uint64).view(np.int64)),
        bound_bits=torch.tensor(bounds, dtype=torch.int32),
        accum=torch.zeros((n, 16), dtype=torch.int32),
        halted=torch.zeros(n, dtype=torch.int32),
        exit=torch.zeros(n, dtype=torch.int64),
        cycles=torch.zeros(n, dtype=torch.int64),
        mem=torch.zeros((n, 1), dtype=torch.uint8),
        inputs=torch.zeros((n, 64), dtype=torch.int64),
        n_inputs=torch.zeros(n, dtype=torch.int32),
        input_pos=torch.zeros(n, dtype=torch.int32),
        outputs=torch.zeros((n, 64), dtype=torch.int64),
        out_pos=torch.zeros(n, dtype=torch.int32))
    new, row = C._step_plain(code.to(torch.int64) & 0xFFFFFFFF, n, state,
                             cfg)
    table = decode_table(code).numpy().view(np.uint32).tolist()
    new_regs = new.regs.numpy().view(np.uint64).tolist()
    new_bounds = new.bound_bits.tolist()
    rc = row["rc_value"].numpy().view(np.uint64).tolist()
    for lane in range(n):
        result, bound, writes, next_pc, rc_value = fast_path(
            table[lane], regs[lane], bounds[lane], pcs[lane])
        rd = (table[lane][0] >> 8) & 0xF
        want_reg, want_bound = regs[lane][:], bounds[lane][:]
        if writes and rd:
            want_reg[rd], want_bound[rd] = result, bound
        assert new_regs[lane] == want_reg, lane
        assert new_bounds[lane] == want_bound, lane
        assert int(new.pc[lane]) & M64 == next_pc, lane
        assert rc[lane] == rc_value, lane


def test_decode_table_holds_the_word_fields():
    rng = np.random.default_rng(7)
    ops = [0x00, 0x03, 0x07, 0x08, 0x13, 0x15, 0x1A, 0x1B, 0x1D, 0x25,
           0x28, 0x30, 0x33, 0x35, 0x36, 0x38, 0x3B, 0x40, 0x45, 0x48,
           0x49, 0x50, 0x51, 0x7F]
    words = [(int(w) & ~0x7F) | ops[i % len(ops)] for i, w in enumerate(
        rng.integers(0, 1 << 32, size=480, dtype=np.uint64))]
    table = decode_table(torch.tensor(
        np.array(words, dtype=np.uint32).view(np.int32))).numpy()
    classes = {0x00: 0, 0x08: 0 | 1 << 4, 0x13: 3 | 1 << 4, 0x15: 5 | 1 << 4,
               0x1A: 8, 0x1B: 6 | 1 << 4, 0x1D: 8 | 1 << 4,
               0x25: 9 | 2 << 5 | 1 << 7, 0x28: 10, 0x40: 12 | 2 << 5,
               0x45: 12 | 1 << 7, 0x48: 11, 0x49: 11 | 1 << 7}
    widths = {0x30: 1, 0x33: 2, 0x35: 8, 0x38: 1, 0x3B: 8}
    for w, row in zip(words, table.view(np.uint32).tolist()):
        op = w & 0x7F
        imm = (((w >> 15) & 0x1FFFF) ^ (1 << 16)) - (1 << 16)
        imm21 = (((w >> 11) & 0x1FFFFF) ^ (1 << 20)) - (1 << 20)
        f = [(w >> s) & 0xF for s in (7, 11, 15)]
        rd, rs1, rs2 = ((0, f[0], f[1]) if 0x38 <= op <= 0x45 and op not in
                        range(0x3C, 0x40) else f)
        bits = 64 if imm < 0 else imm.bit_length()
        alt = (imm21 if op == 0x48 else
               (w >> 15) & 0xFF if 0x1B <= op <= 0x1D else 0)
        assert row == [classes.get(op, 13) | widths.get(op, 0) << 27
                       | rd << 8 | rs1 << 12 | rs2 << 16 | bits << 20,
                       imm & 0xFFFFFFFF, alt & 0xFFFFFFFF, w]
