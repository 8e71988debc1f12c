"""Batched interpreter for ZK-IR v3.4 on torch tensors.

Counterpart of ``zkir_tpu/interp/columnar.py``: the same machine, the same
result and trace dicts, another shape of program.  On a GPU kernel K3
(``csrc/interp.cu``) runs the lanes: ``interp_run`` takes every lane on
until it halts, pauses for a crypto syscall or reaches the end of a
segment of chunks, in one launch; ``interp_chunk`` is ``interp_run`` over
one chunk of every lane (``TpuInterpreter.chunk_fn``).  A thread runs a
lane where lanes are many, a warp where they are few (``warp_layout``).
What the reference builds for the TPU (u32 limb pairs, the one-hot
register file and fetch, one compiled step per opcode-family set) has no
counterpart here; ``program_features`` stays only to drop the memory image
of a program that cannot touch memory.

State on the device (``MachineState``): int64 tensors hold the 64-bit
words (two's complement bit patterns of the machine's unsigned values),
int32 the bounds, halt codes and tape positions, uint8 ``[L, low_bytes +
stack_bytes]`` the two memory windows (low: code, data, heap from 0; high:
the stack below ``STACK_TOP``).  Unsigned 64-bit views are made with numpy
at the result boundary only.

``interp_chunk_plain`` is the plain version: the step as torch operators
over the lane axis, in a Python loop over cycles; ``interp_run_plain``
drives it chunk by chunk as the kernel's segment runs.  CPU tensors take
them; a CUDA state launches the kernel or raises.  torch has no unsigned
64-bit arithmetic, so the plain version builds logical shifts, unsigned
compares, the unsigned divide and MULH's 128-bit product from int64 in the
``u64_*`` helpers below.

``chunk`` cycles stay the unit of the trace's layout and of the cycle
limit, as in the reference's host loop.  ``TpuInterpreter.resume`` (one
loop for both devices) allocates the trace in segments of chunks that
double, launches one segment at a time, services the crypto syscalls of
paused lanes between launches (each hash kind one batch over the lanes
that asked for it, on the state's device: ``ops/sha256.py``,
``ops/keccak.py``, ``ops/blake3.py``, ``ops/poseidon2.py``), and copies
the trace to the host once, at the end.

``InterpConfig(deferred=True)`` runs the deferred-carry model of the
reference (its specification: ``runtime/deferred.py``, ``normalize.py``
and ``execute.py::execute_with_deferred``): ADD, SUB and ADDI add limbs
without extracting carries and mark rd accumulated (``MachineState.accum``);
an observation point (``runtime/observation.py``) first normalizes rs1
and, for the two-source ones, an accumulated rs2.  Its trace adds
``accum_mask`` (the pre-state's accumulated registers, from the device)
and the rs1 normalization witness ``norm_*``, which the host derives from
the row's pre-state registers, ``accum_mask`` and word
(``_merge_trace_host``).
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
from typing import Any, Dict, FrozenSet, List, NamedTuple, Optional

import numpy as np
import torch

from ..runtime.observation import OBSERVATION_POINTS
from ..spec.memlayout import CODE_BASE, STACK_TOP
from ..spec.opcodes import Op
from ..spec.program import Program

# Halt codes (per lane).
HALT_NONE = 0
HALT_EBREAK = 1
HALT_EXIT = 2
HALT_CYCLE_LIMIT = 3
HALT_ERROR = 4        # invalid opcode / syscall / memory fault / div0
PAUSE_CRYPTO = 5      # lane waiting for host-serviced crypto syscall

_M40 = (1 << 40) - 1
_MIN64 = -(1 << 63)
_MAX64 = (1 << 63) - 1


@dataclasses.dataclass(frozen=True)
class InterpConfig:
    """Static interpreter configuration."""

    lanes: int = 1
    low_bytes: int = 1 << 20       # low window: [0, low_bytes)
    stack_bytes: int = 1 << 16     # high window: the last stack_bytes
                                   # up to and including STACK_TOP
    max_inputs: int = 64
    max_outputs: int = 64
    chunk: int = 256               # cycles per chunk of the trace
    enable_memory: bool = True     # auto-cleared when the program has no
                                   # loads/stores/crypto (static analysis)
    collect_trace: bool = False
    deferred: bool = False         # the deferred-carry model
    normalized_bits: int = 20
    limb_bits: int = 30


class MachineState(NamedTuple):
    """Per-lane machine state carried from chunk to chunk."""

    pc: torch.Tensor           # i64 [L]
    regs: torch.Tensor         # i64 [L, 16]
    bound_bits: torch.Tensor   # i32 [L, 16] (ValueBound.max_bits column)
    accum: torch.Tensor        # i32 [L, 16] (1 = accumulated, deferred model)
    halted: torch.Tensor       # i32 [L]
    exit: torch.Tensor         # i64 [L]
    cycles: torch.Tensor       # i64 [L]
    mem: torch.Tensor          # u8  [L, low_bytes + stack_bytes]
    inputs: torch.Tensor       # i64 [L, max_inputs]
    n_inputs: torch.Tensor     # i32 [L]
    input_pos: torch.Tensor    # i32 [L]
    outputs: torch.Tensor      # i64 [L, max_outputs]
    out_pos: torch.Tensor      # i32 [L]


_STATE_DTYPES = {
    "pc": torch.int64, "regs": torch.int64, "bound_bits": torch.int32,
    "accum": torch.int32, "halted": torch.int32, "exit": torch.int64,
    "cycles": torch.int64, "mem": torch.uint8, "inputs": torch.int64,
    "n_inputs": torch.int32, "input_pos": torch.int32,
    "outputs": torch.int64, "out_pos": torch.int32,
}

# Trace columns a chunk emits: name -> (dtype, trailing shape).  The flags
# are torch.bool (one byte each, 0 or 1).
_TRACE_COLUMNS = {
    "valid": (torch.bool, ()), "cycle": (torch.int64, ()),
    "pc": (torch.int64, ()), "word": (torch.int32, ()),
    "regs": (torch.int64, (16,)), "bounds": (torch.int32, (16,)),
    "mem_valid": (torch.bool, ()), "mem_addr": (torch.int64, ()),
    "mem_value": (torch.int64, ()), "mem_width": (torch.int32, ()),
    "mem_is_write": (torch.bool, ()), "rc_valid": (torch.bool, ()),
    "rc_value": (torch.int64, ()),
}
# The deferred model's column from the device: bit r of a row is 1 where
# register r held accumulated limbs before the row's instruction.
_DEFERRED_COLUMNS = {"accum_mask": (torch.int32, ())}


def trace_columns(deferred: bool) -> Dict[str, Any]:
    """The trace columns the device writes: name -> (dtype, trailing
    shape)."""
    return {**_TRACE_COLUMNS, **(_DEFERRED_COLUMNS if deferred else {})}


# The observation points, by opcode, and as the kernel's opcode mask (bit
# op); of them the immediate forms (ANDI ORI XORI SLLI SRLI SRAI) normalize
# rs1 only, the others rs1 and, where it holds accumulated limbs, rs2.
_OBSERVED = np.isin(np.arange(128), [int(op) for op in OBSERVATION_POINTS])
_OBSERVES = sum(1 << int(op) for op in OBSERVATION_POINTS)


# The state tensors the kernel writes.
_MUTABLE = ("pc", "regs", "bound_bits", "accum", "halted", "exit", "cycles",
            "mem", "input_pos", "outputs", "out_pos")
# Bytes of trace the first segment of a run may take; later segments
# double.  The kernel indexes the 16 registers of a segment's row x lane
# with 32-bit integers: rows x lanes stays below MAX_SEGMENT_CELLS.
FIRST_SEGMENT_BYTES = 1 << 26
MAX_SEGMENT_CELLS = 1 << 27
# Bytes of a lane's trace row on the device (``trace_columns``), and with
# the deferred model's ``accum_mask``.
TRACE_ROW_BYTES = 244
DEFERRED_ROW_BYTES = 248
# Up to this many lanes a warp runs each lane, beyond it a thread.  On an
# H100 (chip_smoke.py's sweeps of the loop program): without a trace the
# layouts tie up to 512 lanes and a thread per lane wins from 1,024; with a
# trace a warp per lane wins at every count measured, 1 to 1,024 lanes (a
# thread per lane stores the row's registers lane-strided).
WARP_LANES = 256
WARP_LANES_TRACED = 1024


def warp_layout(lanes: int, trace: bool) -> bool:
    """Whether K3 runs ``lanes`` lanes a warp each (else a thread each),
    with or without a trace."""
    return lanes <= (WARP_LANES_TRACED if trace else WARP_LANES)


# csrc/interp.cu's instruction classes (its C_* enum) and the opcodes of
# each: class, second operand the immediate (1 << 4), compare kind (<< 5:
# 0 unsigned <, 1 signed <, 2 ==) and its negation (1 << 7, also CMOVZ
# and JALR), the access width (<< 27).  Other opcodes take the slow path.
_CLASSES = {
    0: {0x00: 0, 0x08: 1 << 4},                               # ADD ADDI
    1: {0x01: 0}, 2: {0x02: 0},                               # SUB MUL
    3: {0x10: 0, 0x13: 1 << 4}, 4: {0x11: 0, 0x14: 1 << 4},   # AND OR
    5: {0x12: 0, 0x15: 1 << 4},                               # XOR
    6: {0x18: 0, 0x1B: 1 << 4}, 7: {0x19: 0, 0x1C: 1 << 4},   # SLL SRL
    8: {0x1A: 0, 0x1D: 1 << 4},                               # SRA
    9: {0x20: 0 << 5, 0x21: 0 << 5 | 1 << 7, 0x22: 1 << 5,    # SLTU SGEU SLT
        0x23: 1 << 5 | 1 << 7, 0x24: 2 << 5, 0x25: 2 << 5 | 1 << 7},
    10: {0x26: 0, 0x27: 1 << 7, 0x28: 0},                     # CMOV CMOVZ CMOVNZ
    11: {0x48: 0, 0x49: 1 << 7},                              # JAL JALR
    12: {0x40: 2 << 5, 0x41: 2 << 5 | 1 << 7, 0x42: 1 << 5,   # BEQ BNE BLT
         0x43: 1 << 5 | 1 << 7, 0x44: 0 << 5, 0x45: 1 << 7},  # BGE BLTU BGEU
}
_C_SLOW = 13
_WIDTHS = {0x30: 1, 0x31: 1, 0x38: 1, 0x32: 2, 0x33: 2, 0x39: 2, 0x34: 4,
           0x3A: 4, 0x35: 8, 0x3B: 8}


def _op_info() -> List[int]:
    info = [_C_SLOW | _WIDTHS.get(op, 0) << 27 for op in range(128)]
    for cls, ops in _CLASSES.items():
        for op, bits in ops.items():
            info[op] = cls | bits
    return info


def decode_table(code: torch.Tensor) -> torch.Tensor:
    """The kernel's decoded program: int32 ``[n, 4]`` on ``code``'s device,
    one row per word of the int32 word vector ``code``: the opcode's
    ``_CLASSES`` bits | rd << 8 | rs1 << 12 | rs2 << 16 | imm_bits << 20
    (S- and B-type words carry rs1 in the rd field and rs2 in rs1's, and
    write no rd; ``imm_bits`` is the bit length of the immediate as an
    unsigned 64-bit word); imm17 sign-extended; JAL's imm21 sign-extended,
    or the amount of an immediate shift; the word."""
    w = code.to(torch.int64) & 0xFFFFFFFF
    op = w & 0x7F
    f_rd, f_rs1, f_rs2 = (w >> 7) & 0xF, (w >> 11) & 0xF, (w >> 15) & 0xF
    imm = (((w >> 15) & 0x1FFFF) ^ (1 << 16)) - (1 << 16)
    imm21 = (((w >> 11) & 0x1FFFFF) ^ (1 << 20)) - (1 << 20)
    sb = ((op >= 0x38) & (op <= 0x3B)) | ((op >= 0x40) & (op <= 0x45))
    info = torch.tensor(_op_info(), dtype=torch.int64, device=code.device)
    fields = (info[op] | torch.where(sb, 0, f_rd) << 8
              | torch.where(sb, f_rd, f_rs1) << 12
              | torch.where(sb, f_rs1, f_rs2) << 16
              | u64_bit_length(imm).to(torch.int64) << 20)
    alt = torch.where(op == Op.JAL, imm21,
                      torch.where((op >= 0x1B) & (op <= 0x1D),
                                  (w >> 15) & 0xFF, 0))
    table = torch.stack([fields, imm, alt, w], dim=1)
    return ((table + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def program_features(code: np.ndarray) -> FrozenSet[str]:
    """Opcode families statically present in the program.  The port reads
    only ``"mem"`` (loads, stores or an ECALL: a program without them
    carries no memory image)."""
    ops = np.asarray(code, dtype=np.uint32) & 0x7F
    feats = set()
    if np.any(((ops >= 0x30) & (ops <= 0x3B)) | (ops == 0x50)):
        feats.add("mem")
    if np.any(ops == int(Op.MUL)):
        feats.add("mul")
    if np.any(ops == int(Op.MULH)):
        feats.add("mulh")
    if np.any((ops >= 0x04) & (ops <= 0x07)):
        feats.add("div")
    if np.any((ops >= 0x18) & (ops <= 0x1D)):
        feats.add("shift")
    if np.any(ops == 0x50):
        feats.add("ecall")
    return frozenset(feats)


# ============================================================================
# Unsigned 64-bit arithmetic on int64 tensors (bit patterns)
# ============================================================================


def u64_srl(x, s):
    """Logical right shift of the bit pattern ``x`` by ``s`` in [0, 63]
    (``s`` an int or a tensor): clear the sign with a shift by one, then
    shift the rest arithmetically."""
    s = torch.as_tensor(s, dtype=torch.int64, device=x.device)
    shifted = ((x >> 1) & _MAX64) >> (s - 1).clamp(min=0)
    return torch.where(s > 0, shifted, x)


def u64_ltu(a, b):
    """Unsigned ``a < b``: flipping the sign bit turns the unsigned order
    into the signed one."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def u64_divmod(a, b):
    """Unsigned quotient and remainder of bit patterns, ``b`` != 0.

    A divisor with the top bit set leaves a quotient of 0 or 1.  Else
    ``(a >>> 1) / b`` is a division of non-negative int64 values; twice its
    quotient is at most one short."""
    big = b < 0
    safe = torch.where(big, torch.ones_like(b), b)
    q = torch.div(u64_srl(a, 1), safe, rounding_mode="floor") << 1
    r = a - q * safe
    fix = ~u64_ltu(r, safe)
    q = q + fix.to(torch.int64)
    r = torch.where(fix, r - safe, r)
    ge = ~u64_ltu(a, b)
    q = torch.where(big, ge.to(torch.int64), q)
    r = torch.where(big, torch.where(ge, a - b, a), r)
    return q, r


def u64_mul_bits_40_80(a, b):
    """Bits [40, 80) of the 128-bit product of two unsigned bit patterns,
    by schoolbook on 20-bit limbs: a column of at most four products of
    < 2^40 plus its carry stays below 2^43."""
    m20 = (1 << 20) - 1
    al = [u64_srl(a, 20 * i) & m20 for i in range(4)]
    bl = [u64_srl(b, 20 * i) & m20 for i in range(4)]
    carry = torch.zeros_like(a)
    limbs = []
    for k in range(4):
        col = carry
        for i in range(k + 1):
            col = col + al[i] * bl[k - i]
        limbs.append(col & m20)
        carry = col >> 20
    return limbs[2] | (limbs[3] << 20)


def u64_bit_length(x):
    """Bit length of the unsigned bit pattern (64 where the top bit is
    set), as int32."""
    v = torch.where(x < 0, torch.zeros_like(x), x)
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        hi = v >> s
        up = hi != 0
        n = n + up.to(torch.int64) * s
        v = torch.where(up, hi, v)
    n = n + (v != 0).to(torch.int64)
    return torch.where(x < 0, torch.full_like(n, 64), n).to(torch.int32)


# ============================================================================
# Plain torch version of the chunk
# ============================================================================


def _select(conds, vals, default):
    """First matching condition wins (``jnp.select``)."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def _normalize_plain(v, accumulated, nb: int, lb: int):
    """Carry-extract the register words ``v`` (limbs of ``lb`` bits where
    ``accumulated``, else ``nb``) into two ``nb``-bit limbs, the top carry
    dropped (``runtime/normalize.py``): the packed words."""
    bits = torch.where(accumulated, lb, nb)
    mask = (1 << bits) - 1
    l0 = v & mask
    l1 = (u64_srl(v, bits) & mask) + (l0 >> nb)
    nmask = (1 << nb) - 1
    return (l0 & nmask) | ((l1 & nmask) << nb)


def _step_plain(code, n_words: int, s: MachineState, cfg: InterpConfig):
    """One cycle of every lane: (new state, trace row or None)."""
    dev = s.pc.device
    L = s.pc.shape[0]
    i64 = torch.int64

    def const(v):
        return torch.full((L,), v, dtype=i64, device=dev)

    def rd16(arr, idx):
        return arr.gather(1, idx[:, None])[:, 0]

    def wr16(arr, idx, mask, val):
        """Write ``val`` at column ``idx`` where ``mask``; register 0 is
        hardwired to zero and never written."""
        m = mask & (idx != 0)
        old = rd16(arr, idx)
        return arr.scatter(1, idx[:, None],
                           torch.where(m, val.to(arr.dtype), old)[:, None])

    active = s.halted == HALT_NONE
    zero = const(0)

    # ---- fetch and decode ----
    pc = s.pc
    code_end = CODE_BASE + 4 * n_words
    in_code = (pc >= CODE_BASE) & (pc < code_end) & ((pc & 3) == 0)
    word_idx = torch.where(in_code, (pc - CODE_BASE) >> 2, zero)
    word = code[word_idx.clamp(0, code.shape[0] - 1)]
    op = word & 0x7F
    f_rd = (word >> 7) & 0xF
    f_rs1 = (word >> 11) & 0xF
    f_rs2 = (word >> 15) & 0xF
    imm = (((word >> 15) & 0x1FFFF) ^ (1 << 16)) - (1 << 16)   # sext64(imm17)
    imm21 = (((word >> 11) & 0x1FFFFF) ^ (1 << 20)) - (1 << 20)
    shamt8 = (word >> 15) & 0xFF
    is_store = (op >= 0x38) & (op <= 0x3B)
    is_branch = (op >= 0x40) & (op <= 0x45)
    is_load = (op >= 0x30) & (op <= 0x35)
    is_arith = op <= 0x08
    is_logical = (op >= 0x10) & (op <= 0x15)
    is_shift = (op >= 0x18) & (op <= 0x1D)
    is_imm_shift = (op >= 0x1B) & (op <= 0x1D)
    is_compare = (op >= 0x20) & (op <= 0x25)
    is_cmov = (op >= 0x26) & (op <= 0x28)
    is_jump = (op >= 0x48) & (op <= 0x49)
    is_divrem = (op >= 0x04) & (op <= 0x07)
    # S- and B-type words carry rs1 in the rd field and rs2 in rs1's.
    sb = is_store | is_branch
    rs1_idx = torch.where(sb, f_rd, f_rs1)
    rs2_idx = torch.where(sb, f_rs1, f_rs2)
    rd_idx = torch.where(sb, zero, f_rd)
    valid_op = (is_arith | is_logical | is_shift | is_compare | is_cmov
                | is_load | is_store | is_branch | is_jump
                | ((op >= 0x50) & (op <= 0x51)))
    # bit length of the sign-extended immediate as a u64 (64 when negative)
    imm_bits = u64_bit_length(imm)

    regs, bound, accum = s.regs, s.bound_bits, s.accum
    if cfg.deferred:
        # An observation point first normalizes rs1 (with a witness, which
        # the host derives from the trace row) and, for the two-source
        # ones, rs2 where it is accumulated; R0 never.
        nb, lb = cfg.normalized_bits, cfg.limb_bits
        observes = torch.from_numpy(_OBSERVED).to(dev)[op]
        is_norm_one = ((op >= 0x13) & (op <= 0x15)) | is_imm_shift
        is_norm_two = observes & ~is_norm_one
        do1 = active & observes & (rs1_idx != 0)
        acc1 = rd16(accum, rs1_idx) == 1
        regs = wr16(regs, rs1_idx, do1,
                    _normalize_plain(rd16(regs, rs1_idx), acc1, nb, lb))
        accum = wr16(accum, rs1_idx, do1, zero)
        acc2 = rd16(accum, rs2_idx) == 1       # after rs1's: rs1 == rs2
        do2 = active & is_norm_two & (rs2_idx != 0) & acc2
        regs = wr16(regs, rs2_idx, do2,
                    _normalize_plain(rd16(regs, rs2_idx), acc2, nb, lb))
        accum = wr16(accum, rs2_idx, do2, zero)
    a_raw = rd16(regs, rs1_idx)
    b_raw = rd16(regs, rs2_idx)
    rd_old = rd16(regs, rd_idx)
    a_bound = rd16(bound, rs1_idx)
    b_bound = rd16(bound, rs2_idx)
    rd_bound_old = rd16(bound, rd_idx)
    a40, b40, imm40 = a_raw & _M40, b_raw & _M40, imm & _M40

    # ---- arithmetic ----
    add_r = (a40 + b40) & _M40
    sub_r = (a40 - b40) & _M40
    addi_r = (a40 + imm40) & _M40
    mul_r = (a40 * b40) & _M40          # int64 products wrap: low bits exact
    # MULH = bits [40, 80) of the product of the raw 64-bit words.
    mulh_r = u64_mul_bits_40_80(a_raw, b_raw)
    b_zero = b_raw == 0
    safe_b = torch.where(b_zero, const(1), b_raw)
    # One unsigned divide: the signed ops feed it absolute values (by a
    # wrapping negate) and fix the signs after (C-style truncation).
    is_signed_div = (op == Op.DIV) | (op == Op.REM)
    neg_a = a_raw < 0
    neg_b = safe_b < 0
    q_u, r_u = u64_divmod(
        torch.where(is_signed_div & neg_a, -a_raw, a_raw),
        torch.where(is_signed_div & neg_b, -safe_b, safe_b))
    div_r = torch.where(neg_a ^ neg_b, -q_u, q_u)
    rem_r = torch.where(neg_a, -r_u, r_u)
    div0_err = is_divrem & b_zero
    arith_r = _select(
        [op == Op.ADD, op == Op.SUB, op == Op.MUL, op == Op.MULH,
         op == Op.DIVU, op == Op.REMU, op == Op.DIV, op == Op.REM,
         op == Op.ADDI],
        [add_r, sub_r, mul_r, mulh_r, q_u, r_u, div_r, rem_r, addi_r], zero)

    # ---- logical ----
    log_b = torch.where(op >= 0x13, imm40, b40)
    logical_r = _select(
        [(op == Op.AND) | (op == Op.ANDI), (op == Op.OR) | (op == Op.ORI),
         (op == Op.XOR) | (op == Op.XORI)],
        [a40 & log_b, a40 | log_b, a40 ^ log_b], zero)

    # ---- shifts: an amount of 40 or more clears (or fills, SRA) ----
    shamt = torch.where(is_imm_shift, shamt8, b_raw & 0x3F)
    is_sll = (op == Op.SLL) | (op == Op.SLLI)
    is_srl = (op == Op.SRL) | (op == Op.SRLI)
    big = shamt >= 40
    shc = shamt.clamp(max=39)
    sll_r = torch.where(big, zero, (a40 << shc) & _M40)
    srl_r = torch.where(big, zero, a40 >> shc)
    fill = _M40 ^ (_M40 >> shamt.clamp(max=40))
    sra_r = torch.where(((a40 >> 39) & 1) == 1,
                        torch.where(big, const(_M40), srl_r | fill), srl_r)
    shift_r = _select([is_sll, is_srl], [sll_r, srl_r], sra_r)

    # ---- compares (also the branch conditions) ----
    # 40-bit signed order: flip bit 39 and compare (both sides < 2^40).
    slt_p = (a40 ^ (1 << 39)) < (b40 ^ (1 << 39))
    sltu_p = a40 < b40
    eq_raw = a_raw == b_raw             # SEQ/SNE/BEQ/BNE see all 64 bits
    false = torch.zeros(L, dtype=torch.bool, device=dev)
    cmp_bit = _select(
        [op == Op.SLTU, op == Op.SGEU, op == Op.SLT, op == Op.SGE,
         op == Op.SEQ, op == Op.SNE],
        [sltu_p, ~sltu_p, slt_p, ~slt_p, eq_raw, ~eq_raw], false)
    cmp_r = cmp_bit.to(i64)

    # ---- cmov: the raw word moves ----
    cmov_cond = torch.where(op == Op.CMOVZ, b_zero, ~b_zero)
    cmov_r = torch.where(cmov_cond, a_raw, rd_old)

    # ---- memory ----
    addr = a_raw + imm
    width = _select(
        [(op == Op.LB) | (op == Op.LBU) | (op == Op.SB),
         (op == Op.LH) | (op == Op.LHU) | (op == Op.SH),
         (op == Op.LW) | (op == Op.SW), (op == Op.LD) | (op == Op.SD)],
        [const(1), const(2), const(4), const(8)], zero)
    is_mem = is_load | is_store
    k8 = torch.arange(8, dtype=i64, device=dev)[None, :]
    in_width = k8 < width[:, None]
    if cfg.enable_memory:
        stack_lo = STACK_TOP - cfg.stack_bytes + 1
        aligned = (addr & (width - 1).clamp(min=0)) == 0
        # Both windows lie below 2^40, so a signed compare of an address
        # that is not negative is the unsigned one.
        in_low = (addr >= 0) & (addr < cfg.low_bytes)
        in_stack = (addr >= stack_lo) & (addr <= STACK_TOP)
        off = torch.where(in_low, addr,
                          torch.where(in_stack,
                                      addr - stack_lo + cfg.low_bytes, zero))
        mem_err = is_mem & active & (~(in_low | in_stack) | ~aligned)
        # A byte outside the width aliases byte 0 (same index, same value),
        # so only the bytes inside the width are read or written.
        byte_idx = off[:, None] + torch.where(in_width, k8,
                                              torch.zeros_like(k8))
        byte_idx = byte_idx.clamp(max=s.mem.shape[1] - 1)
        cur_bytes = s.mem.gather(1, byte_idx).to(i64)
        loaded = torch.where(in_width, cur_bytes << (8 * k8),
                             torch.zeros_like(cur_bytes)).sum(dim=1)
    else:
        # The program statically cannot touch memory.
        mem_err = is_mem & active
        loaded = zero
    # LB and LH extend the sign through all 64 bits.
    lb_v = torch.where((loaded & 0x80) != 0, loaded | ~0xFF, loaded)
    lh_v = torch.where((loaded & 0x8000) != 0, loaded | ~0xFFFF, loaded)
    load_r = _select([op == Op.LB, op == Op.LH], [lb_v, lh_v], loaded)
    load_bound = _select(
        [(op == Op.LB) | (op == Op.LBU), (op == Op.LH) | (op == Op.LHU),
         op == Op.LW], [const(8), const(16), const(32)], const(40))

    # ---- branches / jumps ----
    br_taken = _select(
        [op == Op.BEQ, op == Op.BNE, op == Op.BLT, op == Op.BGE,
         op == Op.BLTU, op == Op.BGEU],
        [eq_raw, ~eq_raw, slt_p, ~slt_p, sltu_p, ~sltu_p], false)
    link = pc + 4
    jalr_target = (a_raw + imm) & ~1

    # ---- syscalls: the number is r10 ----
    num = regs[:, 10]
    is_ecall = op == Op.ECALL
    sys_exit = is_ecall & (num == 0)
    sys_read = is_ecall & (num == 1)
    sys_write = is_ecall & (num == 2)
    sys_crypto = is_ecall & (num >= 3) & (num <= 6)
    sys_invalid = is_ecall & ((num < 0) | (num > 6))

    # ---- a fault beats a pause beats a commit ----
    err = active & (~in_code | ~valid_op | div0_err | mem_err | sys_invalid)
    pause = active & sys_crypto & ~err
    commit = active & ~pause & ~err

    # ---- memory store (gated on commit): the raw value's low bytes ----
    mem = s.mem
    if cfg.enable_memory:
        store_bytes = (u64_srl(b_raw[:, None], 8 * k8) & 0xFF)
        store_bytes = torch.where(in_width, store_bytes, store_bytes[:, :1])
        do_store = (commit & is_store)[:, None]
        new_bytes = torch.where(do_store, store_bytes, cur_bytes)
        mem = mem.scatter(1, byte_idx, new_bytes.to(torch.uint8))

    # ---- I/O tape effects (gated on commit) ----
    in_slot = s.input_pos.clamp(max=cfg.max_inputs - 1).to(i64)
    tape_val = rd16(s.inputs, in_slot)
    read_val = torch.where(s.input_pos < s.n_inputs, tape_val, zero)
    input_pos = s.input_pos + (commit & sys_read).to(torch.int32)
    out_slot = s.out_pos.clamp(max=cfg.max_outputs - 1).to(i64)
    outputs = s.outputs.scatter(
        1, out_slot[:, None],
        torch.where(commit & sys_write, regs[:, 11],
                    rd16(s.outputs, out_slot))[:, None])
    out_pos = s.out_pos + (commit & sys_write).to(torch.int32)

    # ---- rd writeback selection ----
    writes_rd = (is_arith | is_logical | is_shift | is_compare | is_cmov
                 | is_load | is_jump)
    result = _select(
        [is_arith, is_logical, is_shift, is_compare, is_cmov, is_load,
         is_jump],
        [arith_r, logical_r, shift_r, cmp_r, cmov_r, load_r, link], zero)
    # cmov writes (value and bound) only when its condition holds.
    cmov_effective = ~is_cmov | cmov_cond

    is_def = (op == Op.ADD) | (op == Op.SUB) | (op == Op.ADDI)
    if cfg.deferred:
        # ADD, SUB and ADDI add limbs without extracting carries: limbs of
        # lb bits for accumulated sources, an immediate's two nb-bit limbs;
        # SUB wraps each limb at 64 bits.  Where an ADD's limb would reach
        # 2^lb, both sources are normalized, written back, and the limbs
        # added again.  limb0 is OR'd in unmasked (state.rs:184-192).
        acc_a = rd16(accum, rs1_idx) == 1
        acc_b = rd16(accum, rs2_idx) == 1
        bits_a = torch.where(acc_a, lb, nb)
        bits_b = torch.where(acc_b, lb, nb)
        al0 = a_raw & ((1 << bits_a) - 1)
        al1 = u64_srl(a_raw, bits_a) & ((1 << bits_a) - 1)
        nmask = (1 << nb) - 1
        is_addi = op == Op.ADDI
        o0 = torch.where(is_addi, imm & nmask, b_raw & ((1 << bits_b) - 1))
        o1 = torch.where(is_addi, u64_srl(imm, nb) & nmask,
                         u64_srl(b_raw, bits_b) & ((1 << bits_b) - 1))
        is_sub = op == Op.SUB
        d0 = torch.where(is_sub, al0 - o0, al0 + o0)
        d1 = torch.where(is_sub, al1 - o1, al1 + o1)
        overflow = ~is_sub & (((d0 >> lb) != 0) | ((d1 >> lb) != 0))
        pa = _normalize_plain(a_raw, acc_a, nb, lb)
        pb = _normalize_plain(b_raw, acc_b, nb, lb)
        d0 = torch.where(overflow, (pa & nmask) + torch.where(
            is_addi, o0, pb & nmask), d0)
        d1 = torch.where(overflow, ((pa >> nb) & nmask) + torch.where(
            is_addi, o1, (pb >> nb) & nmask), d1)
        ovf_on = active & is_def & overflow
        regs = wr16(regs, rs1_idx, ovf_on, pa)
        accum = wr16(accum, rs1_idx, ovf_on, zero)
        regs = wr16(regs, rs2_idx, ovf_on & ~is_addi, pb)
        accum = wr16(accum, rs2_idx, ovf_on & ~is_addi, zero)
        result = torch.where(is_def, d0 | (d1 << lb), result)

    # ---- bound propagation ----
    a_b, b_b = a_bound.to(i64), b_bound.to(i64)
    ib = imm_bits.to(i64)
    max_ab = torch.maximum(a_b, b_b)
    new_bound = _select(
        [op == Op.ADD, op == Op.ADDI, op == Op.SUB,
         (op == Op.MUL) | (op == Op.MULH), is_divrem,
         op == Op.AND, op == Op.ANDI,
         (op == Op.OR) | (op == Op.XOR), (op == Op.ORI) | (op == Op.XORI),
         is_sll, is_srl, (op == Op.SRA) | (op == Op.SRAI),
         is_compare, is_cmov, is_load, is_jump],
        [max_ab + 1, torch.maximum(a_b, ib) + 1, max_ab,
         a_b + b_b, a_b,
         torch.minimum(a_b, b_b), torch.minimum(a_b, ib),
         max_ab, torch.maximum(a_b, ib),
         (a_b + shamt).clamp(max=40), (a_b - shamt).clamp(min=0),
         torch.where(a_b >= 40, const(40), (a_b - shamt).clamp(min=0)),
         const(1), torch.maximum(a_b, rd_bound_old.to(i64)), load_bound,
         u64_bit_length(link).to(i64)],
        const(40))

    # ---- assemble the new state ----
    wb = commit & writes_rd & cmov_effective & ~is_branch & ~is_store
    new_regs = wr16(regs, rd_idx, wb, result)
    new_bound_bits = wr16(bound, rd_idx, wb, new_bound)
    if cfg.deferred:
        # Only the deferred writes mark rd accumulated; the others leave
        # its mark as it was (the reference's write_reg keeps it).
        accum = wr16(accum, rd_idx, wb & is_def, const(1))
    # READ writes its value into r10; WRITE leaves the registers alone.
    new_regs = torch.cat(
        [new_regs[:, :10],
         torch.where(commit & sys_read, read_val, new_regs[:, 10])[:, None],
         new_regs[:, 11:]], dim=1)

    br_step = torch.where(br_taken, imm, const(4))
    next_pc = _select([is_branch, op == Op.JAL, op == Op.JALR],
                      [pc + br_step, pc + imm21, jalr_target], link)
    halted = s.halted
    i32 = torch.int32
    for cond, code_ in ((commit & sys_exit, HALT_EXIT),
                        (commit & (op == Op.EBREAK), HALT_EBREAK),
                        (pause, PAUSE_CRYPTO), (err, HALT_ERROR)):
        halted = torch.where(cond, torch.full_like(halted, code_), halted)
    new_state = MachineState(
        pc=torch.where(commit, next_pc, pc), regs=new_regs,
        bound_bits=new_bound_bits, accum=accum, halted=halted.to(i32),
        exit=torch.where(commit & sys_exit, new_regs[:, 11], s.exit),
        cycles=s.cycles + commit.to(i64), mem=mem, inputs=s.inputs,
        n_inputs=s.n_inputs, input_pos=input_pos, outputs=outputs,
        out_pos=out_pos)
    if not cfg.collect_trace:
        return new_state, None

    # A store's value is cut to its width; a load's is the bytes read.
    wmask = torch.where(width == 8, const(-1),
                        (const(1) << (8 * width.clamp(max=7))) - 1)
    row = {
        # A paused cycle is an executed ECALL row (the host services its
        # memory effects, then advances pc and cycles), so it is in the
        # trace: the prover's crypto block reads the syscall's registers
        # from it.
        "valid": commit | pause,
        "cycle": s.cycles,
        "pc": pc,
        "word": word.to(torch.int32),
        "regs": s.regs,
        "bounds": bound,
        "mem_valid": commit & is_mem & (width > 0),
        "mem_addr": addr,
        "mem_value": torch.where(is_store, b_raw & wmask, loaded),
        "mem_width": width.to(torch.int32),
        "mem_is_write": is_store,
        # The range-check witness of a deferred check: an ADD or MUL whose
        # new bound exceeds the data width.
        "rc_valid": commit & ((op == Op.ADD) | (op == Op.MUL))
        & (new_bound > 40),
        "rc_value": torch.where(op == Op.MUL, mul_r, add_r),
    }
    if cfg.deferred:
        bits = torch.arange(16, dtype=torch.int32, device=dev)
        row["accum_mask"] = (s.accum << bits).sum(dim=1, dtype=torch.int32)
    return new_state, row


def interp_chunk_plain(code, n_words: int, state: MachineState,
                       cfg: InterpConfig):
    """``cfg.chunk`` cycles of every lane in plain torch: (state, trace),
    the trace a dict of ``[chunk, L, ...]`` tensors (``trace_columns``) or
    ``None`` without ``collect_trace``.  ``code`` is the int32 word vector
    the kernel takes.  Values of rows whose ``valid`` is false are
    unspecified."""
    code = code.to(torch.int64) & 0xFFFFFFFF
    rows = []
    for _ in range(cfg.chunk):
        if not bool((state.halted == HALT_NONE).any()):
            break       # nothing changes any more; the rows left are invalid
        state, row = _step_plain(code, n_words, state, cfg)
        rows.append(row)
    if not cfg.collect_trace:
        return state, None
    trace = {}
    for name, (dtype, tail) in trace_columns(cfg.deferred).items():
        col = torch.zeros((cfg.chunk, cfg.lanes, *tail), dtype=dtype,
                          device=state.pc.device)
        if rows:
            col[:len(rows)] = torch.stack([r[name] for r in rows])
        trace[name] = col
    return state, trace


# ============================================================================
# The kernel's wrapper
# ============================================================================


def _check_state(code, state: MachineState, cfg: InterpConfig) -> None:
    dev = state.pc.device
    L = cfg.lanes
    mem_bytes = (cfg.low_bytes + cfg.stack_bytes) if cfg.enable_memory else 1
    _check_limbs(cfg)
    shapes = {
        "pc": (L,), "regs": (L, 16), "bound_bits": (L, 16),
        "accum": (L, 16), "halted": (L,),
        "exit": (L,), "cycles": (L,), "mem": (L, mem_bytes),
        "inputs": (L, cfg.max_inputs), "n_inputs": (L,), "input_pos": (L,),
        "outputs": (L, cfg.max_outputs), "out_pos": (L,)}
    for name, t in zip(MachineState._fields, state):
        if t.device != dev:
            raise ValueError(f"state.{name} is on {t.device}, pc on {dev}")
        if t.dtype != _STATE_DTYPES[name]:
            raise TypeError(f"state.{name} must be {_STATE_DTYPES[name]}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"state.{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"state.{name} is not contiguous")
    if code.device != dev or code.dtype != torch.int32 or code.dim() != 1 \
            or not code.is_contiguous():
        raise ValueError("code must be a contiguous int32 vector on the "
                         "state's device")


def _check_limbs(cfg: InterpConfig) -> None:
    """The deferred model's limb widths as the reference computes them in
    32-bit words: 1 <= normalized_bits <= limb_bits <= 31."""
    if cfg.deferred and not (
            1 <= cfg.normalized_bits <= cfg.limb_bits <= 31):
        raise ValueError(
            f"deferred model limbs of {cfg.normalized_bits} and "
            f"{cfg.limb_bits} bits: need 1 <= normalized_bits <= "
            "limb_bits <= 31")


def _check_code(code, n_words: int) -> None:
    if not 0 < n_words <= code.shape[0] \
            or CODE_BASE + 4 * n_words >= 1 << 32:
        raise ValueError(f"n_words {n_words} outside the code buffer")


def _check_cells(rows: int, cfg: InterpConfig) -> None:
    if cfg.collect_trace and rows * cfg.lanes >= MAX_SEGMENT_CELLS:
        raise ValueError(f"a trace of {rows} rows x {cfg.lanes} lanes "
                         f"reaches {MAX_SEGMENT_CELLS} cells: run it in "
                         "shorter chunks or segments")


def _new_trace(rows: int, lanes: int, device,
               deferred: bool = False) -> Dict[str, torch.Tensor]:
    """Zeroed trace columns of ``rows`` rows: a row the kernel does not
    write keeps ``valid`` 0."""
    return {name: torch.zeros((rows, lanes, *tail), dtype=dt, device=device)
            for name, (dt, tail) in trace_columns(deferred).items()}


def interp_chunk(code, n_words: int, state: MachineState, cfg: InterpConfig,
                 *, decoded=None):
    """Run ``cfg.chunk`` cycles of every lane: (state, trace or None).

    ``code``: int32 ``[>= n_words]`` instruction words on the state's
    device; ``decoded``: its ``decode_table`` (made here if not given).  A
    CUDA state runs ``interp_run`` over the one-chunk segment [0, 1) on a
    copy of the state's mutable tensors, into a new trace; a CPU state
    takes the plain version."""
    _check_code(code, n_words)
    if not state.pc.is_cuda:
        return interp_chunk_plain(code, n_words, state, cfg)
    new = state._replace(**{name: getattr(state, name).clone()
                            for name in _MUTABLE})
    trace = (_new_trace(cfg.chunk, cfg.lanes, state.pc.device, cfg.deferred)
             if cfg.collect_trace else None)
    if decoded is None:
        decoded = decode_table(code)
    return interp_run(code, n_words, new, None, 0, 1, cfg, trace,
                      decoded=decoded), trace


def interp_run(code, n_words: int, state: MachineState, lane_chunk,
               seg_lo: int, seg_hi: int, cfg: InterpConfig, trace, *,
               decoded) -> MachineState:
    """Run every lane whose ``halted`` is 0 from its chunk ``lane_chunk``
    (int32 ``[L]``, or None: every lane from ``seg_lo``) until it halts,
    pauses or reaches chunk ``seg_hi``, writing chunk k's rows into rows
    ``(k - seg_lo) * chunk ...`` of ``trace`` (a dict of ``_new_trace``
    columns, or None); ``lane_chunk`` ends at each lane's next chunk.  A
    CUDA state is run in place by one launch of kernel K3 and returned; a
    CPU state takes ``interp_run_plain``, which returns a new state
    (``lane_chunk`` and ``trace`` are written in place on both)."""
    _check_code(code, n_words)
    if not state.pc.is_cuda:
        if lane_chunk is None:
            lane_chunk = torch.full((cfg.lanes,), seg_lo, dtype=torch.int32)
        return interp_run_plain(code, n_words, state, lane_chunk, seg_lo,
                                seg_hi, cfg, trace)
    from .. import _kernels

    _check_state(code, state, cfg)
    if lane_chunk is not None and (
            lane_chunk.device != state.pc.device
            or lane_chunk.dtype != torch.int32
            or tuple(lane_chunk.shape) != (cfg.lanes,)
            or not lane_chunk.is_contiguous()):
        raise ValueError("lane_chunk must be a contiguous int32 [lanes] "
                         "tensor on the state's device")
    if trace is not None:
        rows = (seg_hi - seg_lo) * cfg.chunk
        _check_cells(rows, cfg)
        for name, (dt, tail) in trace_columns(cfg.deferred).items():
            t = trace[name]
            if t.dtype != dt or tuple(t.shape) != (rows, cfg.lanes, *tail) \
                    or t.device != state.pc.device or not t.is_contiguous():
                raise ValueError(f"trace[{name!r}] must be a contiguous "
                                 f"{dt} {(rows, cfg.lanes, *tail)} tensor")
    _kernels.launch("interp_run", _descriptor(
        code, n_words, state, cfg, trace, decoded=decoded,
        lane_chunk=lane_chunk, seg=(seg_lo, seg_hi)))
    return state


def interp_run_plain(code, n_words: int, state: MachineState, lane_chunk,
                     seg_lo: int, seg_hi: int, cfg: InterpConfig, trace):
    """``interp_run`` in plain torch: ``interp_chunk_plain`` over the lanes
    at the lowest chunk index, the others held still, until no lane is
    left to run in the segment; only the valid rows of the lanes that ran
    are written, so the trace is word for word the kernel's."""
    while True:
        live = (state.halted == HALT_NONE) & (lane_chunk < seg_hi)
        if not bool(live.any()):
            return state
        k = int(lane_chunk[live].min())
        part = live & (lane_chunk == k)
        held = torch.where(part, state.halted,
                           torch.full_like(state.halted, HALT_ERROR))
        new, rows = interp_chunk_plain(code, n_words,
                                       state._replace(halted=held), cfg)
        state = new._replace(halted=torch.where(part, new.halted,
                                                state.halted))
        lane_chunk[part] = k + 1
        if trace is not None:
            r0 = (k - seg_lo) * cfg.chunk
            keep = rows["valid"] & part
            for name, col in rows.items():
                dst = trace[name][r0:r0 + cfg.chunk]
                m = keep.reshape(*keep.shape, *([1] * (col.dim() - 2)))
                dst.copy_(torch.where(m, col, dst))


def _descriptor(code, n_words, s: MachineState, cfg: InterpConfig, trace, *,
                decoded=None, lane_chunk=None, seg=(0, 1), warp=None):
    """The host descriptor as ``csrc/interp.cu`` reads it (its enum)."""
    if warp is None:
        warp = warp_layout(cfg.lanes, cfg.collect_trace)
    words = [
        code.data_ptr(), n_words, cfg.lanes, cfg.chunk,
        s.pc.data_ptr(), s.regs.data_ptr(), s.bound_bits.data_ptr(),
        s.accum.data_ptr(), s.halted.data_ptr(), s.exit.data_ptr(),
        s.cycles.data_ptr(), s.mem.data_ptr(), s.mem.shape[1],
        cfg.low_bytes, cfg.stack_bytes, int(cfg.enable_memory),
        s.inputs.data_ptr(), s.n_inputs.data_ptr(), s.input_pos.data_ptr(),
        cfg.max_inputs,
        s.outputs.data_ptr(), s.out_pos.data_ptr(), cfg.max_outputs,
        int(trace is not None),
        *((trace[name].data_ptr() if name in trace else 0
           for name in trace_columns(True))
          if trace is not None else (0,) * len(trace_columns(True))),
        0 if decoded is None else decoded.data_ptr(),
        0 if lane_chunk is None else lane_chunk.data_ptr(),
        *seg, int(warp),
        int(cfg.deferred), cfg.normalized_bits, cfg.limb_bits,
        # The observation points' opcode mask, bits 0-63 and 64-127.
        int(_i64_bits(_OBSERVES & (2**64 - 1))), _OBSERVES >> 64,
    ]
    return (ctypes.c_longlong * len(words))(*words)


# ============================================================================
# The interpreter
# ============================================================================


def _u64(t: torch.Tensor) -> np.ndarray:
    """The unsigned view of an int64 tensor of bit patterns, on the host."""
    return t.cpu().numpy().view(np.uint64)


def _i64_bits(a) -> np.ndarray:
    """uint64 values (or Python ints < 2^64) as int64 bit patterns."""
    return np.asarray(a, dtype=np.uint64).view(np.int64)


class TpuInterpreter:
    """Batched interpreter for one program and configuration, under the
    reference's name.  ``device`` (required) is where the state lives and
    the chunks run: a CUDA device launches kernel K3, ``"cpu"`` takes the
    plain version."""

    def __init__(self, program: Program,
                 config: Optional[InterpConfig] = None, *, device):
        self.program = program
        self.config = config or InterpConfig()
        self.device = torch.device(device)
        _check_limbs(self.config)
        code = np.asarray(program.code, dtype=np.uint32)
        # An empty program runs as one zero word, as in the reference.
        self.n_words = max(len(program.code), 1)
        padded = np.zeros(self.n_words, dtype=np.uint32)
        padded[: code.size] = code
        self.code = torch.from_numpy(padded.view(np.int32)).to(self.device)
        self.decoded = decode_table(self.code)
        self.features = program_features(code)
        # A program with no load, store or ECALL cannot touch data memory
        # (fetch reads the immutable code buffer): it carries no image.
        if "mem" not in self.features and self.config.enable_memory:
            self.config = dataclasses.replace(self.config,
                                              enable_memory=False)

    def chunk_fn(self, state: MachineState):
        """``config.chunk`` cycles of every lane: (state, trace or None)."""
        return interp_chunk(self.code, self.n_words, state, self.config,
                            decoded=self.decoded)

    def with_lanes(self, lanes: int) -> "TpuInterpreter":
        """This interpreter for states of ``lanes`` lanes: the same
        program, code and decoded table on the same device, the
        configuration's ``lanes`` replaced.  A rank's shard of a
        lane-sharded state (``parallel.sharded_interpreter_state``) runs
        through the interpreter of its own lane count, since every check
        and the kernel's layout follow ``config.lanes``."""
        other = copy.copy(self)
        other.config = dataclasses.replace(self.config, lanes=lanes)
        return other

    # ------------------------------------------------------------------
    # State construction
    # ------------------------------------------------------------------

    def init_state(self, inputs_per_lane: List[List[int]]) -> MachineState:
        cfg = self.config
        L = cfg.lanes
        if len(inputs_per_lane) != L:
            raise ValueError(f"{len(inputs_per_lane)} input tapes for "
                             f"{L} lanes")

        if cfg.enable_memory:
            # Code at CODE_BASE, data right after; the same image in every
            # lane, expanded on the device.
            image = np.zeros(cfg.low_bytes + cfg.stack_bytes, dtype=np.uint8)
            code_bytes = np.frombuffer(
                np.asarray(self.program.code, dtype="<u4").tobytes(),
                dtype=np.uint8)
            end = CODE_BASE + len(code_bytes)
            if end > cfg.low_bytes:
                raise ValueError("program too large for low memory window")
            image[CODE_BASE:end] = code_bytes
            if self.program.data:
                data = np.frombuffer(bytes(self.program.data), dtype=np.uint8)
                dend = end + len(data)
                if dend > cfg.low_bytes:
                    raise ValueError("data too large for low memory window")
                image[end:dend] = data
            mem = torch.from_numpy(image).to(self.device).repeat(L, 1)
        else:
            mem = torch.zeros((L, 1), dtype=torch.uint8, device=self.device)

        inp = np.zeros((L, cfg.max_inputs), dtype=np.uint64)
        n_in = np.zeros(L, dtype=np.int32)
        for lane, vals in enumerate(inputs_per_lane):
            if len(vals) > cfg.max_inputs:
                raise ValueError("too many inputs for tape")
            inp[lane, : len(vals)] = np.asarray(vals, dtype=np.uint64)
            n_in[lane] = len(vals)

        bounds = np.full((L, 16), self.program.config().data_bits,
                         dtype=np.int32)
        bounds[:, 0] = 0
        dev = self.device

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        entry = int(self.program.header.entry_point)
        return MachineState(
            pc=torch.full((L,), int(_i64_bits(entry)), dtype=torch.int64,
                          device=dev),
            regs=zeros((L, 16), torch.int64),
            bound_bits=torch.from_numpy(bounds).to(dev),
            accum=zeros((L, 16), torch.int32),
            halted=zeros((L,), torch.int32),
            exit=zeros((L,), torch.int64),
            cycles=zeros((L,), torch.int64),
            mem=mem,
            inputs=torch.from_numpy(_i64_bits(inp)).to(dev),
            n_inputs=torch.from_numpy(n_in).to(dev),
            input_pos=zeros((L,), torch.int32),
            outputs=zeros((L, cfg.max_outputs), torch.int64),
            out_pos=zeros((L,), torch.int32),
        )

    # ------------------------------------------------------------------
    # Host driver
    # ------------------------------------------------------------------

    def run(self, inputs_per_lane: List[List[int]],
            max_cycles: int = 1_000_000) -> Dict[str, Any]:
        """Run all lanes to completion; returns per-lane results and
        (optionally) stacked trace columns."""
        return self.resume(self.init_state(inputs_per_lane), max_cycles)

    def resume(self, state: MachineState,
               max_cycles: int = 1_000_000) -> Dict[str, Any]:
        """Run ``state`` on to completion (at most ``max_cycles`` more
        steps), as ``run`` does from the initial state.

        The reference's host loop runs chunk after chunk, services the
        paused lanes after each, and stops once no lane runs or after
        ``ceil(max_cycles / chunk)`` chunks, marking the lanes still
        running ``HALT_CYCLE_LIMIT``.  Here each lane keeps its own chunk
        index and runs on by itself through a segment of chunks (one
        ``interp_run``); the host services the paused lanes and runs the
        segment again until no lane is left in it, then allocates the next
        segment, twice as long.  The trace keeps the chunks the reference
        loop would have run.  Works in place on a copy of ``state``."""
        cfg = self.config
        dev = state.pc.device
        state = state._replace(**{name: getattr(state, name).clone()
                                  for name in _MUTABLE})
        lane_chunk = torch.zeros(cfg.lanes, dtype=torch.int32, device=dev)
        k_max = max(1, -(-max_cycles // cfg.chunk))
        size = most = k_max
        if cfg.collect_trace:
            cells = cfg.chunk * cfg.lanes
            most = max(1, (MAX_SEGMENT_CELLS - 1) // cells)
            row_bytes = (DEFERRED_ROW_BYTES if cfg.deferred
                         else TRACE_ROW_BYTES)
            size = max(1, min(k_max, most,
                              FIRST_SEGMENT_BYTES // (row_bytes * cells)))
        segments: List[Dict[str, torch.Tensor]] = []
        seg_lo = 0
        while True:
            seg_hi = min(seg_lo + size, k_max)
            trace = (_new_trace((seg_hi - seg_lo) * cfg.chunk, cfg.lanes,
                                dev, cfg.deferred)
                     if cfg.collect_trace else None)
            while True:
                state = interp_run(self.code, self.n_words, state,
                                   lane_chunk, seg_lo, seg_hi, cfg, trace,
                                   decoded=self.decoded)
                halted, at = torch.stack(
                    [state.halted, lane_chunk]).cpu().numpy()
                if np.any(halted == PAUSE_CRYPTO):
                    state = self._service_crypto(state)
                    halted = np.where(halted == PAUSE_CRYPTO, HALT_NONE,
                                      halted)
                if not np.any((halted == HALT_NONE) & (at < seg_hi)):
                    break
            if trace is not None:
                segments.append(trace)
            if np.all(halted != HALT_NONE):
                break
            if seg_hi >= k_max:
                state = state._replace(halted=torch.where(
                    state.halted == HALT_NONE,
                    torch.full_like(state.halted, HALT_CYCLE_LIMIT),
                    state.halted))
                break
            seg_lo, size = seg_hi, min(2 * size, most)
        # The reference loop's chunks: up to the last one a lane ran in.
        return self._collect(state, segments,
                             max(1, int(at.max())) * cfg.chunk)

    def _service_crypto(self, state: MachineState) -> MachineState:
        """Service the paused crypto syscalls of all lanes at once, in
        place, and return ``state``.  Only the paused lanes' argument
        registers cross to the host (one copy), where their spans are
        checked against the windows; then each hash kind (SHA-256,
        Poseidon2, Keccak-256, BLAKE3) is one batch over the lanes that
        asked for it, reading the input bytes where they lie in the memory
        images, and one indexed write stores every lane's 32-byte image.
        Registers, bounds, ``pc``, ``cycles`` and ``halted`` are indexed
        writes over all paused lanes.  The images are those of the
        reference's syscalls (``prover/trace.py::crypto_digest``)."""
        from ..ops import blake3, keccak, poseidon2, sha256

        cfg = self.config
        dev = state.mem.device
        paused = torch.nonzero(state.halted == PAUSE_CRYPTO).flatten()
        args = torch.cat([paused[:, None], state.regs[paused, 10:14]],
                         1).cpu().numpy()
        lanes = args[:, 0]
        num, in_ptr, in_len, out_ptr = args[:, 1:].view(np.uint64).T
        width = state.mem.shape[1]
        low = np.uint64(cfg.low_bytes)
        stack_lo = np.uint64(STACK_TOP - cfg.stack_bytes + 1)
        top = np.uint64(STACK_TOP + 1)

        def offsets(addr, n):
            """(inside a window, offset in the lane's image) of each span
            [addr, addr + n); unsigned arithmetic that cannot wrap."""
            in_low = (n <= low) & (addr <= low - np.minimum(n, low))
            in_stack = (addr >= stack_lo) & (addr <= top) & (
                n <= top - np.minimum(addr, top))
            off = np.where(in_low, addr, low + (addr - stack_lo))
            return in_low | in_stack, np.where(
                in_low | in_stack, off, 0).astype(np.int64)

        # No input byte is read when there is none: the reference checks
        # each byte's address, so an empty input may point anywhere.
        in_ok, in_off = offsets(in_ptr, in_len)
        in_ok |= in_len == 0
        out_ok, out_off = offsets(out_ptr, np.full_like(out_ptr, 32))
        bad = np.nonzero(~(in_ok & out_ok))[0]
        if bad.size:
            k = bad[0]
            addr, n = ((in_ptr[k], in_len[k]) if not in_ok[k]
                       else (out_ptr[k], 32))
            raise ValueError(f"crypto access outside window: {int(addr):#x} "
                             f"(+{int(n)}) in lane {lanes[k]}")
        if not np.all((num >= 3) & (num <= 6)):
            wrong = num[(num < 3) | (num > 6)][0]
            raise ValueError(f"not a crypto syscall number: {int(wrong)}")

        # Each kind's digest as eight 32-bit words whose little-endian bytes
        # are the image: SHA-256's big-endian words stored by write_u32
        # (each 4-byte group of the digest reversed), Poseidon2's field
        # words, the Keccak and BLAKE3 digest bytes.
        data = state.mem.view(-1)
        in_off = np.where(in_len > 0, lanes * width + in_off, 0)
        words = torch.empty((len(lanes), 8), dtype=torch.int64, device=dev)
        for kind, fn in ((3, sha256.sha256_rows),
                         (4, poseidon2.sponge_hash_rows),
                         (5, keccak.keccak256_words),
                         (6, blake3.blake3_rows)):
            rows = np.nonzero(num == kind)[0]
            if rows.size:
                words[torch.from_numpy(rows).to(dev)] = fn(
                    data, in_off[rows], in_len[rows].astype(np.int64))
        image = (words[:, :, None] >> torch.arange(0, 32, 8, device=dev)) \
            & 0xFF
        at = torch.from_numpy(lanes * width + out_off).to(dev)
        data[at[:, None] + torch.arange(32, device=dev)] = image.reshape(
            -1, 32).to(torch.uint8)

        state.regs[paused, 10] = 0
        sha = torch.from_numpy(lanes[num == 3]).to(dev)
        state.bound_bits[sha, 14] = 32      # SHA-256's output bound: r14
        state.pc[paused] += 4
        state.cycles[paused] += 1
        state.halted[paused] = HALT_NONE
        return state

    def _collect(self, state: MachineState,
                 segments: List[Dict[str, torch.Tensor]],
                 rows: int) -> Dict[str, Any]:
        out_pos = state.out_pos.cpu().numpy()
        outputs = _u64(state.outputs)
        result: Dict[str, Any] = {
            "halted": state.halted.cpu().numpy(),
            "exit_code": _u64(state.exit),
            "cycles": state.cycles.cpu().numpy(),
            "regs": _u64(state.regs),
            "bound_bits": state.bound_bits.cpu().numpy(),
            "outputs": [
                list(outputs[lane, : out_pos[lane]])
                for lane in range(self.config.lanes)
            ],
        }
        if segments:
            cols = {key: [t[key] for t in segments] for key in segments[0]}
            result["trace"] = _merge_trace_host({
                key: (c[0] if len(c) == 1 else torch.cat(c))[:rows]
                .cpu().numpy() for key, c in cols.items()}, self.config)
        return result


def _merge_trace_host(t: Dict[str, np.ndarray],
                      cfg: Optional[InterpConfig] = None
                      ) -> Dict[str, np.ndarray]:
    """The reference's trace dict (keys, shapes, numpy dtypes) from the
    chunk's columns: unsigned views of the 64-bit words, and the columns
    the device does not write (``rc_chunks`` are the four 10-bit chunks of
    ``rc_value``; ``accum_mask`` is 0 outside the deferred model).  With
    the deferred model (``accum_mask`` among the columns; limb widths from
    ``cfg``) also the rs1 normalization witness of each row, a function of
    its pre-state registers, ``accum_mask`` and word: ``norm_valid`` where
    the row's instruction is an observation point with rs1 != 0,
    ``norm_reg`` = rs1, the limbs read (``norm_acc0/1``), normalized
    (``norm_n0/1``) and the carries (``norm_c0/1``); the other rows hold
    the same function of rs1."""
    rc_value = t["rc_value"].view(np.uint64)
    deferred = "accum_mask" in t
    out = {
        "valid": t["valid"],
        "cycle": t["cycle"],
        "pc": t["pc"].view(np.uint64),
        "word": t["word"].view(np.uint32),
        "regs": t["regs"].view(np.uint64),
        "bounds": t["bounds"],
        "accum_mask": (t["accum_mask"].view(np.uint32) if deferred else
                       np.zeros(t["valid"].shape, dtype=np.uint32)),
        "mem_valid": t["mem_valid"],
        "mem_addr": t["mem_addr"].view(np.uint64),
        "mem_value": t["mem_value"].view(np.uint64),
        "mem_width": t["mem_width"],
        "mem_is_write": t["mem_is_write"],
        "rc_valid": t["rc_valid"],
        "rc_value": rc_value,
        "rc_chunks": np.stack(
            [(rc_value >> np.uint64(10 * c)) & np.uint64(0x3FF)
             for c in range(4)], axis=-1),
    }
    if deferred:
        cfg = cfg or InterpConfig(deferred=True)
        out.update(_norm_witness(out, cfg.normalized_bits, cfg.limb_bits))
    return out


def _norm_witness(t: Dict[str, np.ndarray], nb: int,
                  lb: int) -> Dict[str, np.ndarray]:
    """``norm_*`` of every row (``_merge_trace_host``)."""
    word = t["word"].astype(np.int64)
    op = word & 0x7F
    sb = ((op >= 0x38) & (op <= 0x3B)) | ((op >= 0x40) & (op <= 0x45))
    rs1 = np.where(sb, (word >> 7) & 0xF, (word >> 11) & 0xF)
    v = np.take_along_axis(t["regs"], rs1[..., None], axis=-1)[..., 0]
    acc = (t["accum_mask"].astype(np.int64) >> rs1) & 1
    bits = np.where(acc == 1, lb, nb).astype(np.uint64)
    mask = (np.uint64(1) << bits) - np.uint64(1)
    l0 = v & mask
    l1 = (v >> bits) & mask
    n_mask, nb_ = np.uint64((1 << nb) - 1), np.uint64(nb)
    c0 = l0 >> nb_
    l1c = l1 + c0
    return {
        "norm_valid": t["valid"] & _OBSERVED[op] & (rs1 != 0),
        "norm_reg": rs1.astype(np.int32),
        "norm_acc0": l0, "norm_acc1": l1,
        "norm_n0": l0 & n_mask, "norm_n1": l1c & n_mask,
        "norm_c0": c0, "norm_c1": l1c >> nb_,
    }
