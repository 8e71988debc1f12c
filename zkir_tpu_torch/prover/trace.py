"""Execution trace -> AIR trace matrix over M31.

Converts the interpreter's columnar trace dict (TpuInterpreter.run with
``collect_trace=True``; oracle TraceRow lists are NOT accepted — run the
program through the device interpreter to prove it)
into a 2-D matrix of M31 field elements, one row per cycle:

    [pc_lo, pc_hi, opcode, rd, rs1, rs2, imm_lo, imm_hi,
     16 x (reg limb0, reg limb1),
     mem_addr_lo, mem_addr_hi, mem_val_lo, mem_val_hi, mem_flags]

plus the AIR helper columns [is_seq, pc_carry] (see prover/constraints.py),
the 4 range-check chunk columns, the 50-column opcode one-hot selector
block, and the 16-column rd one-hot block.

ALU result-binding witness columns (prover/constraints.py):

    rs1 one-hot [16], rs2 one-hot [16],
    res_lo, res_hi      -- the value written by this row's instruction
                           (canonical 40-bit view, 2 x 20-bit limbs),
    c0, c1              -- per-limb carry/borrow bits of the pinned ops,
    imm_s, imm_q0, imm_q1, imm_q0hi
                        -- immediate decomposition: the raw 17-bit field
                           imm = q0 + 2^10 q1 + 2^16 s with q0 < 2^10,
                           q1 < 2^6, s the sign bit; q0 = rs2 + 16 q0hi
                           pins the overlapping rs2 bitfield,
    rl0, rl1, rh0, rh1  -- 10-bit chunks of res_lo/res_hi (range lookup).

``res`` is semantically pinned for ADD/SUB/ADDI/JAL/JALR; for other
writing opcodes it commits the observed written value (the canonical
next-row rd) and awaits op-specific constraints.  Traces must end in a
halt row (EBREAK/ECALL): the post-state of a final *writing* row is
unobservable, so such traces are rejected at prove time.

Register columns commit the *canonical value view*: the 40-bit value
``(limb0 + limb1*2^20) mod 2^40`` regardless of the machine's internal
packing (accumulated registers pack at 30-bit boundaries — see
``runtime/state.py:write_reg_from_accumulated``).  Deferred-model
normalization preserves this value (``normalize.rs:85-105`` drops the top
carry, i.e. reduces mod 2^40), so observation-point pre-normalization is
invisible in the committed columns and the register-file AIR can require
that only the written register changes between rows.

40-bit values split into 2 x 20-bit limbs (each < p); the 17-bit
immediate and memory metadata fit directly.  This is the matrix committed
by the prover (reference analogue: the TraceRow struct,
``zkir-spec/src/trace.rs:24-50``, reshaped struct-of-arrays).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..spec.memlayout import CODE_BASE

_M20 = (1 << 20) - 1
_M30 = (1 << 30) - 1
_M40 = (1 << 40) - 1

# Opcode values in selector-block order (all 50 valid opcodes, sorted).
OP_VALUES = (
    0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08,
    0x10, 0x11, 0x12, 0x13, 0x14, 0x15,
    0x18, 0x19, 0x1A, 0x1B, 0x1C, 0x1D,
    0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28,
    0x30, 0x31, 0x32, 0x33, 0x34, 0x35,
    0x38, 0x39, 0x3A, 0x3B,
    0x40, 0x41, 0x42, 0x43, 0x44, 0x45,
    0x48, 0x49,
    0x50, 0x51,
)
N_OPS = len(OP_VALUES)

N_BASE_COLUMNS = 8 + 32 + 5 + 2 + 4          # 51: layout above
N_DECODE_COLUMNS = N_BASE_COLUMNS + N_OPS + 16   # + opcode 1-hot + rd 1-hot
# ALU result-binding block: rs1/rs2 one-hots, result limbs, carries,
# immediate decomposition, result range chunks.
N_ALU_COLUMNS = N_DECODE_COLUMNS + 16 + 16 + 2 + 2 + 4 + 4
# Control-flow block: taken bit, pc-target carries c2 (in {0,1,2}) and
# c3, JALR LSB-clear witness.  Branch rows take pc' = pc + (taken ?
# sext17(imm) : 4); JAL pc' = pc + sext21(16*imm + rs1); JALR
# pc' = (rs1_val + sext17(imm)) & ~1.  Target limb ranges come from
# program binding (the next row's pc is a table pc).
N_CF_COLUMNS = N_ALU_COLUMNS + 4
# Memory-op binding block: 10-bit chunks of the memory-address limbs
# (al0, al1, ah0, ah1 -- unique-encoding range checks for the address
# pin maddr = base + sext17(imm), which reuses c2/c3 as carries on
# load/store rows), and the SW high-limb truncation witness tw
# (b_hi = mval_hi + 2^12 tw, tw < 2^8).
N_MEM_COLUMNS = N_CF_COLUMNS + 5
# Memory-consistency block: the exec clk column (row index; clk' = clk+1,
# clk(0) = 0) and the (cell, clk)-sorted memory UPDATE table covering
# EVERY load/store width.  Memory is modeled as 8-byte aligned cells; a
# table row is one update (cell key qa/qb/ahi, clk+1, old cell bytes
# ob0-7, new cell bytes nb0-7) plus is_real, same (continues the
# previous cell's run), hieq (addr_hi equal to previous), and the
# 10+10-bit gap chunks cha/chb shared by the clk-strict-increase (same
# run) and cell-strict-increase (new run) arguments.  Within a run each
# row's old bytes must equal the previous row's new bytes; a fresh run
# starts from the zero cell.  Data/code-segment initial values enter as
# clk-0 update rows (0 -> initial bytes) whose multiset demand the
# VERIFIER computes from the public program (prover.py
# memory_init_demand).  The block is filled by the prover post-padding
# (prover/prover.py _build_memory_table); trace_to_matrix leaves it zero.
COL_CLK = N_MEM_COLUMNS
M_BASE = N_MEM_COLUMNS + 1
N_MEMTABLE_COLUMNS = 26                     # qa qb ahi clk ob0-7 nb0-7
#                                             real same hieq cha chb chc
# Compare / branch-condition / cmov block.  Committed degree-1 operand
# views (va = rs1-field operand, vb = rs2-field, vg = rd-field, pinned to
# the one-hot inner products), the generic difference cu = x - y mod 2^40
# (compare/branch rows: a - b with borrow bits cb0/cb1 -> cb1 is the
# unsigned less-than; cmov rows: b) with 10-bit range chunks, the
# equality gadget (ceq, cinv) on cu_lo + cu_hi, sign decompositions
# va_hi = ar0 + 2^10 ar1 + 2^19 sa (ditto vb_hi/sb) for the signed
# compare sign-XOR trick, and the XOR intermediate x1 = cb1 ^ sa
# (lt_signed = x1 ^ sb).  Constraints derive the branch taken bit and
# pin the compare-family and cmov results (prover/constraints.py).
CMP_BASE = M_BASE + N_MEMTABLE_COLUMNS
COL_VA_LO = CMP_BASE
COL_VA_HI = CMP_BASE + 1
COL_VB_LO = CMP_BASE + 2
COL_VB_HI = CMP_BASE + 3
COL_VG_LO = CMP_BASE + 4
COL_VG_HI = CMP_BASE + 5
COL_CU_LO = CMP_BASE + 6
COL_CU_HI = CMP_BASE + 7
COL_CB0 = CMP_BASE + 8
COL_CB1 = CMP_BASE + 9
COL_CCH0 = CMP_BASE + 10             # 4 chunks of cu_lo/cu_hi
COL_CINV = CMP_BASE + 14
COL_CEQ = CMP_BASE + 15
COL_SA = CMP_BASE + 16
COL_AR0 = CMP_BASE + 17
COL_AR1 = CMP_BASE + 18
COL_SB = CMP_BASE + 19
COL_BR0 = CMP_BASE + 20
COL_BR1 = CMP_BASE + 21
COL_X1 = CMP_BASE + 22
# Halt-chain block: exit-ECALL detection.  eex = [r10 == 0] (syscall
# number zero = EXIT, syscall.rs:18-24) via the inverse gadget on
# s = r10_lo + r10_hi (< 2^21, zero iff the canonical r10 value is zero);
# einv commits s^-1.  Constraints force: an EBREAK row's successor is an
# EBREAK row; an exit-ECALL row's successor is an EBREAK row ("a halted
# machine keeps halting"); a non-exit ECALL row advances pc by 4
# (reusing the pc_carry column, which is free on non-is_seq rows).
COL_EEX = CMP_BASE + 23
COL_EINV = CMP_BASE + 24
# Multiply/divide block.  One shared grade-school multiplier over 10-bit
# chunks pins all six ops (semantics: execute.rs:85-183 on the canonical
# 40-bit operand views):
#   x, y chunks  xq0..3 / yq0..3  -- the multiplier inputs: (a, b) on
#       MUL/MULH rows; (q, b) on DIV-family rows (q = the quotient:
#       res on DIV/DIVU rows, a free 40-bit witness on REM/REMU rows)
#   column sums  s_k = sum_{i+j=k} xq_i * yq_j   (k = 0..6, degree 2)
#   carry chain  s_k + k_{k-1} = chunk_k + 2^10 * k_k   over integers
#       (every term < 2^23 << p, so the field identity is the integer
#       identity); chunk_0..3 = the product's low 40 bits, chunk_4..7 =
#       the high 40 bits.  Carries k0 < 2^10; k1..k6 get a 12-bit budget
#       committed as a 10-bit chunk + two bits (k = kc + 2^10(kb0+2kb1)).
#   pl0..3       -- low-product chunks when the row's result is NOT the
#       low product (MULH keeps the high half; DIV keeps the quotient)
#   dr0..3       -- remainder chunks (DIV family): a = q*b + r exactly
#       (high product chunks forced to zero), with r < b enforced by
#       u = b - 1 - r >= 0 (chunks u0..3, borrow e0); cd0 is the carry
#       of the limb-wise a = pl + r addition
MD_BASE = CMP_BASE + 25
COL_XQ0 = MD_BASE                 # 4 x-operand chunks
COL_YQ0 = MD_BASE + 4             # 4 y-operand chunks
COL_PL0 = MD_BASE + 8             # 4 low-product chunks
COL_K0 = MD_BASE + 12             # carry k0 (single 10-bit chunk)
COL_K1C = MD_BASE + 13            # k1 = k1c + 2^10*k1b
COL_K1B = MD_BASE + 14
COL_K2C = MD_BASE + 15            # k2..k5 = kc + 2^10*(kb0 + 2*kb1)
COL_K2B0 = MD_BASE + 16
COL_K2B1 = MD_BASE + 17
COL_K3C = MD_BASE + 18
COL_K3B0 = MD_BASE + 19
COL_K3B1 = MD_BASE + 20
COL_K4C = MD_BASE + 21
COL_K4B0 = MD_BASE + 22
COL_K4B1 = MD_BASE + 23
COL_K5C = MD_BASE + 24
COL_K5B0 = MD_BASE + 25
COL_K5B1 = MD_BASE + 26
COL_K6C = MD_BASE + 27            # k6 = k6c + 2^10*k6b
COL_K6B = MD_BASE + 28
COL_DR0 = MD_BASE + 29            # 4 remainder chunks
COL_U0 = MD_BASE + 33             # 4 chunks of u = b - 1 - r
COL_CD0 = MD_BASE + 37            # a = pl + r lo-limb carry bit
COL_E0 = MD_BASE + 38             # u lo-limb borrow bit
# Logical block (AND/OR/XOR + immediates, execute.rs:147-165 semantics on
# the canonical 40-bit views).  One committed AND value c = a & b plus
# 5-bit chunk decompositions of a, b, c (8 chunks each; chunks 0-3 are
# the low limb).  Challenge-compressed LogUp against the preprocessed
# AND table (prover/aux_table.py) pins each (a_k, b_k, c_k) triple; the
# carry-free identities XOR = a + b - 2c and OR = a + b - c pin the
# other two ops.  b is vb on register variants, sext17(imm) on
# immediate variants.
LG_BASE = MD_BASE + 39
COL_LG_A0 = LG_BASE               # 8 a-operand 5-bit chunks
COL_LG_B0 = LG_BASE + 8           # 8 b-operand 5-bit chunks
COL_LG_C0 = LG_BASE + 16          # 8 AND-value 5-bit chunks
COL_LG_C_LO = LG_BASE + 24        # AND value limbs
COL_LG_C_HI = LG_BASE + 25
# Shift block (SLL/SRL/SRA + immediates, execute.rs:285-322: shamt
# masked to 6 bits; shifts >= 40 yield 0 / the sign fill).  The shift
# power y = 2^s_eff rides the multiply/divide block as its y operand
# (SLL = low product; SRL/SRA = division by y with remainder), with the
# (s_eff, d, pm) triple challenge-compressed against the preprocessed
# shift table: y's only live 10-bit chunk is chunk d = s_eff // 10 with
# value pm = 2^(s_eff % 10) (d = 4, pm = 0 for s_eff >= 40).
#   s      raw 6-bit amount: src = s + 64*shq (src = vb_lo or i_lo)
#   s_eff  = s on register shifts and in-range immediates; 63 when the
#            immediate's masking quotient shq != 0 (imm >= 64 behaves
#            like any other shift >= 40)
#   z      = [shq == 0] via the (z, zinv) inverse gadget
#   d0..4  one-hot of d;  pm  the live chunk value
#   xd     the SRL/SRA dividend: va, conditionally complemented on SRA
#          rows (sra(a, s) = ~srl(~a, s) when the sign bit is set)
SH_BASE = LG_BASE + 26
COL_SH_S = SH_BASE
COL_SH_SEFF = SH_BASE + 1
COL_SH_SHQ = SH_BASE + 2
COL_SH_SHQC0 = SH_BASE + 3        # shq = shqc0 + 2^10 shqc1 (range)
COL_SH_SHQC1 = SH_BASE + 4
COL_SH_Z = SH_BASE + 5
COL_SH_ZINV = SH_BASE + 6
COL_SH_D0 = SH_BASE + 7           # 5 one-hot columns
COL_SH_PM = SH_BASE + 12
COL_SH_XD_LO = SH_BASE + 13
COL_SH_XD_HI = SH_BASE + 14
# SW truncation uniqueness: mval_hi = swh0 + 2^10 swh1 with swh0 < 2^10
# and swh1 < 4 (lookup channels), so mval_hi < 2^12 and the
# a_hi = mval_hi + 2^12 tw pin is a unique decomposition.
COL_SW_MH0 = SH_BASE + 15
COL_SW_MH1 = SH_BASE + 16
# Memory byte-level witness block (every load/store, all widths).
# Memory is 8-byte aligned cells; maddr_lo = 8*(qa + 2^10 qb) + off with
# off one-hot (o0-7), qa < 2^10, qb < 2^7.  The cell's pre-state bytes
# ob0-7 and post-state bytes nb0-7 are committed (loads: nb == ob); the
# update multiset ties them across rows (table block above).  Store
# value bytes decompose the 40-bit va operand: va_lo = sb0 + 2^8 sb1 +
# 2^16 snl, va_hi = snh + 16 sb3 + 2^12 sb4, byte2 = snl + 16 snh
# (nibble split at the 20-bit limb boundary).  Sign-extending loads
# commit the sign bit ms and the low parts: LB b = mcb + 128 ms
# (mcb < 128); LH h = mch0 + 2^10 mch1 + 2^15 ms (mch0 < 2^10,
# mch1 < 32).  LW/LD split the third selected byte into nibbles
# mlnib + 16 mhnib at the res limb boundary.
MB_BASE = SH_BASE + 17
COL_MO0 = MB_BASE                 # 8 offset one-hot columns
COL_MQA = MB_BASE + 8
COL_MQB = MB_BASE + 9
COL_OB0 = MB_BASE + 10            # 8 old cell bytes
COL_NB0 = MB_BASE + 18            # 8 new cell bytes
COL_SB0 = MB_BASE + 26            # store-value bytes 0, 1
COL_SB1 = MB_BASE + 27
COL_SNL = MB_BASE + 28            # store-value byte-2 nibbles
COL_SNH = MB_BASE + 29
COL_SB3 = MB_BASE + 30            # store-value bytes 3, 4
COL_SB4 = MB_BASE + 31
COL_MCB = MB_BASE + 32            # LB low part (< 128)
COL_MCH0 = MB_BASE + 33           # LH low-part chunks
COL_MCH1 = MB_BASE + 34
COL_MS = MB_BASE + 35             # load sign bit
COL_MLNIB = MB_BASE + 36          # LW/LD selected-byte-2 nibbles
COL_MHNIB = MB_BASE + 37
# I/O-tape binding block: on ECALL rows the syscall number (the R10
# pre-state, syscall.rs:94-97) is decomposed into three bits
# (num = b0 + 2 b1 + 4 b2, with b0 b1 b2 = 0 capping num at 6 and the
# high R10 limb pinned to zero — so an InvalidSyscall number cannot
# appear on an accepted ECALL row); erd/ewr flag READ (num = 1) and
# WRITE (num = 2) rows; ridx/widx are the running tape indices
# (exclusive prefix counts, +erd/+ewr per row from 0).  The io multiset
# channel (constraints.io_multiset) binds the (idx, value) tuple of
# every READ (value = the next row's R10 = the syscall result) and
# WRITE (value = this row's R11) to the PUBLIC tape demand the verifier
# recomputes from the proof's claimed tapes (prover.io_tape_demand) —
# so an accepted proof attests the exact input/output tape contents
# (syscall.rs:18-24, 54-78).
IO_BASE = MB_BASE + 38
COL_IO_B0 = IO_BASE
COL_IO_B1 = IO_BASE + 1
COL_IO_B2 = IO_BASE + 2
COL_ERD = IO_BASE + 3
COL_EWR = IO_BASE + 4
COL_RIDX = IO_BASE + 5
COL_WIDX = IO_BASE + 6
# Crypto-syscall binding block (syscall.rs:121-177 semantics; closes the
# "crypto syscalls cannot be proven" gap carried since round 1).  On an
# ECALL row with num in {3..6} (SHA256/POSEIDON2/KECCAK256/BLAKE3) the
# machine hashes len = R12 bytes at ptr = R11 and writes the 32-byte
# digest at out = R13.  The PROVABLE DOMAIN is 8-aligned ptr/out with
# len <= CRYPTO_MAX_TOTAL (the runtime executes anything; unaligned or
# longer inputs are a documented completeness limit — trace_to_matrix
# raises).
#
# Design (no in-AIR hash): each crypto CHUNK ROW carries up to 7 READ
# SLOTS (one per input cell, bytes ob==nb) and 4 WRITE SLOTS (digest
# cells, old -> digest bytes; live only on the FINAL chunk row), each
# entering the byte-level memory-update multiset as an extra demand via
# a committed phase-2 inverse column (inv_s * (beta - w_s) = active_s);
# reads timestamp 2*clk + 1, writes 2*clk + 2 (regular loads/stores use
# 2*clk + 2), so an in-place hash read-then-write chains correctly.
# Slot keys derive from R11/R13: q_0 = R11_lo / 8 (field-exact; forces
# 8-alignment), ahi_0 = R11_hi, read slot i of chunk cblk has key
# q_0 + 7*cblk + i - 2^17 c_i with committed carry bits.
#
# MULTI-BLOCK CHAINING (len > 56, round-5 upgrade): a syscall hashing
# len bytes expands into ceil(len/56) ADJACENT chunk rows sharing the
# machine state (pc and registers frozen across the chain; clk still
# advances, so every chunk's memory reads are distinctly timestamped).
# Chain bookkeeping columns, all AIR-enforced:
#   cblk   chunk index within the chain (0 on a fresh syscall; the
#          slot keys advance by 7 cells per chunk)
#   more   1 on every chunk row except the last
#   crem   bytes REMAINING at this chunk: crem = R12_lo on the first
#          chunk (R12_hi pinned 0, so len < 2^20 by register range),
#          crem' = crem - 56 across more-rows, and the final row pins
#          crem = 8*nc - pad in [0, 56] — so the CHAIN LENGTH and total
#          hashed byte count are forced by R12 (a truncated or extended
#          chain cannot close: 56k ~ p needs ~2^25 rows > any domain).
# Non-final rows pin len = 56 (full slots) and zero digest slots.
#
# The (num, cidx, chunk_len, more, 56 input bytes, 32 digest bytes)
# tuple of EVERY chunk row is LogUp-bound to the PUBLIC crypto tape;
# the verifier reassembles each chain's message from consecutive
# entries and RECOMPUTES the digest (prover.crypto_tape_demand), so a
# forged digest byte — or a forged intermediate chunk byte — kills the
# proof at the verifier.  Layout:
#   ecr         crypto-row flag (= b2 + b0*b1 of the io block bits)
#   cidx        running crypto-row index (exclusive prefix count)
#   na0..na7    one-hot: number of active read slots this chunk
#   pad         8*nc - chunk_len, in [0, 8) (lookup channel, coeff 128)
#   crc1..crc6  read-slot key carry bits (slot i key = base + 7cblk + i)
#   cwc1..cwc3  write-slot key carry bits
#   crb[7][8]   read-slot cell bytes (zero on inactive slots)
#   cwo[4][8]   write-slot OLD cell bytes (pre-digest contents)
#   cwd[4][8]   digest bytes (final chunk row only)
#   cblk, more, crem   chain bookkeeping (above)
CR_BASE = IO_BASE + 7
COL_ECR = CR_BASE
COL_CIDX = CR_BASE + 1
COL_CNA0 = CR_BASE + 2            # 8 one-hot columns
COL_CPAD = CR_BASE + 10
COL_CRC1 = CR_BASE + 11           # 6 read carry bits (slots 1..6)
COL_CWC1 = CR_BASE + 17           # 3 write carry bits (slots 1..3)
COL_CRB0 = CR_BASE + 20           # 7 x 8 read-slot bytes
COL_CWO0 = CR_BASE + 76           # 4 x 8 write-slot old bytes
COL_CWD0 = CR_BASE + 108          # 4 x 8 digest bytes
COL_CBLK = CR_BASE + 140          # chunk index within the chain
COL_CMORE = CR_BASE + 141         # 1 on non-final chunk rows
COL_CREM = CR_BASE + 142          # bytes remaining at this chunk
COL_CRC0 = CR_BASE + 143          # read-slot-0 key carry bit (a later
#                                   chunk's base cell q0 + 7*cblk can
#                                   itself cross the 2^17 key boundary)
N_CRYPTO_COLUMNS = 144
N_COLUMNS = CR_BASE + N_CRYPTO_COLUMNS

CRYPTO_MAX_LEN = 56               # read slots cover <= 7 cells/chunk
CRYPTO_MAX_TOTAL = 1 << 16        # chain completeness cap (64 KB): keeps
#                                   7*cblk + 6 well under 2^17 so the
#                                   slot-key carry stays a single bit
N_READ_SLOTS = 7
N_WRITE_SLOTS = 4


def crypto_digest(num: int, message: bytes) -> bytes:
    """The 32-byte MEMORY IMAGE syscall ``num`` writes at R13 for
    ``message`` — shared by the trace builder and the VERIFIER's tape
    recomputation (prover.crypto_tape_demand).  SHA-256 hashes to 8
    big-endian u32 words which the syscall stores via little-endian
    write_u32 (runtime/crypto.py sha256_hash, crypto.rs:291-294), so its
    image is the digest with each 4-byte group reversed; Poseidon2
    writes its field words little-endian (image == our digest bytes);
    Keccak/Blake3 write raw digest bytes."""
    from ..runtime.crypto import (blake3_digest, keccak256_digest,
                                  sha256_digest)

    if num == 3:
        d = sha256_digest(message)
        return b"".join(d[i:i + 4][::-1] for i in range(0, 32, 4))
    if num == 4:
        from ..ops.poseidon2_ref import poseidon2_sponge_hash_bytes

        words = poseidon2_sponge_hash_bytes(message)
        return b"".join(int(w).to_bytes(4, "little") for w in words)
    if num == 5:
        return keccak256_digest(message)
    if num == 6:
        return blake3_digest(message)
    raise ValueError(f"not a crypto syscall number: {num}")

# Opcodes whose result value is pinned by an AIR constraint.
_OP_ADD, _OP_SUB, _OP_ADDI = 0x00, 0x01, 0x08
_OP_JAL, _OP_JALR = 0x48, 0x49

# Opcodes that write their rd register: everything except stores
# (0x38-0x3B), branches (0x40-0x45), ECALL (0x50) and EBREAK (0x51)
# (dispatch families in execute.rs / interp/columnar.py).
WRITING_OPS = frozenset(
    v for v in OP_VALUES
    if not (0x38 <= v <= 0x3B or 0x40 <= v <= 0x45 or v in (0x50, 0x51)))


def selector_blocks(op_col: np.ndarray, rd_col: np.ndarray):
    """One-hot blocks from the opcode and rd columns: ([n, 50], [n, 16])."""
    sel = (op_col[:, None] == np.asarray(OP_VALUES, dtype=np.uint32)[None, :])
    rd1h = (rd_col[:, None] == np.arange(16, dtype=np.uint32)[None, :])
    return sel.astype(np.uint32), rd1h.astype(np.uint32)


def fill_io_block(out: np.ndarray) -> np.ndarray:
    """Fill the I/O-tape binding block (layout comment at IO_BASE) from
    the opcode and R10 columns, in place.  Honest traces have syscall
    numbers <= 6 (InvalidSyscall raises before a trace row is emitted),
    so the low R10 limb is the full number."""
    is_ec = out[:, 2] == 0x50
    num = np.where(is_ec & (out[:, 24 + 10] == 0), out[:, 8 + 10], 0)
    out[:, COL_IO_B0] = num & 1
    out[:, COL_IO_B1] = (num >> 1) & 1
    out[:, COL_IO_B2] = (num >> 2) & 1
    erd = (is_ec & (num == 1)).astype(np.uint32)
    ewr = (is_ec & (num == 2)).astype(np.uint32)
    out[:, COL_ERD] = erd
    out[:, COL_EWR] = ewr
    out[:, COL_RIDX] = (np.cumsum(erd, dtype=np.uint64) - erd).astype(
        np.uint32)
    out[:, COL_WIDX] = (np.cumsum(ewr, dtype=np.uint64) - ewr).astype(
        np.uint32)
    return out


def trace_to_matrix(trace: Dict[str, np.ndarray], lane: int = 0,
                    program=None) -> np.ndarray:
    """Convert a device trace dict (from TpuInterpreter.run with
    collect_trace=True) into a uint32 [n_valid_rows, N_COLUMNS] matrix."""
    valid = np.nonzero(trace["valid"][:, lane])[0]
    n = len(valid)
    out = np.zeros((n, N_COLUMNS), dtype=np.uint32)

    pc = trace["pc"][valid, lane].astype(np.uint64)
    word = trace["word"][valid, lane].astype(np.uint64)
    out[:, 0] = (pc & _M20).astype(np.uint32)
    out[:, 1] = ((pc >> 20) & _M20).astype(np.uint32)
    out[:, 2] = (word & 0x7F).astype(np.uint32)
    out[:, 3] = ((word >> 7) & 0xF).astype(np.uint32)
    out[:, 4] = ((word >> 11) & 0xF).astype(np.uint32)
    out[:, 5] = ((word >> 15) & 0xF).astype(np.uint32)
    imm = (word >> 15) & 0x1FFFF
    out[:, 6] = (imm & _M20).astype(np.uint32)
    out[:, 7] = (imm >> 20).astype(np.uint32)

    # Canonical value view (see module docstring): accumulated registers
    # pack limbs at 30-bit boundaries, normalized at 20-bit; both map to
    # the same 40-bit value (limb0 + limb1*2^20) mod 2^40.
    regs = trace["regs"][valid, lane].astype(np.uint64)  # [n, 16]
    if "accum_mask" in trace:
        amask = trace["accum_mask"][valid, lane].astype(np.uint32)
        acc = ((amask[:, None] >> np.arange(16, dtype=np.uint32)) & 1) == 1
        val_acc = ((regs & _M30) + ((regs >> 30) << 20)) & _M40
        values = np.where(acc, val_acc, regs & _M40)
    else:
        values = regs & _M40
    out[:, 8:8 + 16] = (values & _M20).astype(np.uint32)
    out[:, 8 + 16:8 + 32] = ((values >> 20) & _M20).astype(np.uint32)

    base = 8 + 32
    maddr = trace["mem_addr"][valid, lane].astype(np.uint64)
    mval = trace["mem_value"][valid, lane].astype(np.uint64)
    mvalid = trace["mem_valid"][valid, lane]
    out[:, base] = np.where(mvalid, maddr & _M20, 0).astype(np.uint32)
    out[:, base + 1] = np.where(mvalid, (maddr >> 20) & _M20, 0).astype(np.uint32)
    out[:, base + 2] = np.where(mvalid, mval & _M20, 0).astype(np.uint32)
    out[:, base + 3] = np.where(mvalid, (mval >> 20) & _M20, 0).astype(np.uint32)
    flags = (
        mvalid.astype(np.uint32)
        | (trace["mem_is_write"][valid, lane].astype(np.uint32) << 1)
        | (trace["mem_width"][valid, lane].astype(np.uint32) << 2)
    )
    out[:, base + 4] = flags

    # AIR helper columns (constraints.py): is_seq marks rows whose pc
    # advances by exactly 4 into the *next committed row* (non-control-flow
    # ops with a successor); pc_carry witnesses the 20-bit limb carry.
    op = out[:, 2]
    sequential = ~(
        ((op >= 0x40) & (op <= 0x45))   # branches
        | (op == 0x48) | (op == 0x49)   # JAL / JALR
        | (op == 0x50) | (op == 0x51)   # ECALL / EBREAK
    )
    if n > 0:
        sequential[-1] = False  # last committed row has no successor
    out[:, base + 5] = sequential.astype(np.uint32)
    # Non-exit ECALL rows also advance pc by 4 (vm.rs:277-279 dispatch
    # then fall-through); their constraint reuses the carry column.
    r10 = values[:, 10]
    s10 = ((r10 & _M20) + ((r10 >> 20) & _M20)).astype(np.uint32)
    ecall_adv = (op == 0x50) & (s10 != 0)
    if n > 0:
        ecall_adv[-1] = False
    carry = (sequential | ecall_adv) & (out[:, 0] + 4 >= (1 << 20))
    out[:, base + 6] = carry.astype(np.uint32)

    # Range-check chunk columns (4 x 10-bit decomposition of deferred
    # ADD/MUL results; zero on rows without a deferral — 0 is in the
    # lookup table, accounted in the multiplicities).
    rc_valid = trace["rc_valid"][valid, lane]
    rc_chunks = trace["rc_chunks"][valid, lane].astype(np.uint32)  # [n, 4]
    for c in range(4):
        out[:, base + 7 + c] = np.where(rc_valid, rc_chunks[:, c], 0)

    # Opcode one-hot selector block + rd one-hot block (decode binding +
    # register-file write consistency; prover/constraints.py).
    sel, rd1h = selector_blocks(out[:, 2], out[:, 3])
    out[:, N_BASE_COLUMNS:N_BASE_COLUMNS + N_OPS] = sel
    out[:, N_BASE_COLUMNS + N_OPS:N_DECODE_COLUMNS] = rd1h

    # --- ALU result-binding witness block (module docstring) ---
    b0 = N_DECODE_COLUMNS
    rs1 = out[:, 4]
    rs2 = out[:, 5]
    out[:, b0:b0 + 16] = (
        rs1[:, None] == np.arange(16, dtype=np.uint32)[None, :])
    out[:, b0 + 16:b0 + 32] = (
        rs2[:, None] == np.arange(16, dtype=np.uint32)[None, :])

    # Immediate decomposition of the raw 17-bit field.
    imm17 = out[:, 6]
    s_bit = imm17 >> 16
    out[:, b0 + 36] = s_bit                       # imm_s
    out[:, b0 + 37] = imm17 & 0x3FF               # imm_q0
    out[:, b0 + 38] = (imm17 >> 10) & 0x3F        # imm_q1
    out[:, b0 + 39] = (imm17 >> 4) & 0x3F         # imm_q0hi

    # Result value + carries.  Operand values are the canonical register
    # view of *this* row (pre-state); the result lands in the next row.
    a = np.take_along_axis(values, rs1[:, None].astype(np.int64), axis=1)[:, 0]
    b = np.take_along_axis(values, rs2[:, None].astype(np.int64), axis=1)[:, 0]
    sext_imm = (imm17.astype(np.uint64)
                + s_bit.astype(np.uint64) * ((1 << 40) - (1 << 17)))
    pc40 = pc & _M40

    next_rd = np.zeros(n, dtype=np.uint64)
    if n > 1:
        rd_idx = out[:-1, 3].astype(np.int64)
        next_rd[:-1] = np.take_along_axis(
            values[1:], rd_idx[:, None], axis=1)[:, 0]

    is_jal = (op == _OP_JAL) | (op == _OP_JALR)
    res = np.select(
        [op == _OP_ADD, op == _OP_SUB, op == _OP_ADDI, is_jal],
        [(a + b) & _M40, (a - b) & _M40, (a + sext_imm) & _M40,
         (pc40 + 4) & _M40],
        default=0,
    )
    writing = np.isin(op, list(WRITING_OPS))
    pinned = ((op == _OP_ADD) | (op == _OP_SUB) | (op == _OP_ADDI) | is_jal)
    res = np.where(pinned, res, np.where(writing, next_rd, 0))

    # Carry/borrow witnesses for the pinned ops (b operand per family).
    a_lo, a_hi = a & _M20, (a >> 20) & _M20
    badd = np.select([op == _OP_ADD, op == _OP_ADDI, is_jal],
                     [b, sext_imm, np.full(n, 4, dtype=np.uint64)], default=0)
    aadd = np.where(is_jal, pc40, a)
    c0_add = ((aadd & _M20) + (badd & _M20)) >> 20
    c1_add = (((aadd >> 20) & _M20) + ((badd >> 20) & _M20) + c0_add) >> 20
    c0_sub = (a_lo < (b & _M20)).astype(np.uint64)
    c1_sub = (a_hi.astype(np.int64) - ((b >> 20) & _M20).astype(np.int64)
              - c0_sub.astype(np.int64) < 0).astype(np.uint64)
    is_sub = op == _OP_SUB
    c0 = np.where(pinned, np.where(is_sub, c0_sub, c0_add), 0)
    c1 = np.where(pinned, np.where(is_sub, c1_sub, c1_add), 0)

    res_lo = (res & _M20).astype(np.uint32)
    res_hi = ((res >> 20) & _M20).astype(np.uint32)
    out[:, b0 + 32] = res_lo
    out[:, b0 + 33] = res_hi
    out[:, b0 + 34] = c0.astype(np.uint32)
    out[:, b0 + 35] = c1.astype(np.uint32)
    out[:, b0 + 40] = res_lo & 0x3FF              # rl0
    out[:, b0 + 41] = res_lo >> 10                # rl1
    out[:, b0 + 42] = res_hi & 0x3FF              # rh0
    out[:, b0 + 43] = res_hi >> 10                # rh1

    # --- Control-flow block: taken / target carries / JALR LSB ---
    # taken is the branch *predicate* itself (the AIR derives it from the
    # operands, so it must match even when the target equals pc + 4).
    cf = N_ALU_COLUMNS
    is_branch = (op >= 0x40) & (op <= 0x45)
    # B-type operands ride the rd/rs1 bitfields (encoding.rs:142-159):
    # the machine compares reg[rd-field] against reg[rs1-field].
    rd_op = np.take_along_axis(
        values, out[:, 3][:, None].astype(np.int64), axis=1)[:, 0]
    bx = np.where(is_branch, rd_op, a)
    by = np.where(is_branch, a, b)
    eq_xy = bx == by
    ltu_xy = bx < by
    lts_xy = (bx ^ (1 << 39)) < (by ^ (1 << 39))
    taken = is_branch & np.select(
        [op == 0x40, op == 0x41, op == 0x42,
         op == 0x43, op == 0x44, op == 0x45],
        [eq_xy, ~eq_xy, lts_xy, ~lts_xy, ltu_xy, ~ltu_xy],
        default=False)
    out[:, cf] = taken.astype(np.uint32)

    # Target value per family (same sext(imm) limbs as ADDI).
    i_lo = (imm17 + s_bit * ((1 << 20) - (1 << 17))).astype(np.uint64)
    i_hi = (s_bit * ((1 << 20) - 1)).astype(np.uint64)
    pc_lo = pc40 & _M20
    pc_hi = (pc40 >> 20) & _M20
    t_lo_sum = np.select(
        [is_branch & taken, is_branch & ~taken,
         op == _OP_JAL, op == _OP_JALR],
        [pc_lo + i_lo, pc_lo + 4,
         pc_lo + 16 * imm17.astype(np.uint64) + rs1.astype(np.uint64),
         (a & _M20) + i_lo],
        default=0)
    # JALR clears the target LSB before it becomes the next pc.
    b_lsb = np.where(op == _OP_JALR, t_lo_sum & 1, 0)
    t_lo_sum = t_lo_sum - b_lsb
    c2 = t_lo_sum >> 20                           # in {0, 1, 2}
    t_hi_sum = np.select(
        [is_branch & taken, is_branch, op == _OP_JAL, op == _OP_JALR],
        [pc_hi + i_hi + c2, pc_hi + c2,
         pc_hi + s_bit.astype(np.uint64) * 0xFFFFE + c2,
         ((a >> 20) & _M20) + i_hi + c2],
        default=0)
    c3 = (t_hi_sum >> 20) & 1
    is_cf = is_branch | (op == _OP_JAL) | (op == _OP_JALR)

    # --- Memory-op binding: address carries + chunks, SW truncation ---
    # S-type encoding puts the base register in the rd bitfield and the
    # value register in the rs1 bitfield (encoding.rs:142-159), so the
    # store base operand reads through the rd one-hot and the store value
    # IS the a operand.
    is_load = (op >= 0x30) & (op <= 0x35)
    is_store = (op >= 0x38) & (op <= 0x3B)
    base_val = np.where(is_store, rd_op, a)
    maddr_lo = out[:, 40].astype(np.uint64)
    mc2 = ((base_val & _M20) + i_lo - maddr_lo) >> 20      # {0, 1}
    mc3_sum = ((base_val >> 20) & _M20) + i_hi + mc2
    mc3 = (mc3_sum >> 20) & 1
    is_mem = is_load | is_store
    out[:, cf + 1] = np.where(is_cf, c2, np.where(is_mem, mc2, 0)) \
        .astype(np.uint32)
    out[:, cf + 2] = np.where(is_cf, c3, np.where(is_mem, mc3, 0)) \
        .astype(np.uint32)
    out[:, cf + 3] = b_lsb.astype(np.uint32)

    mb = N_CF_COLUMNS
    out[:, mb + 0] = out[:, 40] & 0x3FF           # al0
    out[:, mb + 1] = out[:, 40] >> 10             # al1
    out[:, mb + 2] = out[:, 41] & 0x3FF           # ah0
    out[:, mb + 3] = out[:, 41] >> 10             # ah1
    mval_hi = out[:, 43].astype(np.uint64)
    tw = np.where(op == 0x3A,
                  (((a >> 20) & _M20) - mval_hi) >> 12, 0)
    out[:, mb + 4] = tw.astype(np.uint32)
    is_sw = op == 0x3A
    out[:, COL_SW_MH0] = np.where(is_sw, mval_hi & 0x3FF, 0) \
        .astype(np.uint32)
    out[:, COL_SW_MH1] = np.where(is_sw, mval_hi >> np.uint64(10), 0) \
        .astype(np.uint32)

    # --- Memory byte-level witness block (all widths) ---
    # Offsets/cell key from the bound address; old/new cell bytes by
    # replaying the op log against the initial memory image (zeros, or
    # the public program's code+data when ``program`` is given — required
    # whenever the trace reads the code/data segments).
    mrows = np.nonzero(is_mem & (mvalid != 0))[0]
    off = (maddr & 7).astype(np.uint64)
    q = ((maddr >> 3) & ((1 << 17) - 1)).astype(np.uint64)
    out[:, COL_MO0:COL_MO0 + 8] = (
        is_mem[:, None] & (off[:, None] == np.arange(8, dtype=np.uint64)))
    out[:, COL_MQA] = np.where(is_mem, q & 0x3FF, 0).astype(np.uint32)
    out[:, COL_MQB] = np.where(is_mem, q >> np.uint64(10), 0) \
        .astype(np.uint32)

    cells: Dict[int, int] = {}

    def initial_cell(cell_addr: int) -> int:
        if program is None:
            return 0
        base = cell_addr * 8
        code_bytes = len(program.code) * 4
        data_base = CODE_BASE + code_bytes
        value = 0
        for j in range(8):
            byte_addr = base + j
            if CODE_BASE <= byte_addr < data_base:
                k = byte_addr - CODE_BASE
                byte = (program.code[k // 4] >> (8 * (k % 4))) & 0xFF
            elif data_base <= byte_addr < data_base + len(program.data):
                byte = program.data[byte_addr - data_base]
            else:
                byte = 0
            value |= byte << (8 * j)
        return value

    widths = trace["mem_width"][valid, lane].astype(np.int64)
    is_w = trace["mem_is_write"][valid, lane].astype(bool)

    # Crypto syscall rows interleave with loads/stores in the replay:
    # their reads see prior stores, later loads see their digest writes.
    r10v = values[:, 10]
    crows = set(np.nonzero((op == 0x50) & (r10v >= 3) & (r10v <= 6))[0]
                .tolist())

    def cell_value(cell: int) -> int:
        got = cells.get(cell)
        return initial_cell(cell) if got is None else got

    # Multi-block chains: extra chunk rows (j >= 1) per long crypto
    # syscall, inserted by the expansion pass below the main loop.
    chain_extra: Dict[int, list] = {}

    def apply_chunk(row: np.ndarray, f: Dict[str, int]) -> None:
        row[COL_ECR] = 1
        row[COL_CNA0:COL_CNA0 + 8] = 0
        row[COL_CNA0 + f["nc"]] = 1
        row[COL_CPAD] = f["pad"]
        row[COL_CBLK] = f["cblk"]
        row[COL_CMORE] = f["more"]
        row[COL_CREM] = f["crem"]
        row[COL_CRC0] = f["crc0"]
        row[COL_CRC1:COL_CRC1 + N_READ_SLOTS - 1] = f["crc"]
        row[COL_CWC1:COL_CWC1 + N_WRITE_SLOTS - 1] = f["cwc"]
        row[COL_CRB0:COL_CRB0 + 56] = f["crb"]
        row[COL_CWO0:COL_CWO0 + 32] = f["cwo"]
        row[COL_CWD0:COL_CWD0 + 32] = f["cwd"]

    def replay_crypto(i: int) -> None:
        num = int(r10v[i])
        ptr = int(values[i, 11])
        ln = int(values[i, 12])
        out_ptr = int(values[i, 13])
        if ln > CRYPTO_MAX_TOTAL:
            raise ValueError(
                f"crypto syscall at trace row {i} hashes {ln} bytes; the "
                f"provable domain is len <= {CRYPTO_MAX_TOTAL} (the "
                "runtime still executes it — documented completeness "
                "limit)")
        if (ln > 0 and ptr % 8) or out_ptr % 8:
            raise ValueError(
                f"crypto syscall at trace row {i} uses unaligned "
                f"ptr={ptr:#x}/out={out_ptr:#x}; the provable domain "
                "requires 8-byte alignment (documented completeness limit)")
        n_chunks = max(1, -(-ln // CRYPTO_MAX_LEN))
        base_cell = ptr >> 3
        q0 = base_cell & 0x1FFFF
        msg = bytearray()
        nc_total = (ln + 7) // 8
        for s in range(nc_total):
            msg += int(cell_value(base_cell + s)).to_bytes(8, "little")
        digest = crypto_digest(num, bytes(msg[:ln]))

        def chunk_fields(j: int) -> Dict[str, int]:
            last = j == n_chunks - 1
            nc_j = (nc_total - 7 * j) if last else 7
            len_j = (ln - 56 * j) if last else 56
            f = {"ecr": 1, "nc": nc_j, "pad": 8 * nc_j - len_j,
                 "cblk": j, "more": 0 if last else 1,
                 "crem": ln - 56 * j, "crb": [0] * 56,
                 "crc0": 1 if (nc_total and q0 + 7 * j >= (1 << 17))
                 else 0,
                 "crc": [0] * (N_READ_SLOTS - 1),
                 "cwo": [0] * 32, "cwd": [0] * 32,
                 "cwc": [0] * (N_WRITE_SLOTS - 1)}
            for s in range(nc_j):
                off = 7 * j + s
                if s >= 1:
                    f["crc"][s - 1] = 1 if q0 + off >= (1 << 17) else 0
                cv = int.from_bytes(msg[8 * off: 8 * off + 8], "little")
                for b in range(8):
                    f["crb"][8 * s + b] = (cv >> (8 * b)) & 0xFF
            if last:
                w_cell = out_ptr >> 3
                wq0 = w_cell & 0x1FFFF
                for s in range(N_WRITE_SLOTS):
                    old = cell_value(w_cell + s)
                    new = int.from_bytes(digest[8 * s: 8 * s + 8],
                                         "little")
                    if s >= 1:
                        f["cwc"][s - 1] = 1 if wq0 + s >= (1 << 17) else 0
                    for b in range(8):
                        f["cwo"][8 * s + b] = (old >> (8 * b)) & 0xFF
                        f["cwd"][8 * s + b] = (new >> (8 * b)) & 0xFF
                    cells[w_cell + s] = new
            return f

        apply_chunk(out[i], chunk_fields(0))
        if n_chunks > 1:
            chain_extra[i] = [chunk_fields(j) for j in range(1, n_chunks)]

    for i in sorted(set(mrows.tolist()) | crows):
        if i in crows:
            replay_crypto(i)
            continue
        cell = int(maddr[i]) >> 3
        o = int(off[i])
        old = cell_value(cell)
        if is_w[i]:
            w8 = int(widths[i])
            val = int(mval[i]) & ((1 << (8 * min(w8, 8))) - 1)
            keep = ~((((1 << (8 * w8)) - 1)) << (8 * o)) & ((1 << 64) - 1)
            new = (old & keep) | (val << (8 * o))
        else:
            new = old
        cells[cell] = new
        for j in range(8):
            out[i, COL_OB0 + j] = (old >> (8 * j)) & 0xFF
            out[i, COL_NB0 + j] = (new >> (8 * j)) & 0xFF

    # Crypto block defaults: non-crypto rows carry the nc=0 one-hot
    # (na_0 = 1, all slot columns zero); cidx is the exclusive prefix
    # count of crypto rows (transition cidx' = cidx + ecr from 0).
    not_cr = np.ones(n, dtype=bool)
    if crows:
        not_cr[sorted(crows)] = False
    out[not_cr, COL_CNA0] = 1
    ecr_col = out[:, COL_ECR]
    out[:, COL_CIDX] = (np.cumsum(ecr_col, dtype=np.uint64)
                        - ecr_col).astype(np.uint32)

    # Store-value byte decomposition of the 40-bit va operand.
    a_hi_full = ((a >> 20) & _M20).astype(np.uint64)
    st = is_store
    out[:, COL_SB0] = np.where(st, a & 0xFF, 0).astype(np.uint32)
    out[:, COL_SB1] = np.where(st, (a >> np.uint64(8)) & 0xFF, 0) \
        .astype(np.uint32)
    out[:, COL_SNL] = np.where(st, (a >> np.uint64(16)) & 0xF, 0) \
        .astype(np.uint32)
    out[:, COL_SNH] = np.where(st, a_hi_full & 0xF, 0).astype(np.uint32)
    out[:, COL_SB3] = np.where(st, (a >> np.uint64(24)) & 0xFF, 0) \
        .astype(np.uint32)
    out[:, COL_SB4] = np.where(st, (a >> np.uint64(32)) & 0xFF, 0) \
        .astype(np.uint32)

    # Sign-extension witnesses from the SELECTED old bytes.
    ob = out[:, COL_OB0:COL_OB0 + 8].astype(np.uint64)
    oidx = np.minimum(off, 7).astype(np.int64)
    b_sel = np.take_along_axis(ob, oidx[:, None], axis=1)[:, 0]
    b_sel1 = np.take_along_axis(
        ob, np.minimum(oidx + 1, 7)[:, None], axis=1)[:, 0]
    b_sel2 = np.take_along_axis(
        ob, np.minimum(oidx + 2, 7)[:, None], axis=1)[:, 0]
    h_sel = b_sel + 256 * b_sel1
    is_lb = op == 0x30
    is_lh = op == 0x32
    ms = np.where(is_lb, b_sel >> np.uint64(7),
                  np.where(is_lh, h_sel >> np.uint64(15), 0))
    out[:, COL_MS] = ms.astype(np.uint32)
    out[:, COL_MCB] = np.where(is_lb, b_sel & 0x7F, 0).astype(np.uint32)
    hc = np.where(is_lh, h_sel & 0x7FFF, 0)
    out[:, COL_MCH0] = (hc & 0x3FF).astype(np.uint32)
    out[:, COL_MCH1] = (hc >> np.uint64(10)).astype(np.uint32)
    # LW/LD: nibble split of the third selected byte at the limb boundary.
    is_lwld = (op == 0x34) | (op == 0x35)
    out[:, COL_MLNIB] = np.where(is_lwld, b_sel2 & 0xF, 0) \
        .astype(np.uint32)
    out[:, COL_MHNIB] = np.where(is_lwld, b_sel2 >> np.uint64(4), 0) \
        .astype(np.uint32)

    # Exec clk = row index (padding rows continue it in _pad_rows).
    out[:, COL_CLK] = np.arange(n, dtype=np.uint32)

    # --- Compare / branch-condition / cmov block ---
    out[:, COL_VA_LO] = (a & _M20).astype(np.uint32)
    out[:, COL_VA_HI] = ((a >> 20) & _M20).astype(np.uint32)
    out[:, COL_VB_LO] = (b & _M20).astype(np.uint32)
    out[:, COL_VB_HI] = ((b >> 20) & _M20).astype(np.uint32)
    out[:, COL_VG_LO] = (rd_op & _M20).astype(np.uint32)
    out[:, COL_VG_HI] = ((rd_op >> 20) & _M20).astype(np.uint32)

    # cx/cy are the family's compare operands: compares (a, b), branches
    # (rd-field, rs1-field) = (bx, by); cmov uses cu = b directly.
    is_cmp = (op >= 0x20) & (op <= 0x25)
    is_cmpbr = is_cmp | is_branch
    is_cmovf = (op >= 0x26) & (op <= 0x28)
    cx = np.where(is_cmpbr, bx, 0)
    cy = np.where(is_cmpbr, by, 0)
    cu = np.where(is_cmpbr, (cx - cy) & _M40,
                  np.where(is_cmovf, b, 0))
    cu_lo = (cu & _M20).astype(np.uint32)
    cu_hi = ((cu >> 20) & _M20).astype(np.uint32)
    out[:, COL_CU_LO] = cu_lo
    out[:, COL_CU_HI] = cu_hi
    cb0 = (is_cmpbr & ((cx & _M20) < (cy & _M20))).astype(np.int64)
    cb1 = (is_cmpbr & (((cx >> 20) & _M20).astype(np.int64)
                       - ((cy >> 20) & _M20).astype(np.int64) - cb0 < 0))
    out[:, COL_CB0] = cb0.astype(np.uint32)
    out[:, COL_CB1] = cb1.astype(np.uint32)
    out[:, COL_CCH0 + 0] = cu_lo & 0x3FF
    out[:, COL_CCH0 + 1] = cu_lo >> 10
    out[:, COL_CCH0 + 2] = cu_hi & 0x3FF
    out[:, COL_CCH0 + 3] = cu_hi >> 10
    s_val = (cu_lo + cu_hi).astype(np.uint32)
    out[:, COL_CEQ] = (s_val == 0).astype(np.uint32)
    out[:, COL_CINV] = _m31_inv_np(s_val)
    cx_hi = ((cx >> 20) & _M20).astype(np.uint32)
    cy_hi = ((cy >> 20) & _M20).astype(np.uint32)
    sa = ((cx >> 39) & 1).astype(np.uint32)
    sb = ((cy >> 39) & 1).astype(np.uint32)
    out[:, COL_SA] = sa
    out[:, COL_AR0] = cx_hi & 0x3FF
    out[:, COL_AR1] = (cx_hi >> 10) & 0x1FF
    out[:, COL_SB] = sb
    out[:, COL_BR0] = cy_hi & 0x3FF
    out[:, COL_BR1] = (cy_hi >> 10) & 0x1FF
    out[:, COL_X1] = out[:, COL_CB1] ^ sa

    # --- Halt-chain block: exit-ECALL detection gadget ---
    is_ecall_row = op == 0x50
    out[:, COL_EEX] = (is_ecall_row & (s10 == 0)).astype(np.uint32)
    out[:, COL_EINV] = np.where(is_ecall_row, _m31_inv_np(s10), 0)

    # --- Logical block witnesses (layout comment at LG_BASE) ---
    is_logr = (op >= 0x10) & (op <= 0x12)
    is_logi = (op >= 0x13) & (op <= 0x15)
    is_log = is_logr | is_logi
    la = np.where(is_log, a, 0)
    lb = np.where(is_logi, sext_imm, np.where(is_logr, b, 0))
    lc = la & lb
    out[:, COL_LG_C_LO] = (lc & _M20).astype(np.uint32)
    out[:, COL_LG_C_HI] = ((lc >> np.uint64(20)) & _M20).astype(np.uint32)
    for k in range(8):
        sh5 = np.uint64(5 * k)
        out[:, COL_LG_A0 + k] = ((la >> sh5) & 0x1F).astype(np.uint32)
        out[:, COL_LG_B0 + k] = ((lb >> sh5) & 0x1F).astype(np.uint32)
        out[:, COL_LG_C0 + k] = ((lc >> sh5) & 0x1F).astype(np.uint32)

    # --- Shift block witnesses (layout comment at SH_BASE) ---
    is_shr3 = (op >= 0x18) & (op <= 0x1A)
    is_shi3 = (op >= 0x1B) & (op <= 0x1D)
    is_shf = is_shr3 | is_shi3
    is_sll = (op == 0x18) | (op == 0x1B)
    is_srl = (op == 0x19) | (op == 0x1C)
    is_sra = (op == 0x1A) | (op == 0x1D)
    src = np.where(is_shr3, b & _M20, np.where(is_shi3, i_lo, 0))
    s_raw = src & np.uint64(63)
    shq = src >> np.uint64(6)
    z_sh = shq == 0
    # Register shifts mask mod 64 (shq is just the discarded high bits);
    # only immediate shifts >= 64 take the shift-63 fallback.
    s_eff = np.where(is_shf, np.where(is_shr3 | z_sh, s_raw, 63), 0)
    out[:, COL_SH_S] = s_raw.astype(np.uint32)
    out[:, COL_SH_SEFF] = s_eff.astype(np.uint32)
    out[:, COL_SH_SHQ] = shq.astype(np.uint32)
    out[:, COL_SH_SHQC0] = (shq & 0x3FF).astype(np.uint32)
    out[:, COL_SH_SHQC1] = (shq >> np.uint64(10)).astype(np.uint32)
    out[:, COL_SH_Z] = z_sh.astype(np.uint32)
    out[:, COL_SH_ZINV] = _m31_inv_np(shq.astype(np.uint32))
    d_sh = np.where(s_eff < 40, s_eff // np.uint64(10), np.uint64(4))
    # Non-shift rows default to the shift table's row 0: (0, d=0, pm=1).
    for j in range(5):
        out[:, COL_SH_D0 + j] = ((d_sh == j) & (is_shf | (j == 0))) \
            .astype(np.uint32)
    pm = np.where(s_eff < 40,
                  (np.uint64(1) << (s_eff % np.uint64(10))), np.uint64(0))
    out[:, COL_SH_PM] = np.where(is_shf, pm, 1).astype(np.uint32)
    # SRA dividend = conditional 40-bit complement of a; SRL uses a as-is.
    sa_sh = ((a >> np.uint64(39)) & 1).astype(np.uint64)
    xd = np.where(is_sra & (sa_sh == 1), _M40 ^ a, a)
    is_srx = is_srl | is_sra
    out[:, COL_SH_XD_LO] = np.where(is_srx, xd & _M20, 0).astype(np.uint32)
    out[:, COL_SH_XD_HI] = np.where(is_srx, (xd >> np.uint64(20)) & _M20,
                                    0).astype(np.uint32)
    # SRA rows reuse the compare block's sign decomposition of va.
    a_hi20 = ((a >> np.uint64(20)) & _M20).astype(np.uint32)
    out[:, COL_SA] = np.where(is_sra, sa_sh.astype(np.uint32),
                              out[:, COL_SA])
    out[:, COL_AR0] = np.where(is_sra, a_hi20 & 0x3FF, out[:, COL_AR0])
    out[:, COL_AR1] = np.where(is_sra, (a_hi20 >> 10) & 0x1FF,
                               out[:, COL_AR1])
    # The ungated x1 = cb1 XOR sa pin must track the overridden sa.
    out[:, COL_X1] = np.where(is_sra, out[:, COL_CB1] ^ out[:, COL_SA],
                              out[:, COL_X1])

    # --- Multiply/divide block witnesses (layout comment at MD_BASE; the
    # shift family rides the same multiplier/divider with y = 2^s_eff) ---
    is_mulf = (op == 0x02) | (op == 0x03)
    is_divf = (op >= 0x04) & (op <= 0x07)
    is_md = is_mulf | is_divf | is_shf
    if np.any(is_md):
        res64 = (out[:, N_DECODE_COLUMNS + 32].astype(np.uint64)
                 | (out[:, N_DECODE_COLUMNS + 33].astype(np.uint64) << 20))
        pw = np.where(is_shf & (s_eff < 40),
                      np.uint64(1) << s_eff, np.uint64(0))
        bb = np.where(b == 0, 1, b)  # div0 rows fault before committing
        pw1 = np.where(pw == 0, 1, pw)
        q = np.where(is_divf, a // bb, np.where(is_srx, xd // pw1, 0))
        r = np.where(is_divf, a % bb,
                     np.where(is_srx & (pw != 0), xd % pw1, 0))
        q = np.where(is_srx & (pw == 0), 0, q)
        x = np.where(is_mulf | is_sll, a, q)
        y = np.where(is_mulf | is_divf, b, np.where(is_shf, pw, 0))
        x = np.where(is_md, x, 0)
        xq = [((x >> np.uint64(10 * i)) & 0x3FF) for i in range(4)]
        yq = [((y >> np.uint64(10 * i)) & 0x3FF) for i in range(4)]
        for i in range(4):
            out[:, COL_XQ0 + i] = xq[i].astype(np.uint32)
            out[:, COL_YQ0 + i] = yq[i].astype(np.uint32)
        # Column sums + carry chain: product chunks without 80-bit ints.
        chunk = []
        k = []
        k_prev = np.zeros(n, dtype=np.uint64)
        for t in range(7):
            s_t = np.zeros(n, dtype=np.uint64)
            for i in range(4):
                j = t - i
                if 0 <= j < 4:
                    s_t += xq[i] * yq[j]
            tot = s_t + k_prev
            chunk.append(tot & 0x3FF)
            k_prev = tot >> np.uint64(10)
            k.append(k_prev)
        # The completeness domain of the 40-bit AIR is the canonical
        # operand view; MULH/DIV on a raw >40-bit register (only LD can
        # produce one) is outside it — fail loudly rather than emit an
        # unprovable matrix.
        prod_lo = (chunk[0] | (chunk[1] << np.uint64(10))
                   | (chunk[2] << np.uint64(20)) | (chunk[3] << np.uint64(30)))
        prod_hi = (chunk[4] | (chunk[5] << np.uint64(10))
                   | (chunk[6] << np.uint64(20)) | (k[6] << np.uint64(30)))
        sra_res = np.where(sa_sh == 1, _M40 ^ q, q)
        want = np.select(
            [op == 0x02, op == 0x03, (op == 0x04) | (op == 0x06),
             (op == 0x05) | (op == 0x07), is_sll, is_srl, is_sra],
            [prod_lo, prod_hi, q, r, prod_lo, q, sra_res],
            default=np.uint64(0))
        bad = is_md & (want != res64)
        if np.any(bad):
            at = int(np.nonzero(bad)[0][0])
            raise ValueError(
                "mul/div row result disagrees with the canonical 40-bit "
                f"operand view at trace row {at} (op {int(op[at]):#x}): "
                "raw >40-bit operands (e.g. via LD) are outside the AIR's "
                "completeness domain")
        out[:, COL_K0] = np.where(is_md, k[0], 0).astype(np.uint32)
        for idx, (cc, bits) in enumerate(
                ((COL_K1C, 1), (COL_K2C, 2), (COL_K3C, 2), (COL_K4C, 2),
                 (COL_K5C, 2), (COL_K6C, 1))):
            kv = np.where(is_md, k[idx + 1], 0)
            out[:, cc] = (kv & 0x3FF).astype(np.uint32)
            hi_bits = kv >> np.uint64(10)
            out[:, cc + 1] = (hi_bits & 1).astype(np.uint32)
            if bits == 2:
                out[:, cc + 2] = (hi_bits >> np.uint64(1)).astype(np.uint32)
        need_pl = (op == 0x03) | is_divf | is_srx
        for i in range(4):
            out[:, COL_PL0 + i] = np.where(need_pl, chunk[i], 0) \
                .astype(np.uint32)
            out[:, COL_DR0 + i] = np.where(
                is_divf | is_srx, (r >> np.uint64(10 * i)) & 0x3FF,
                0).astype(np.uint32)
        # u = y - 1 - r with lo-limb borrow e0 (y = b on the div family,
        # 2^s_eff on SRL/SRA); cd0 = (pl_lo + r_lo) >> 20.  Both gadgets
        # are gated out on s_eff >= 40 shift rows (y = 0).
        live_div = is_divf | (is_srx & (pw != 0))
        ydv = np.where(is_divf, bb, pw1)
        u = np.where(live_div, ydv - 1 - r, 0)
        for i in range(4):
            out[:, COL_U0 + i] = ((u >> np.uint64(10 * i)) & 0x3FF) \
                .astype(np.uint32)
        e0 = live_div & ((ydv & _M20) < (r & _M20) + 1)
        out[:, COL_E0] = e0.astype(np.uint32)
        cd0 = live_div & ((prod_lo & _M20) + (r & _M20) >= (1 << 20))
        out[:, COL_CD0] = cd0.astype(np.uint32)

    # --- Multi-block chain expansion (layout comment at CR_BASE) ---
    # A crypto syscall hashing > 56 bytes becomes ceil(len/56) adjacent
    # chunk rows: continuation rows copy the parent row (pc + registers
    # frozen — exactly what the chain AIR requires) and overwrite only
    # the crypto block; clk and cidx are then recomputed over the
    # expanded row count.
    if chain_extra:
        reps = np.ones(n, dtype=np.int64)
        for i, extras in chain_extra.items():
            reps[i] += len(extras)
        starts = np.cumsum(reps) - reps
        out = np.repeat(out, reps, axis=0)
        for i, extras in chain_extra.items():
            for j, f in enumerate(extras):
                apply_chunk(out[int(starts[i]) + 1 + j], f)
        # Non-final chunk rows keep pc (ec_adv is gated by more); the
        # shared pc-carry column is dead there — zero it.
        out[out[:, COL_CMORE] == 1, 8 + 32 + 6] = 0
        n = out.shape[0]
        out[:, COL_CLK] = np.arange(n, dtype=np.uint32)
        ecr_all = out[:, COL_ECR]
        out[:, COL_CIDX] = (np.cumsum(ecr_all, dtype=np.uint64)
                            - ecr_all).astype(np.uint32)
    return fill_io_block(out)


def _m31_inv_np(x: np.ndarray) -> np.ndarray:
    """Batched M31 inverse on the host (0 -> 0), via the plain torch
    field layer on the CPU."""
    import torch

    from ..ops.field_ops import m31_batch_inv

    a = torch.from_numpy(x.astype(np.int64))
    return m31_batch_inv(a).numpy().astype(np.uint32)
