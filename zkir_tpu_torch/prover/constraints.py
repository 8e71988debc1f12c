"""AIR constraints over the trace matrix and quotient evaluation (torch).

Counterpart of ``zkir_tpu/prover/constraints.py``.  The constraint system
(``air_constraints`` .. ``quotient_terms``) is the reference's code,
copied unchanged: it calls only the algebra object.  The port supplies a
torch ``VecAlg`` for the prover's whole-domain evaluation; ``ScalarAlg``,
``quotient_value_at`` and the divisor tables are host copies.  On CUDA
tensors ``quotient_evals`` runs the counterpart of the reference's jitted
quotient: the terms recorded once and generated as CUDA kernels
(``quotient_codegen.py``); on CPU tensors the eager ``VecAlg`` path, the
reference's CPU branch, is the plain version.

Constraint set:

  single-row (vanishing on all of H, divisor Z_H = x^n - 1):
    S1/S2: r0 value limbs == 0
    S3/S4: is_seq, pc_carry boolean
    opcode decode binding: 50 selector booleans, sum(sel) = 1,
      sum(code_j * sel_j) = opcode  (=> opcode is a valid code and the
      per-op selectors are sound degree-1 polynomials)
    rd / rs1 / rs2 one-hot bindings: 16 booleans each, sum = 1,
      weighted sum = the bitfield column
    carry/borrow/sign booleans: c0, c1, imm_s
    immediate decomposition: imm = q0 + 2^10 q1 + 2^16 s and
      q0 = rs2 + 16 q0hi (pins the overlapping rs2 bitfield); chunk
      ranges forced by the LogUp channels
    result limb decomposition: res_lo = rl0 + 2^10 rl1 (ditto hi) with
      rl*/rh* in the 10-bit table => written register limbs < 2^20
    op-specific result pins (degree 3, operands read via rs1/rs2
      one-hot inner products over this row's register file):
        ADD : a_lo + b_lo = res_lo + 2^20 c0 ;
              a_hi + b_hi + c0 = res_hi + 2^20 c1
        SUB : a_lo - b_lo = res_lo - 2^20 c0 ;
              a_hi - b_hi - c0 = res_hi - 2^20 c1
        ADDI: ADD with b = sext17(imm) limbs
              (imm + s(2^20 - 2^17), s(2^20 - 1))
        JAL/JALR: res = pc + 4 mod 2^40
      Integer-range soundness: all terms < 2^21 << p, so the field
      identity forces the integer identity; res limbs are < 2^20 by the
      chunk lookups, operands are < 2^20 inductively (zero boundary +
      every write goes through res; ECALL/R10 is the documented hole
      until I/O values are public-input-bound).
  transition (divisor Z_trans = Z_H / (x - w_n^{n-1})):
    T1: is_seq * (pc'_lo - pc_lo - 4 + carry * 2^20)
    T2: is_seq * (pc'_hi - pc_hi - carry)
    register-file write consistency, per register r in 1..15 and limb:
      (1 - w * e_r - sel_ECALL) * (reg_r' - reg_r)
      where w = sum of selectors of rd-writing opcodes and the sel_ECALL
      exemption applies to R10 only (the syscall result register).  The
      committed register columns are the canonical value view
      (prover/trace.py), so deferred-model normalization never changes
      them and the only legitimate change is the executed write.
    result binding, per register r in 1..15 and limb:
      w * e_r * (reg_r' - res)  -- the written value IS the committed
      result (which the pins above tie to the operands for
      ADD/SUB/ADDI/JAL/JALR; remaining ops await op-specific pins).
  first-row boundary (divisor Z_first = x - 1):
    registers 1..15 start at zero (both limbs).

Primed columns are next-row values (rotation by 2^log_blowup on the coset
LDE: trace(g_n * x)).  The quotient

    Q(x) = sum_j alpha^j C_j(x) / D_j(x)

is a polynomial of degree < 2n iff every constraint holds (degree <= 3
constraints with blowup 4); it is committed in two degree-< n chunks and
batched into FRI alongside the trace columns.

The is_seq selector is additionally bound to the opcode by the 5th
LogUp channel when range_lookup is on.

Op-semantics coverage (every pin on canonical 40-bit operand views):
ADD/SUB/ADDI/JAL/JALR carry-chain pins; MUL/MULH/DIV/DIVU/REM/REMU via
the shared 10-bit-chunk multiplier (a = q*b + r, r < b); compare family,
branch conditions, and CMOV via the borrow/equality/sign gadgets;
AND/OR/XOR(+I) via the challenge-compressed AND-chunk table
(aux_table.py) with OR/XOR as carry-free linear identities; SLL/SRL/SRA
(+I) via the shift-power table riding the same multiplier (SLL = low
product, SRL/SRA = division by 2^s, SRA through the complement trick);
memory via the byte-level 8-cell UPDATE argument covering EVERY
load/store width (sub-word RMW preservation, sign/zero extension,
code/data-segment initial values as verifier-demanded init rows); halt
chaining.  Remaining gaps (see IMPLEMENTATION_STATUS.md): I/O tape
binding (ECALL R10 results as public inputs), crypto-syscall memory
writes.

Constraints are written ONCE against the algebra interface (VecAlg /
ScalarAlg below) and evaluated both vectorized over the LDE domain
(prover) and scalar at opened points (verifier), so the two sides can
never drift.

Evaluation runs on the *coset* LDE so Z_H is invertible at every committed
point.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..ops.ntt import (
    cm31_add,
    cm31_inv_scalar,
    cm31_mul,
    cm31_mul_scalar,
    cm31_pow_scalar,
    cm31_scale,
    cm31_sub,
    coset_intt,
    ntt,
    root_of_unity,
    _twiddle_table,
)
from ..ops.qm31 import _times_r, qm31_add, qm31_mul, qm31_mul_cm31, \
    qm31_sub

from ..spec.field import M31_PRIME

P = M31_PRIME

from .trace import (N_ALU_COLUMNS, N_CF_COLUMNS, N_COLUMNS,
                    N_DECODE_COLUMNS, N_OPS, OP_VALUES, WRITING_OPS)

# Column indices (see prover/trace.py layout).
COL_PC_LO = 0
COL_PC_HI = 1
COL_RD = 3
COL_RS1 = 4
COL_RS2 = 5
COL_IMM_LO = 6
COL_REG_LO = 8           # 16 reg value-lo columns 8..23
COL_REG_HI = 24          # 16 reg value-hi columns 24..39
COL_R0_LIMB0 = 8
COL_R0_LIMB1 = 24
COL_IS_SEQ = 45
COL_PC_CARRY = 46
COL_CHUNK0 = 47          # 4 range-check chunk columns 47..50
COL_SEL0 = 51            # 50 opcode one-hot selector columns 51..100
COL_RD1H0 = 51 + N_OPS   # 16 rd one-hot columns 101..116
# ALU result-binding block (prover/trace.py docstring).
COL_RS1H0 = N_DECODE_COLUMNS          # 16 rs1 one-hot columns
COL_RS2H0 = N_DECODE_COLUMNS + 16     # 16 rs2 one-hot columns
COL_RES_LO = N_DECODE_COLUMNS + 32
COL_RES_HI = N_DECODE_COLUMNS + 33
COL_CARRY0 = N_DECODE_COLUMNS + 34
COL_CARRY1 = N_DECODE_COLUMNS + 35
COL_IMM_S = N_DECODE_COLUMNS + 36
COL_IMM_Q0 = N_DECODE_COLUMNS + 37
COL_IMM_Q1 = N_DECODE_COLUMNS + 38
COL_IMM_Q0HI = N_DECODE_COLUMNS + 39
COL_RES_CH0 = N_DECODE_COLUMNS + 40   # rl0, rl1, rh0, rh1
# Control-flow block (prover/trace.py): branch/jump pc-target semantics.
COL_TAKEN = N_ALU_COLUMNS
COL_CARRY2 = N_ALU_COLUMNS + 1        # target/address lo carry, in {0,1,2}
COL_CARRY3 = N_ALU_COLUMNS + 2        # target/address hi carry (dropped)
COL_BLSB = N_ALU_COLUMNS + 3          # JALR LSB-clear witness
BRANCH_OPS = tuple(range(0x40, 0x46))
# Memory-op binding block (prover/trace.py): address-limb chunks + SW
# truncation witness.  Memory columns (base layout): 40 addr_lo,
# 41 addr_hi, 42 val_lo, 43 val_hi, 44 flags.
COL_MEM_ADDR_LO = 40
COL_MEM_ADDR_HI = 41
COL_MEM_VAL_LO = 42
COL_MEM_VAL_HI = 43
COL_MEM_FLAGS = 44
COL_MADDR_CH0 = N_CF_COLUMNS          # al0, al1, ah0, ah1
COL_SW_TW = N_CF_COLUMNS + 4
LOAD_OPS = tuple(range(0x30, 0x36))
STORE_OPS = tuple(range(0x38, 0x3C))
ZEXT_LOAD_OPS = (0x31, 0x33, 0x34, 0x35)   # LBU, LHU, LW, LD: res == mval
MEM_WIDTHS = {0x30: 1, 0x31: 1, 0x32: 2, 0x33: 2, 0x34: 4, 0x35: 8,
              0x38: 1, 0x39: 2, 0x3A: 4, 0x3B: 8}
# Memory-consistency block (prover/trace.py): exec clk + the
# (cell, clk)-sorted 8-byte-cell UPDATE table covering every load/store
# width; data/code initial values enter as verifier-demanded clk-0 rows.
from .trace import COL_CLK, M_BASE  # noqa: E402
from .trace import (COL_MO0, COL_MQA, COL_MQB, COL_OB0, COL_NB0,  # noqa: E402
                    COL_SB0, COL_SB1, COL_SNL, COL_SNH, COL_SB3,
                    COL_SB4, COL_MCB, COL_MCH0, COL_MCH1, COL_MS,
                    COL_MLNIB, COL_MHNIB)
# Compare / branch-condition / cmov block (prover/trace.py).
from .trace import (COL_AR0, COL_AR1, COL_BR0, COL_BR1, COL_CB0,  # noqa: E402
                    COL_CB1, COL_CCH0, COL_CD0, COL_CEQ, COL_CINV,
                    COL_CU_HI, COL_CU_LO, COL_DR0, COL_E0, COL_EEX,
                    COL_EINV, COL_K0, COL_K1C, COL_K2C, COL_K3C,
                    COL_K4C, COL_K5C, COL_K6C, COL_PL0, COL_SA, COL_SB,
                    COL_U0, COL_VA_HI, COL_VA_LO, COL_VB_HI, COL_VB_LO,
                    COL_VG_HI, COL_VG_LO, COL_X1, COL_XQ0, COL_YQ0)
from .trace import (COL_LG_A0, COL_LG_B0, COL_LG_C0, COL_LG_C_HI,  # noqa: E402
                    COL_LG_C_LO, COL_SH_D0, COL_SH_PM, COL_SH_S,
                    COL_SH_SEFF, COL_SH_SHQ, COL_SH_SHQC0, COL_SH_SHQC1,
                    COL_SH_XD_HI, COL_SH_XD_LO, COL_SH_Z, COL_SH_ZINV,
                    COL_SW_MH0, COL_SW_MH1)
# I/O-tape binding block (prover/trace.py layout comment at IO_BASE).
from .trace import (COL_ERD, COL_EWR, COL_IO_B0, COL_IO_B1,  # noqa: E402
                    COL_IO_B2, COL_RIDX, COL_WIDX)
# Crypto-syscall binding block (prover/trace.py layout comment at CR_BASE).
from .trace import (COL_CBLK, COL_CIDX, COL_CMORE, COL_CNA0,  # noqa: E402
                    COL_CPAD, COL_CRB0, COL_CRC0, COL_CRC1, COL_CREM,
                    COL_CWC1, COL_CWD0, COL_CWO0, COL_ECR,
                    CRYPTO_MAX_LEN, N_READ_SLOTS, N_WRITE_SLOTS)
N_SLOTS = N_READ_SLOTS + N_WRITE_SLOTS     # 11 memory-demand slots
N_CR_SUMS = N_SLOTS + 2                    # + tape S and F columns
from .aux_table import AUX_AND_BASE, AUX_SHIFT_BASE  # noqa: E402
COMPARE_OPS = tuple(range(0x20, 0x26))   # SLTU SGEU SLT SGE SEQ SNE
CMOV_OPS = (0x26, 0x27, 0x28)            # CMOV CMOVZ CMOVNZ
M_QA = M_BASE                              # cell key: q = qa + 2^10 qb
M_QB = M_BASE + 1
M_AHI = M_BASE + 2
M_CLK = M_BASE + 3                         # clk+1 (exec rows); 0 = init
M_OB0 = M_BASE + 4                         # 8 old cell bytes
M_NB0 = M_BASE + 12                        # 8 new cell bytes
M_REAL = M_BASE + 20
M_SAME = M_BASE + 21
M_HIEQ = M_BASE + 22
M_CHA = M_BASE + 23
M_CHB = M_BASE + 24
M_CHC = M_BASE + 25     # third 10-bit gap chunk: gaps < 2^30 (clk or key)
# Lookup columns appended by the prover when range_lookup is enabled:
COL_TABLE = N_COLUMNS                 # table values t_i
COL_MULT0 = N_COLUMNS + 1             # NUM_LOOKUP multiplicity columns
# With program binding, one more phase-1 column: the program-table
# multiplicity (how often each program row executes; padding rows count
# against the halt entry).  Its partial sum is the LAST sums column.
COL_PROG_M = None                     # = COL_MULT0 + NUM_LOOKUP (below)

OP_ECALL = 0x50
COL_OPCODE = 2

# ----------------------------------------------------------------------
# LogUp channels.  Every channel witness is AFFINE in the committed
# columns: w = const + sum coef_j * col_j (mod p), and must land in the
# 10-bit staircase table [0, 1024).
#
#   chunk0-3   range-check chunk decomposition of deferred values
#   seq        is_seq derivation: 16*op - 1024*(1 - is_seq) in-table
#              iff is_seq == (op < 0x40) (banked opcode numbering)
#   imm_q0     immediate bits [0, 10)
#   imm_q1     16 * (immediate bits [10, 16)) -- forces q1 < 2^6
#   imm_q0hi   16 * (q0 bits [4, 10)) -- forces q0hi < 2^6, pinning the
#              rs2 bitfield via q0 = rs2 + 16*q0hi
#   rl0/rl1/rh0/rh1  10-bit chunks of res_lo/res_hi -- force the written
#              register limbs below 2^20
# ----------------------------------------------------------------------
CHANNELS = (
    ("chunk0", 0, ((COL_CHUNK0 + 0, 1),)),
    ("chunk1", 0, ((COL_CHUNK0 + 1, 1),)),
    ("chunk2", 0, ((COL_CHUNK0 + 2, 1),)),
    ("chunk3", 0, ((COL_CHUNK0 + 3, 1),)),
    ("seq", P - 1024, ((COL_OPCODE, 16), (COL_IS_SEQ, 1024))),
    ("imm_q0", 0, ((COL_IMM_Q0, 1),)),
    ("imm_q1", 0, ((COL_IMM_Q1, 16),)),
    ("imm_q0hi", 0, ((COL_IMM_Q0HI, 16),)),
    ("rl0", 0, ((COL_RES_CH0 + 0, 1),)),
    ("rl1", 0, ((COL_RES_CH0 + 1, 1),)),
    ("rh0", 0, ((COL_RES_CH0 + 2, 1),)),
    ("rh1", 0, ((COL_RES_CH0 + 3, 1),)),
    ("mal0", 0, ((COL_MADDR_CH0 + 0, 1),)),
    ("mal1", 0, ((COL_MADDR_CH0 + 1, 1),)),
    ("mah0", 0, ((COL_MADDR_CH0 + 2, 1),)),
    ("mah1", 0, ((COL_MADDR_CH0 + 3, 1),)),
    ("sw_tw", 0, ((COL_SW_TW, 4),)),           # 4*tw < 2^10 => tw < 2^8
    ("mem_cha", 0, ((M_CHA, 1),)),
    ("mem_chb", 0, ((M_CHB, 1),)),
    ("mem_chc", 0, ((M_CHC, 1),)),
    ("cch0", 0, ((COL_CCH0 + 0, 1),)),
    ("cch1", 0, ((COL_CCH0 + 1, 1),)),
    ("cch2", 0, ((COL_CCH0 + 2, 1),)),
    ("cch3", 0, ((COL_CCH0 + 3, 1),)),
    ("ar0", 0, ((COL_AR0, 1),)),
    ("ar1", 0, ((COL_AR1, 2),)),               # 2*ar1 < 2^10 => ar1 < 2^9
    ("br0", 0, ((COL_BR0, 1),)),
    ("br1", 0, ((COL_BR1, 2),)),
    # Multiply/divide block chunks (trace.py MD_BASE layout).
    ("xq0", 0, ((COL_XQ0 + 0, 1),)),
    ("xq1", 0, ((COL_XQ0 + 1, 1),)),
    ("xq2", 0, ((COL_XQ0 + 2, 1),)),
    ("xq3", 0, ((COL_XQ0 + 3, 1),)),
    ("yq0", 0, ((COL_YQ0 + 0, 1),)),
    ("yq1", 0, ((COL_YQ0 + 1, 1),)),
    ("yq2", 0, ((COL_YQ0 + 2, 1),)),
    ("yq3", 0, ((COL_YQ0 + 3, 1),)),
    ("pl0", 0, ((COL_PL0 + 0, 1),)),
    ("pl1", 0, ((COL_PL0 + 1, 1),)),
    ("pl2", 0, ((COL_PL0 + 2, 1),)),
    ("pl3", 0, ((COL_PL0 + 3, 1),)),
    ("k0", 0, ((COL_K0, 1),)),
    ("k1c", 0, ((COL_K1C, 1),)),
    ("k2c", 0, ((COL_K2C, 1),)),
    ("k3c", 0, ((COL_K3C, 1),)),
    ("k4c", 0, ((COL_K4C, 1),)),
    ("k5c", 0, ((COL_K5C, 1),)),
    ("k6c", 0, ((COL_K6C, 1),)),
    ("dr0", 0, ((COL_DR0 + 0, 1),)),
    ("dr1", 0, ((COL_DR0 + 1, 1),)),
    ("dr2", 0, ((COL_DR0 + 2, 1),)),
    ("dr3", 0, ((COL_DR0 + 3, 1),)),
    ("u0", 0, ((COL_U0 + 0, 1),)),
    ("u1", 0, ((COL_U0 + 1, 1),)),
    ("u2", 0, ((COL_U0 + 2, 1),)),
    ("u3", 0, ((COL_U0 + 3, 1),)),
    # Shift block: shq = shqc0 + 2^10 shqc1 < 2^20 makes the masking
    # decomposition src = s + 64 shq unique; 16*s < 2^10 forces the raw
    # amount below 64.
    ("shqc0", 0, ((COL_SH_SHQC0, 1),)),
    ("shqc1", 0, ((COL_SH_SHQC1, 1),)),
    ("sh_s", 0, ((COL_SH_S, 16),)),
    # SW truncation: mval_hi = swh0 + 2^10 swh1 < 2^12.
    ("sw_mh0", 0, ((COL_SW_MH0, 1),)),
    ("sw_mh1", 0, ((COL_SW_MH1, 256),)),
    # Memory byte block: cell-offset quotient q = qa + 2^10 qb < 2^17,
    # old/new cell bytes < 2^8 (coefficient 4), store-value bytes < 2^8,
    # limb-boundary nibbles < 2^4 (coefficient 64), LB low part < 2^7
    # (coefficient 8), LH low part mch0 + 2^10 mch1 < 2^15 (mch1 < 2^5
    # via coefficient 32).
    ("mqa", 0, ((COL_MQA, 1),)),
    ("mqb", 0, ((COL_MQB, 8),)),
    ("ob0", 0, ((COL_OB0 + 0, 4),)),
    ("ob1", 0, ((COL_OB0 + 1, 4),)),
    ("ob2", 0, ((COL_OB0 + 2, 4),)),
    ("ob3", 0, ((COL_OB0 + 3, 4),)),
    ("ob4", 0, ((COL_OB0 + 4, 4),)),
    ("ob5", 0, ((COL_OB0 + 5, 4),)),
    ("ob6", 0, ((COL_OB0 + 6, 4),)),
    ("ob7", 0, ((COL_OB0 + 7, 4),)),
    ("nb0", 0, ((COL_NB0 + 0, 4),)),
    ("nb1", 0, ((COL_NB0 + 1, 4),)),
    ("nb2", 0, ((COL_NB0 + 2, 4),)),
    ("nb3", 0, ((COL_NB0 + 3, 4),)),
    ("nb4", 0, ((COL_NB0 + 4, 4),)),
    ("nb5", 0, ((COL_NB0 + 5, 4),)),
    ("nb6", 0, ((COL_NB0 + 6, 4),)),
    ("nb7", 0, ((COL_NB0 + 7, 4),)),
    ("sb0", 0, ((COL_SB0, 4),)),
    ("sb1", 0, ((COL_SB1, 4),)),
    ("sb3", 0, ((COL_SB3, 4),)),
    ("sb4", 0, ((COL_SB4, 4),)),
    ("snl", 0, ((COL_SNL, 64),)),
    ("snh", 0, ((COL_SNH, 64),)),
    ("mcb", 0, ((COL_MCB, 8),)),
    ("mch0", 0, ((COL_MCH0, 1),)),
    ("mch1", 0, ((COL_MCH1, 32),)),
    ("mlnib", 0, ((COL_MLNIB, 64),)),
    ("mhnib", 0, ((COL_MHNIB, 64),)),
    # Crypto block: pad < 8 (coefficient 128) makes len = 8*nc - pad a
    # unique decomposition.
    ("cpad", 0, ((COL_CPAD, 128),)),
    # TABLE-side cell-key range: every memory-table row's q = qa + 2^10 qb
    # stays < 2^17 (qa < 2^10, qb < 2^7), so a crypto-slot demand with an
    # out-of-range derived key (q_0 + i ghosting past 2^17 with a wrong
    # carry bit) can never match a table row.
    ("tqa", 0, ((M_QA, 1),)),
    ("tqb", 0, ((M_QB, 8),)),
)
NUM_LOOKUP = len(CHANNELS)
COL_AUXM0 = COL_MULT0 + NUM_LOOKUP

# ----------------------------------------------------------------------
# Challenge-compressed aux-table channels (prover/aux_table.py).  Each
# channel looks up a COMPONENT TRIPLE: the witness triple (w0, w1, w2)
# — every wj an affine combination of trace columns — is compressed as
# w0 + eta*w1 + eta^2*w2 and must be a member (LogUp, shared beta) of
# the similarly compressed preprocessed table triple.  eta is drawn
# after the phase-1 commitment, so matching compressed values forces
# component-wise equality (Schwartz–Zippel over CM31); the chunks need
# no separate range checks.
#
# Spec per channel: (name, (w0_terms, w1_terms, w2_terms), table_base,
# index_terms) where index_terms give the table ROW each honest lookup
# hits (for the multiplicity histogram).
#
#   and0..7   (a_k, b_k, a_k & b_k) 5-bit chunk triples of the logical
#             family; non-logic rows hold (0, 0, 0) = AND-table row 0
#   shift     (s_eff, d, pm): the shift power decomposition; non-shift
#             rows hold (0, 0, 1) = shift-table row 0
# ----------------------------------------------------------------------
AUX_CHANNELS = tuple(
    (f"and{k}",
     (((COL_LG_A0 + k, 1),), ((COL_LG_B0 + k, 1),), ((COL_LG_C0 + k, 1),)),
     AUX_AND_BASE,
     ((COL_LG_A0 + k, 1), (COL_LG_B0 + k, 32)))
    for k in range(8)
) + (
    ("shift",
     (((COL_SH_SEFF, 1),),
      tuple((COL_SH_D0 + j, j) for j in range(1, 5)),
      ((COL_SH_PM, 1),)),
     AUX_SHIFT_BASE,
     ((COL_SH_SEFF, 1),)),
)
NUM_AUX = len(AUX_CHANNELS)
COL_PROG_M = COL_AUXM0 + NUM_AUX

# Program-binding tuple compression: with a transcript challenge gamma,
#     w_row = pc_lo + g*pc_hi + g^2*(op + 2^7 rd + 2^11 rs1) + g^3*imm
# must be a member (LogUp, shared beta) of the preprocessed table
#     t_i = prog_pc_lo + g*prog_pc_hi + g^2*(word & 0x7FFF) + g^3*(word >> 15)
# whose Merkle root the verifier recomputes from the public program.
# Every executed row is therefore a real (pc, instruction) pair of the
# program; padding rows consume the dedicated (0, 0, EBREAK, 0) entry.
PROG_F_TERMS = ((COL_OPCODE, 1), (COL_RD, 1 << 7), (COL_RS1, 1 << 11))

# The is_seq selector is DERIVED from the opcode by the 5th lookup channel:
# with banked opcode numbering, sequential ops are exactly op < 0x40, so
#     w = 16*op - 1024*(1 - is_seq)
# lands in the 10-bit table iff (is_seq = 1 and op < 0x40) or
# (is_seq = 0 and 0x40 <= op < 0x80).  Padding rows carry op = 0x51
# (EBREAK — "a halted machine keeps halting"), keeping them in-table.


def _m31_inv_np(a: np.ndarray) -> np.ndarray:
    """Host inverses mod p of a uint64 array (zero to zero), by Montgomery's
    batch trick over ~sqrt(len) interleaved chains: each step multiplies a
    whole row of chain heads, and only the chains' products are inverted
    by Fermat.  Inverses are unique, so the words equal any other
    inversion's."""
    a = a.astype(np.uint64) % P
    m = a.size
    b = 1 << (max(m - 1, 1).bit_length() // 2)     # chain length
    rows = -(-m // b)
    x = np.ones(rows * b, dtype=np.uint64)
    x[:m] = a.ravel()
    zero = x == 0
    x[zero] = 1
    x = x.reshape(b, rows)             # step j of every chain: row j
    prefix = np.empty_like(x)
    acc = np.ones(rows, dtype=np.uint64)
    for j in range(b):
        prefix[j] = acc
        acc = acc * x[j] % P
    inv = np.ones(rows, dtype=np.uint64)           # 1 / (chain product)
    e = P - 2
    while e:
        if e & 1:
            inv = inv * acc % P
        acc = acc * acc % P
        e >>= 1
    out = np.empty_like(x)
    for j in range(b - 1, -1, -1):
        out[j] = inv * prefix[j] % P
        inv = inv * x[j] % P
    out = out.reshape(-1)
    out[zero.reshape(-1)] = 0
    return out[:m].reshape(a.shape)


def _cm31_inv_np(re: np.ndarray, im: np.ndarray):
    """Host CM31 inverse of uint32/uint64 arrays: conj(a) / |a|^2, the
    norm inverted by ``_m31_inv_np`` (inverses are unique, so this equals
    the reference's device inversion word for word)."""
    re = re.astype(np.uint64)
    im = im.astype(np.uint64)
    ninv = _m31_inv_np((re * re % P + im * im % P) % P)
    return re * ninv % P, (P - im) % P * ninv % P


@functools.lru_cache(maxsize=16)
def _vanishing_tables(log_n: int, log_blowup: int, shift: Tuple[int, int]):
    """1/Z_H, 1/Z_trans, 1/Z_first, 1/Z_last on the coset LDE domain
    (numpy uint32 pairs).

    Z_H(x) = x^n - 1 cycles with period 2^log_blowup on the domain (since
    x_k^n = shift^n * w_b^k with w_b of order blowup; at log_blowup 0, one
    interleaved coset, it is constant); Z_trans divides out the last-row
    factor (x - w_n^{n-1}), so 1/Z_trans = Z_last / Z_H; Z_first = x - 1
    and Z_last = x - w_n^{n-1} are the single-row boundary divisors."""
    n = 1 << log_n
    big = 1 << (log_n + log_blowup)
    blowup = 1 << log_blowup

    shift_n = cm31_pow_scalar(shift, n)
    w_b = root_of_unity(log_blowup)
    zh_cycle = []
    for k in range(blowup):
        val = cm31_mul_scalar(shift_n, cm31_pow_scalar(w_b, k))
        zh_cycle.append(((val[0] - 1) % P, val[1]))
    # zh[k] depends only on k mod blowup: invert the cycle, then tile it
    # into domain order.
    zh_inv = tuple(np.tile(c, big // blowup) for c in _cm31_inv_np(
        np.asarray([v[0] for v in zh_cycle], dtype=np.uint64),
        np.asarray([v[1] for v in zh_cycle], dtype=np.uint64)))

    # x_k = shift * w_N^k over the whole domain.
    twr, twi = _twiddle_table(log_n + log_blowup, inverse=False)
    xr = (twr.astype(np.uint64) * shift[0]
          + (P - twi.astype(np.uint64)) * shift[1]) % P
    xi = (twr.astype(np.uint64) * shift[1]
          + twi.astype(np.uint64) * shift[0]) % P

    last = cm31_pow_scalar(root_of_unity(log_n), n - 1)
    lr = (xr + P - last[0]) % P
    li = (xi + P - last[1]) % P
    fr = (xr + P - 1) % P
    fi = xi.copy()

    zlast_inv = _cm31_inv_np(lr, li)
    ztrans_inv = ((lr * zh_inv[0] % P + (P - li) * zh_inv[1] % P) % P,
                  (lr * zh_inv[1] % P + li * zh_inv[0] % P) % P)
    zfirst_inv = _cm31_inv_np(fr, fi)
    return tuple(a.astype(np.uint32) for a in (
        *zh_inv, *ztrans_inv, *zfirst_inv, *zlast_inv))


# ============================================================================
# Evaluation algebras.  Every constraint is written ONCE against this
# interface and instantiated twice: vectorized over the LDE domain
# (prover) and scalar at one opened row pair (verifier).  A CM31 value is
# a (re, im) pair of int64 tensors (VecAlg) or Python ints (ScalarAlg).
# ============================================================================


class VecAlg:
    """Whole-LDE-domain evaluation: columns are [N] int64 tensors, on the
    device of the committed columns.

    Two value kinds flow through the constraint algebra:

    - CM31 values: ``(re, im)`` pairs — the committed columns' coset
      evaluations and everything the base AIR computes from them;
    - QM31 values: 4-tuples ``(a_re, a_im, b_re, b_im)`` — anything a
      transcript challenge touches (LogUp channels, partial sums).

    The interface is the reference's (``zkir_tpu/prover/constraints.py``
    ``VecAlg``): the trace columns, and for ``range_lookup=True`` proofs
    the committed partial sums (row blocks of the sums LDE) and the
    preprocessed aux and program tables.  The next row of column c is
    index + 2^log_blowup (a roll of the coset LDE by one trace row).
    """

    def __init__(self, ext_r, ext_i, log_blowup, chan_sums=None,
                 mem_sum=None, prog_sum=None, prog_ext=None,
                 aux_ext=None, aux_sums=None, io_sum=None, cr_sums=None):
        self.ext_r, self.ext_i = ext_r, ext_i
        self.big = ext_r.shape[1]
        self.blowup = 1 << log_blowup
        self._chan_sums = chan_sums      # QM31 4-tuple: [NUM_LOOKUP, N]
        self._mem_sum = mem_sum          # (S, F): QM31 4-tuples [N]
        self._prog_sum = prog_sum        # QM31 4-tuple [N]
        self._prog_ext = prog_ext        # (pr, pi): [4, N]
        self._aux_ext = aux_ext          # (ar, ai): [N_AUX_COLS, N]
        self._aux_sums = aux_sums        # QM31 4-tuple: [NUM_AUX, N]
        self._io_sum = io_sum            # (S, F): QM31 4-tuples [N]
        self._cr_sums = cr_sums          # (slots [N_SLOTS, N], S, F)
        # Memoized slices/constants: constraints reuse columns heavily.
        self._col_cache = {}
        self._nxt_cache = {}
        self._const_cache = {}

    def col(self, c):
        if c not in self._col_cache:
            self._col_cache[c] = (self.ext_r[c], self.ext_i[c])
        return self._col_cache[c]

    def nxt(self, c):
        if c not in self._nxt_cache:
            self._nxt_cache[c] = (torch.roll(self.ext_r[c], -self.blowup),
                                  torch.roll(self.ext_i[c], -self.blowup))
        return self._nxt_cache[c]

    def _pair_nxt(self, tup):
        return tuple(torch.roll(c, -self.blowup) for c in tup)

    def scol(self, k):
        return tuple(c[k] for c in self._chan_sums)

    def snxt(self, k):
        return self._pair_nxt(self.scol(k))

    def mcol(self):
        return self._mem_sum[0]

    def mnxt(self):
        return self._pair_nxt(self._mem_sum[0])

    def mfcol(self):
        return self._mem_sum[1]

    def iocol(self):
        return self._io_sum[0]

    def ionxt(self):
        return self._pair_nxt(self._io_sum[0])

    def iofcol(self):
        return self._io_sum[1]

    def crinv(self, s):
        return tuple(c[s] for c in self._cr_sums[0])

    def crcol(self):
        return self._cr_sums[1]

    def crnxt(self):
        return self._pair_nxt(self._cr_sums[1])

    def crfcol(self):
        return self._cr_sums[2]

    def pscol(self):
        return self._prog_sum

    def psnxt(self):
        return self._pair_nxt(self._prog_sum)

    def pcol(self, c):
        pr, pi = self._prog_ext
        return (pr[c], pi[c])

    def acol(self, c):
        ar, ai = self._aux_ext
        return (ar[c], ai[c])

    def ascol(self, k):
        return tuple(c[k] for c in self._aux_sums)

    def asnxt(self, k):
        return self._pair_nxt(self.ascol(k))

    def column_bases(self):
        """Accessor name -> the tensors its components come from: an
        accessor with an argument k returns row k of each, one without
        returns them whole (a next-row accessor rolls its base
        accessor's).  The generated quotient kernels address columns by
        this layout."""
        mem = self._mem_sum or (None, None)
        io = self._io_sum or (None, None)
        cr = self._cr_sums or (None, None, None)
        return {"col": (self.ext_r, self.ext_i), "scol": self._chan_sums,
                "mcol": mem[0], "mfcol": mem[1], "iocol": io[0],
                "iofcol": io[1], "crinv": cr[0], "crcol": cr[1],
                "crfcol": cr[2], "pscol": self._prog_sum,
                "pcol": self._prog_ext, "acol": self._aux_ext,
                "ascol": self._aux_sums}

    # --- QM31 half of the interface (4-tuples of [N] int64 tensors) ---

    def _zeros(self):
        return torch.zeros(self.big, dtype=torch.int64,
                           device=self.ext_r.device)

    def qlift(self, c):
        """Embed a CM31 value into QM31 (b-part zero)."""
        return (c[0], c[1], self._zeros(), self._zeros())

    def qconst(self, v4):
        """Broadcast a QM31 constant (host ints)."""
        return tuple(self._full(x) for x in v4)

    @staticmethod
    def qadd(x, y):
        return qm31_add(x, y)

    @staticmethod
    def qsub(x, y):
        return qm31_sub(x, y)

    @staticmethod
    def qmul(x, y):
        return qm31_mul(x, y)

    def qscale(self, c, v4):
        """CM31 value ``c`` times QM31 constant ``v4`` (2 CM31 products)."""
        a = cm31_mul(c, (int(v4[0]) % P, int(v4[1]) % P))
        b = cm31_mul(c, (int(v4[2]) % P, int(v4[3]) % P))
        return (a[0], a[1], b[0], b[1])

    @staticmethod
    def qmul_c(x, c):
        """QM31 value times CM31 value (componentwise on the u-basis)."""
        return qm31_mul_cm31(x, c)

    def _full(self, v):
        return torch.full((self.big,), int(v) % P, dtype=torch.int64,
                          device=self.ext_r.device)

    def const(self, v):
        if not isinstance(v, tuple):
            v = (v, 0)
        key = (int(v[0]) % P, int(v[1]) % P)
        if key not in self._const_cache:
            self._const_cache[key] = (self._full(key[0]),
                                      self._full(key[1]))
        return self._const_cache[key]

    @staticmethod
    def add(a, b):
        return cm31_add(a, b)

    @staticmethod
    def sub(a, b):
        return cm31_sub(a, b)

    @staticmethod
    def mul(a, b):
        return cm31_mul(a, b)

    def mulc(self, a, v):
        if not isinstance(v, tuple):
            v = (v, 0)
        c = (int(v[0]) % P, int(v[1]) % P)
        if c == (1, 0):
            return a
        if c[1] == 0:
            return cm31_scale(a, c[0])
        return cm31_mul(a, c)     # the constant pair, no [N] tensor of it


class ScalarAlg:
    """Single-point evaluation from opened rows.

    Committed rows INTERLEAVE each CM31 column's (re, im) pair
    (prover._interleave_rows — the layout a column-streaming commit
    produces): trace column c opens at ``row[2c], row[2c+1]``.  The
    sums matrix commits 2*n_sums CM31 columns (QM31 sum k = a-part
    column k plus b-part column n_sums + k); ``scol(k)`` reassembles
    the QM31 4-tuple.  ``prog_row``: the 4-column program-table
    opening, same interleaving.
    """

    def __init__(self, row, next_row, n_cols, s_row=None, s_next=None,
                 n_sums=0, prog_row=None, aux_row=None):
        self.row, self.next_row, self.n_cols = row, next_row, n_cols
        self.s_row, self.s_next, self.n_sums = s_row, s_next, n_sums
        self.prog_row = prog_row
        self.aux_row = aux_row

    def col(self, c):
        return (self.row[2 * c], self.row[2 * c + 1])

    def nxt(self, c):
        return (self.next_row[2 * c], self.next_row[2 * c + 1])

    def _srow(self, arr, k):
        b = self.n_sums + k
        return (arr[2 * k], arr[2 * k + 1], arr[2 * b], arr[2 * b + 1])

    def scol(self, k):
        return self._srow(self.s_row, k)

    def snxt(self, k):
        return self._srow(self.s_next, k)

    def mcol(self):
        return self.scol(NUM_LOOKUP + NUM_AUX)

    def mnxt(self):
        return self.snxt(NUM_LOOKUP + NUM_AUX)

    def mfcol(self):
        return self.scol(NUM_LOOKUP + NUM_AUX + 1)

    def iocol(self):
        return self.scol(NUM_LOOKUP + NUM_AUX + 2)

    def ionxt(self):
        return self.snxt(NUM_LOOKUP + NUM_AUX + 2)

    def iofcol(self):
        return self.scol(NUM_LOOKUP + NUM_AUX + 3)

    # Crypto sums live at indexes [NUM_LOOKUP+NUM_AUX+4, ... + N_CR_SUMS).
    def crinv(self, s):
        return self.scol(NUM_LOOKUP + NUM_AUX + 4 + s)

    def crcol(self):
        return self.scol(NUM_LOOKUP + NUM_AUX + 4 + N_SLOTS)

    def crnxt(self):
        return self.snxt(NUM_LOOKUP + NUM_AUX + 4 + N_SLOTS)

    def crfcol(self):
        return self.scol(NUM_LOOKUP + NUM_AUX + 4 + N_SLOTS + 1)

    def acol(self, c):
        return (self.aux_row[2 * c], self.aux_row[2 * c + 1])

    def ascol(self, k):
        return self.scol(NUM_LOOKUP + k)

    def asnxt(self, k):
        return self.snxt(NUM_LOOKUP + k)

    def pscol(self):
        return self.scol(self.n_sums - 1)

    def psnxt(self):
        return self.snxt(self.n_sums - 1)

    def pcol(self, c):
        return (self.prog_row[2 * c], self.prog_row[2 * c + 1])

    @staticmethod
    def const(v):
        if not isinstance(v, tuple):
            v = (v, 0)
        return (v[0] % P, v[1] % P)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        return cm31_mul_scalar(a, b)

    def mulc(self, a, v):
        return cm31_mul_scalar(a, self.const(v))

    # --- QM31 half of the interface (scalar 4-tuples of ints) ---

    @staticmethod
    def qlift(c):
        return (c[0] % P, c[1] % P, 0, 0)

    @staticmethod
    def qconst(v4):
        return tuple(int(x) % P for x in v4)

    @staticmethod
    def qadd(x, y):
        from ..ops.qm31 import qm31_add_scalar
        return qm31_add_scalar(x, y)

    @staticmethod
    def qsub(x, y):
        from ..ops.qm31 import qm31_sub_scalar
        return qm31_sub_scalar(x, y)

    @staticmethod
    def qmul(x, y):
        from ..ops.qm31 import qm31_mul_scalar
        return qm31_mul_scalar(x, y)

    @staticmethod
    def qscale(c, v4):
        from ..ops.qm31 import qm31_mul_scalar
        return qm31_mul_scalar((c[0], c[1], 0, 0), v4)

    @staticmethod
    def qmul_c(x, c):
        from ..ops.qm31 import qm31_mul_cm31_scalar
        return qm31_mul_cm31_scalar(x, c)


# ============================================================================
# The AIR, written once against the algebra interface.
# ============================================================================


def air_constraints(A):
    """Every machine constraint as (singles, transitions, firsts) lists of
    CM31 values in A's representation.  See the module docstring for the
    constraint-by-constraint soundness argument."""
    add, sub, mul, col, nxt, K = A.add, A.sub, A.mul, A.col, A.nxt, A.const
    mulc = A.mulc
    one = K(1)
    four = K(4)
    two20 = K(1 << 20)

    def boolean(b):
        return mul(b, sub(b, one))

    s_seq = col(COL_IS_SEQ)
    carry = col(COL_PC_CARRY)
    singles = [
        col(COL_R0_LIMB0),
        col(COL_R0_LIMB1),
        boolean(s_seq),
        boolean(carry),
    ]

    # Opcode one-hot decode binding: booleans, sum to 1, weighted sum
    # equals the opcode column (=> opcode is one of the 50 valid codes).
    sel = [col(COL_SEL0 + j) for j in range(N_OPS)]
    for s in sel:
        singles.append(boolean(s))
    sel_sum = sel[0]
    op_sum = mulc(sel[0], OP_VALUES[0])
    for j in range(1, N_OPS):
        sel_sum = add(sel_sum, sel[j])
        op_sum = add(op_sum, mulc(sel[j], OP_VALUES[j]))
    singles.append(sub(sel_sum, one))
    singles.append(sub(op_sum, col(COL_OPCODE)))

    # rd / rs1 / rs2 one-hot bindings.
    def onehot_block(base, field_col):
        blk = [col(base + i) for i in range(16)]
        for bi in blk:
            singles.append(boolean(bi))
        b_sum = blk[0]
        f_sum = mulc(blk[1], 1)
        for i in range(1, 16):
            b_sum = add(b_sum, blk[i])
            if i > 1:
                f_sum = add(f_sum, mulc(blk[i], i))
        singles.append(sub(b_sum, one))
        singles.append(sub(f_sum, col(field_col)))
        return blk

    e = onehot_block(COL_RD1H0, COL_RD)
    e1 = onehot_block(COL_RS1H0, COL_RS1)
    e2 = onehot_block(COL_RS2H0, COL_RS2)

    # Booleans: carries and the immediate sign bit.
    c0 = col(COL_CARRY0)
    c1 = col(COL_CARRY1)
    s_imm = col(COL_IMM_S)
    for bcol in (c0, c1, s_imm):
        singles.append(boolean(bcol))

    # Immediate decomposition: imm = q0 + 2^10 q1 + 2^16 s, q0 = rs2+16q0hi
    # (chunk ranges enforced by the lookup channels).
    q0 = col(COL_IMM_Q0)
    singles.append(sub(
        col(COL_IMM_LO),
        add(add(q0, mulc(col(COL_IMM_Q1), 1 << 10)),
            mulc(s_imm, 1 << 16))))
    singles.append(sub(
        q0, add(col(COL_RS2), mulc(col(COL_IMM_Q0HI), 16))))

    # Result limb decomposition: res = ch0 + 2^10 ch1 per limb.
    res_lo = col(COL_RES_LO)
    res_hi = col(COL_RES_HI)
    for res, c_base in ((res_lo, COL_RES_CH0), (res_hi, COL_RES_CH0 + 2)):
        singles.append(sub(
            res, add(col(c_base), mulc(col(c_base + 1), 1 << 10))))

    # Operand values via one-hot inner product over the register file
    # (degree 2; this row's committed registers are the pre-state).
    def operand(blk, base):
        acc = mul(blk[0], col(base))
        for i in range(1, 16):
            acc = add(acc, mul(blk[i], col(base + i)))
        return acc

    a_lo, a_hi = operand(e1, COL_REG_LO), operand(e1, COL_REG_HI)
    b_lo, b_hi = operand(e2, COL_REG_LO), operand(e2, COL_REG_HI)

    # Op-specific result pins (degree 3): res = a OP b mod 2^40 with
    # carry/borrow bits; see module docstring for the integer-range
    # soundness argument.
    sel_by = {v: sel[j] for j, v in enumerate(OP_VALUES)}
    two17 = (1 << 20) - (1 << 17)

    def pin(selector, lo_expr, hi_expr):
        singles.append(mul(selector, lo_expr))
        singles.append(mul(selector, hi_expr))

    c0_sh = mul(c0, two20)
    c1_sh = mul(c1, two20)
    # ADD: a + b = res + 2^20 c0 (lo); a_hi + b_hi + c0 = res_hi + 2^20 c1.
    pin(sel_by[0x00],
        sub(add(a_lo, b_lo), add(res_lo, c0_sh)),
        sub(add(add(a_hi, b_hi), c0), add(res_hi, c1_sh)))
    # SUB: a - b = res - 2^20 c0 (borrow).
    pin(sel_by[0x01],
        sub(add(a_lo, c0_sh), add(b_lo, res_lo)),
        sub(add(a_hi, c1_sh), add(add(b_hi, c0), res_hi)))
    # ADDI: b = sext17(imm) with limbs (imm + s*(2^20-2^17), s*(2^20-1)).
    i_lo = add(col(COL_IMM_LO), mulc(s_imm, two17))
    i_hi = mulc(s_imm, (1 << 20) - 1)
    pin(sel_by[0x08],
        sub(add(a_lo, i_lo), add(res_lo, c0_sh)),
        sub(add(add(a_hi, i_hi), c0), add(res_hi, c1_sh)))
    # JAL/JALR: rd = pc + 4 mod 2^40.
    sel_jump = add(sel_by[0x48], sel_by[0x49])
    pin(sel_jump,
        sub(add(col(COL_PC_LO), four), add(res_lo, c0_sh)),
        sub(add(col(COL_PC_HI), c0), add(res_hi, c1_sh)))

    # Control-flow witness booleans; the target lo carry c2 is in
    # {0, 1, 2} (JAL's 21-bit offset can carry 2 out of the low limb).
    taken = col(COL_TAKEN)
    c2 = col(COL_CARRY2)
    c3 = col(COL_CARRY3)
    b_lsb = col(COL_BLSB)
    for bcol in (taken, c3, b_lsb):
        singles.append(boolean(bcol))
    singles.append(mul(boolean(c2), sub(c2, K(2))))

    # --- Memory-op binding ---
    # flags = is_mem + 2*is_store + 4*width, all selector-derived.
    def selsum(ops):
        acc = None
        for v in ops:
            acc = sel_by[v] if acc is None else add(acc, sel_by[v])
        return acc

    sel_loads = selsum(LOAD_OPS)
    sel_stores = selsum(STORE_OPS)
    flags_expr = add(sel_loads, mulc(sel_stores, 3))
    for v, width in MEM_WIDTHS.items():
        flags_expr = add(flags_expr, mulc(sel_by[v], 4 * width))
    singles.append(sub(col(COL_MEM_FLAGS), flags_expr))

    # Address-limb decomposition (unique encoding below 2^20).
    maddr_lo = col(COL_MEM_ADDR_LO)
    maddr_hi = col(COL_MEM_ADDR_HI)
    for limb, c_base in ((maddr_lo, COL_MADDR_CH0),
                         (maddr_hi, COL_MADDR_CH0 + 2)):
        singles.append(sub(
            limb, add(col(c_base), mulc(col(c_base + 1), 1 << 10))))

    # Address pin: maddr = base + sext17(imm) mod 2^40.  Loads (I-type)
    # read the base through rs1; stores (S-type) through the rd bitfield.
    g_lo, g_hi = operand(e, COL_REG_LO), operand(e, COL_REG_HI)
    c2_sh = mul(c2, two20)
    c3_sh = mul(c3, two20)
    for sel_m, base_lo, base_hi in ((sel_loads, a_lo, a_hi),
                                    (sel_stores, g_lo, g_hi)):
        singles.append(mul(sel_m, add(
            sub(sub(maddr_lo, base_lo), i_lo), c2_sh)))
        singles.append(mul(sel_m, add(
            sub(sub(sub(maddr_hi, base_hi), i_hi), c2), c3_sh)))

    # Value pins.  Zero-extending loads: res == mval.  SD stores the full
    # 40-bit a operand; SW stores a mod 2^32 (truncation witness tw).
    mval_lo = col(COL_MEM_VAL_LO)
    mval_hi = col(COL_MEM_VAL_HI)
    sel_zl = selsum(ZEXT_LOAD_OPS)
    singles.append(mul(sel_zl, sub(res_lo, mval_lo)))
    singles.append(mul(sel_zl, sub(res_hi, mval_hi)))
    singles.append(mul(sel_by[0x3B], sub(a_lo, mval_lo)))
    singles.append(mul(sel_by[0x3B], sub(a_hi, mval_hi)))
    singles.append(mul(sel_by[0x3A], sub(a_lo, mval_lo)))
    singles.append(mul(sel_by[0x3A], sub(
        a_hi, add(mval_hi, mulc(col(COL_SW_TW), 1 << 12)))))
    # mval_hi < 2^12 (chunk channels) makes the tw decomposition unique.
    singles.append(mul(sel_by[0x3A], sub(
        mval_hi, add(col(COL_SW_MH0), mulc(col(COL_SW_MH1), 1 << 10)))))

    # --- Memory byte-level block (all load/store widths) ---
    # Memory is 8-byte cells.  Offset one-hot + cell-quotient
    # decomposition: maddr_lo = 8(qa + 2^10 qb) + sum(i * o_i); the cell
    # key is (q, maddr_hi).
    is_mem_sel = add(sel_loads, sel_stores)
    o = [col(COL_MO0 + i) for i in range(8)]
    for oi in o:
        singles.append(boolean(oi))
    osum = o[0]
    ooff = None
    for i in range(1, 8):
        osum = add(osum, o[i])
        ooff = mulc(o[i], i) if ooff is None else add(ooff, mulc(o[i], i))
    singles.append(sub(osum, is_mem_sel))
    q_expr = add(mulc(col(COL_MQA), 8), mulc(col(COL_MQB), 8 << 10))
    singles.append(sub(maddr_lo, add(q_expr, ooff)))
    singles.append(boolean(col(COL_MS)))

    ob = [col(COL_OB0 + j) for j in range(8)]
    nb = [col(COL_NB0 + j) for j in range(8)]

    # Alignment per width family (misaligned access halts the machine,
    # memory.rs:297-487, so honest traces never contain it).
    sel_w2 = add(sel_by[0x32], add(sel_by[0x33], sel_by[0x39]))  # LH LHU SH
    sel_w4 = add(sel_by[0x34], sel_by[0x3A])                     # LW SW
    sel_w8 = add(sel_by[0x35], sel_by[0x3B])                     # LD SD
    for i in (1, 3, 5, 7):
        singles.append(mul(sel_w2, o[i]))
    for i in (1, 2, 3, 5, 6, 7):
        singles.append(mul(sel_w4, o[i]))
    for i in range(1, 8):
        singles.append(mul(sel_w8, o[i]))

    # Loads leave the cell unchanged.
    for j in range(8):
        singles.append(mul(sel_loads, sub(nb[j], ob[j])))

    # Selected-byte aggregates (degree 2).
    def agg(idxs, f):
        acc = None
        for i in idxs:
            term = mul(o[i], f(i))
            acc = term if acc is None else add(acc, term)
        return acc

    b_sel = agg(range(8), lambda i: ob[i])
    h_sel = agg((0, 2, 4, 6), lambda i: add(ob[i], mulc(ob[i + 1], 256)))
    ms = col(COL_MS)
    mcb = col(COL_MCB)
    # LBU: res = selected byte, zero-extended.
    singles.append(mul(sel_by[0x31], sub(res_lo, b_sel)))
    singles.append(mul(sel_by[0x31], res_hi))
    # LB: b = mcb + 128 ms (mcb < 128 forces ms = the sign bit);
    # res = sign-extend to 40 bits.
    singles.append(mul(sel_by[0x30], sub(b_sel, add(mcb, mulc(ms, 128)))))
    singles.append(mul(sel_by[0x30], sub(
        res_lo, add(add(mcb, mulc(ms, 128)), mulc(ms, (1 << 20) - 256)))))
    singles.append(mul(sel_by[0x30], sub(res_hi, mulc(ms, (1 << 20) - 1))))
    # LHU / LH (h = mch0 + 2^10 mch1 + 2^15 ms, low part < 2^15).
    singles.append(mul(sel_by[0x33], sub(res_lo, h_sel)))
    singles.append(mul(sel_by[0x33], res_hi))
    h_low = add(col(COL_MCH0), mulc(col(COL_MCH1), 1 << 10))
    singles.append(mul(sel_by[0x32], sub(
        h_sel, add(h_low, mulc(ms, 1 << 15)))))
    singles.append(mul(sel_by[0x32], sub(
        res_lo, add(add(h_low, mulc(ms, 1 << 15)),
                    mulc(ms, (1 << 20) - (1 << 16))))))
    singles.append(mul(sel_by[0x32], sub(res_hi, mulc(ms, (1 << 20) - 1))))
    # LW: limbs from the 4 selected bytes, nibble-split at bit 20.
    lnib, hnib = col(COL_MLNIB), col(COL_MHNIB)
    w_lo = agg((0, 4), lambda i: add(ob[i], mulc(ob[i + 1], 256)))
    w_b2 = agg((0, 4), lambda i: ob[i + 2])
    w_b3 = agg((0, 4), lambda i: ob[i + 3])
    singles.append(mul(sel_by[0x34], sub(
        res_lo, add(w_lo, mulc(lnib, 1 << 16)))))
    singles.append(mul(sel_by[0x34], sub(w_b2, add(lnib, mulc(hnib, 16)))))
    singles.append(mul(sel_by[0x34], sub(
        res_hi, add(hnib, mulc(w_b3, 16)))))
    # LD: bytes 0-4 (the register keeps the low 40 bits; bytes 5-7 are
    # read but truncated, execute.rs:477-546 wrapping).
    singles.append(mul(sel_by[0x35], sub(
        res_lo, add(add(ob[0], mulc(ob[1], 256)), mulc(lnib, 1 << 16)))))
    singles.append(mul(sel_by[0x35], sub(ob[2], add(lnib, mulc(hnib, 16)))))
    singles.append(mul(sel_by[0x35], sub(
        res_hi, add(add(hnib, mulc(ob[3], 16)), mulc(ob[4], 1 << 12)))))

    # Store-value byte decomposition of the 40-bit va operand (the value
    # register rides the rs1 bitfield on S-type rows).
    va_lo_c, va_hi_c = col(COL_VA_LO), col(COL_VA_HI)
    sb = [col(COL_SB0), col(COL_SB1),
          add(col(COL_SNL), mulc(col(COL_SNH), 16)),
          col(COL_SB3), col(COL_SB4), None, None, None]
    singles.append(mul(sel_stores, sub(
        va_lo_c, add(add(col(COL_SB0), mulc(col(COL_SB1), 256)),
                     mulc(col(COL_SNL), 1 << 16)))))
    singles.append(mul(sel_stores, sub(
        va_hi_c, add(add(col(COL_SNH), mulc(col(COL_SB3), 16)),
                     mulc(col(COL_SB4), 1 << 12)))))

    # New-cell construction per store family: byte j is replaced when
    # j - off < width, else kept.
    def store_pin(sel_st, width, offsets):
        for j in range(8):
            repl = None
            for i in offsets:
                k = j - i
                if 0 <= k < width:
                    v = sb[k] if sb[k] is not None else None
                    diff = sub(v, ob[j]) if v is not None \
                        else sub(K(0), ob[j])
                    term = mul(o[i], diff)
                    repl = term if repl is None else add(repl, term)
            expr = sub(nb[j], ob[j])
            if repl is not None:
                expr = sub(expr, repl)
            singles.append(mul(sel_st, expr))

    store_pin(sel_by[0x38], 1, range(8))          # SB
    store_pin(sel_by[0x39], 2, (0, 2, 4, 6))      # SH
    store_pin(sel_by[0x3A], 4, (0, 4))            # SW
    store_pin(sel_by[0x3B], 8, (0,))              # SD

    # --- Compare / branch-condition / cmov block ---
    # Committed operand views (degree-1 handles on the inner products).
    va_lo, va_hi = col(COL_VA_LO), col(COL_VA_HI)
    vb_lo, vb_hi = col(COL_VB_LO), col(COL_VB_HI)
    vg_lo, vg_hi = col(COL_VG_LO), col(COL_VG_HI)
    for vcol, expr in ((va_lo, a_lo), (va_hi, a_hi), (vb_lo, b_lo),
                       (vb_hi, b_hi), (vg_lo, g_lo), (vg_hi, g_hi)):
        singles.append(sub(vcol, expr))
    cu_lo, cu_hi = col(COL_CU_LO), col(COL_CU_HI)
    cb0, cb1 = col(COL_CB0), col(COL_CB1)
    cinv, ceq = col(COL_CINV), col(COL_CEQ)
    sa, sb = col(COL_SA), col(COL_SB)
    x1 = col(COL_X1)
    for bcol in (cb0, cb1, sa, sb):
        singles.append(boolean(bcol))
    # cu chunk decomposition (unique below 2^20).
    for limb, c_base in ((cu_lo, COL_CCH0), (cu_hi, COL_CCH0 + 2)):
        singles.append(sub(
            limb, add(col(c_base), mulc(col(c_base + 1), 1 << 10))))
    # Equality gadget on s = cu_lo + cu_hi (< 2^21 < p, so s = 0 iff both
    # limbs are 0 iff the 40-bit difference is 0): ceq = 1 - s*cinv and
    # ceq*s = 0 force ceq = [cu == 0].
    s_eq = add(cu_lo, cu_hi)
    singles.append(sub(add(ceq, mul(s_eq, cinv)), one))
    singles.append(mul(ceq, s_eq))
    # x1 = cb1 XOR sa; lt_signed = x1 XOR sb (sign-XOR trick,
    # value.rs:710-716: flip the unsigned borrow when the signs differ).
    def bxor(p_b, q_b):
        return sub(add(p_b, q_b), mulc(mul(p_b, q_b), 2))

    singles.append(sub(x1, bxor(cb1, sa)))
    lts = bxor(x1, sb)
    # cu pins: cu = x - y mod 2^40 in borrow form, where the compare
    # operands (x, y) are (a, b) for the compare family and
    # (rd-field, rs1-field) for branches (B-type bitfield quirk,
    # encoding.rs:142-159); cmov rows pin cu = b (so ceq = [b == 0], the
    # cmov condition).  Sign decompositions x_hi/y_hi = r0 + 2^10 r1 +
    # 2^19 s (chunk ranges by the lookup channels) extract bit 39.
    sel_cmp = selsum(COMPARE_OPS)
    sel_brf = selsum(BRANCH_OPS)
    sel_cmovf = selsum(CMOV_OPS)
    cb0_sh = mul(cb0, two20)
    cb1_sh = mul(cb1, two20)
    sign_dec_a = add(add(col(COL_AR0), mulc(col(COL_AR1), 1 << 10)),
                     mulc(sa, 1 << 19))
    sign_dec_b = add(add(col(COL_BR0), mulc(col(COL_BR1), 1 << 10)),
                     mulc(sb, 1 << 19))
    for sel_f, x_lo, x_hi, y_lo, y_hi in (
            (sel_cmp, va_lo, va_hi, vb_lo, vb_hi),
            (sel_brf, vg_lo, vg_hi, va_lo, va_hi)):
        singles.append(mul(sel_f, add(
            sub(sub(x_lo, y_lo), cu_lo), cb0_sh)))
        singles.append(mul(sel_f, add(
            sub(sub(sub(x_hi, y_hi), cb0), cu_hi), cb1_sh)))
        singles.append(mul(sel_f, sub(x_hi, sign_dec_a)))
        singles.append(mul(sel_f, sub(y_hi, sign_dec_b)))
    singles.append(mul(sel_cmovf, sub(cu_lo, vb_lo)))
    singles.append(mul(sel_cmovf, sub(cu_hi, vb_hi)))
    # Compare-family result pins: res in {0,1} per the op's predicate
    # (cb1 = unsigned lt, lts = signed lt, ceq = equal).
    singles.append(mul(sel_cmp, res_hi))
    for v, pred, neg in ((0x20, cb1, False), (0x21, cb1, True),
                         (0x22, lts, False), (0x23, lts, True),
                         (0x24, ceq, False), (0x25, ceq, True)):
        want = sub(one, pred) if neg else pred
        singles.append(mul(sel_by[v], sub(res_lo, want)))
    # Branch taken bit DERIVED from the operands (closes control flow:
    # the pc-target transitions consume this bit).
    for v, pred, neg in ((0x40, ceq, False), (0x41, ceq, True),
                         (0x42, lts, False), (0x43, lts, True),
                         (0x44, cb1, False), (0x45, cb1, True)):
        want = sub(one, pred) if neg else pred
        singles.append(mul(sel_by[v], sub(taken, want)))
    # CMOV result pins: res = cond ? a : rd_old with cond = [b != 0]
    # (CMOV/CMOVNZ) or [b == 0] (CMOVZ).  A false condition writes
    # rd_old, matching the no-write semantics (execute.rs:434-474).
    sel_nz = add(sel_by[0x26], sel_by[0x28])
    nceq = sub(one, ceq)
    for selc, cond in ((sel_nz, nceq), (sel_by[0x27], ceq)):
        ncond = sub(one, cond)
        singles.append(mul(selc, sub(
            res_lo, add(mul(cond, va_lo), mul(ncond, vg_lo)))))
        singles.append(mul(selc, sub(
            res_hi, add(mul(cond, va_hi), mul(ncond, vg_hi)))))

    # --- Halt-chain block: exit-ECALL detection gadget ---
    # s10 = r10_lo + r10_hi (< 2^21 < p, zero iff r10 == 0); on ECALL rows
    # eex = [s10 == 0] via eex + s10*einv = 1 and eex*s10 = 0.
    eex = col(COL_EEX)
    einv = col(COL_EINV)
    s10 = add(col(COL_REG_LO + 10), col(COL_REG_HI + 10))
    sel_ec = sel_by[0x50]
    sel_eb = sel_by[0x51]
    singles.append(boolean(eex))
    singles.append(mul(sel_ec, sub(add(eex, mul(s10, einv)), one)))
    singles.append(mul(sel_ec, mul(eex, s10)))


    # --- Logical block (trace.py LG_BASE layout) ---
    # One AND value c (limbs + 5-bit chunks of a, b, c); chunk triples
    # are pinned by the challenge-compressed AND-table channels
    # (aux_channels), so c_k = a_k & b_k with all chunks < 32.  The
    # carry-free identities then pin all six ops limb-wise (every term
    # < 2^22 << p, so the field identities are integer identities):
    #   AND: res = c      OR: res = a + b - c     XOR: res = a + b - 2c
    sel_logr = selsum((0x10, 0x11, 0x12))
    sel_logi = selsum((0x13, 0x14, 0x15))
    sel_log = add(sel_logr, sel_logi)
    lgA = [col(COL_LG_A0 + k) for k in range(8)]
    lgB = [col(COL_LG_B0 + k) for k in range(8)]
    lgC = [col(COL_LG_C0 + k) for k in range(8)]
    c_and = (col(COL_LG_C_LO), col(COL_LG_C_HI))

    def comb5(cs):
        acc5 = cs[0]
        for j, cv in enumerate(cs[1:], 1):
            acc5 = add(acc5, mulc(cv, 1 << (5 * j)))
        return acc5

    for limb, chunks in ((va_lo, lgA[:4]), (va_hi, lgA[4:]),
                         (c_and[0], lgC[:4]), (c_and[1], lgC[4:])):
        singles.append(mul(sel_log, sub(limb, comb5(chunks))))
    for sel_v, blo, bhi in ((sel_logr, vb_lo, vb_hi),
                            (sel_logi, i_lo, i_hi)):
        singles.append(mul(sel_v, sub(blo, comb5(lgB[:4]))))
        singles.append(mul(sel_v, sub(bhi, comb5(lgB[4:]))))
    sel_andf = add(sel_by[0x10], sel_by[0x13])
    singles.append(mul(sel_andf, sub(res_lo, c_and[0])))
    singles.append(mul(sel_andf, sub(res_hi, c_and[1])))
    for v_or, v_xor, blo, bhi in ((0x11, 0x12, vb_lo, vb_hi),
                                  (0x14, 0x15, i_lo, i_hi)):
        singles.append(mul(sel_by[v_or], sub(
            res_lo, sub(add(va_lo, blo), c_and[0]))))
        singles.append(mul(sel_by[v_or], sub(
            res_hi, sub(add(va_hi, bhi), c_and[1]))))
        singles.append(mul(sel_by[v_xor], sub(
            res_lo, sub(add(va_lo, blo), mulc(c_and[0], 2)))))
        singles.append(mul(sel_by[v_xor], sub(
            res_hi, sub(add(va_hi, bhi), mulc(c_and[1], 2)))))

    # Shift-family selectors (constraints follow the muldiv block, whose
    # multiplier the shifts ride with y = 2^s_eff).
    sel_shr3 = selsum((0x18, 0x19, 0x1A))
    sel_shi3 = selsum((0x1B, 0x1C, 0x1D))
    sel_shf = add(sel_shr3, sel_shi3)
    sel_sllf = add(sel_by[0x18], sel_by[0x1B])
    sel_srlf = add(sel_by[0x19], sel_by[0x1C])
    sel_sraf = add(sel_by[0x1A], sel_by[0x1D])
    sel_srx = add(sel_srlf, sel_sraf)

    # --- Multiply/divide block (layout comment in trace.py at MD_BASE) ---
    two10 = K(1 << 10)
    sel_mul, sel_mulh = sel_by[0x02], sel_by[0x03]
    sel_divf = selsum((0x04, 0x05, 0x06, 0x07))
    sel_mulf = add(sel_mul, sel_mulh)
    sel_md = add(sel_mulf, sel_divf)
    xq = [col(COL_XQ0 + i) for i in range(4)]
    yq = [col(COL_YQ0 + i) for i in range(4)]
    pl = [col(COL_PL0 + i) for i in range(4)]
    dr = [col(COL_DR0 + i) for i in range(4)]
    uc = [col(COL_U0 + i) for i in range(4)]

    def comb2(c0v, c1v):
        return add(c0v, mul(c1v, two10))

    xq_lo, xq_hi = comb2(xq[0], xq[1]), comb2(xq[2], xq[3])
    yq_lo, yq_hi = comb2(yq[0], yq[1]), comb2(yq[2], yq[3])
    dr_lo, dr_hi = comb2(dr[0], dr[1]), comb2(dr[2], dr[3])
    pl_lo, pl_hi = comb2(pl[0], pl[1]), comb2(pl[2], pl[3])
    u_lo, u_hi = comb2(uc[0], uc[1]), comb2(uc[2], uc[3])
    # Operand bindings: x = a on MUL/MULH rows, x = res (the quotient) on
    # DIV/DIVU rows (REM/REMU leave x a free 40-bit witness); y = b on
    # every mul/div row; res = r on REM/REMU rows.
    sel_xa = add(sel_mulf, sel_sllf)     # x = a on MUL/MULH/SLL rows
    singles.append(mul(sel_xa, sub(va_lo, xq_lo)))
    singles.append(mul(sel_xa, sub(va_hi, xq_hi)))
    singles.append(mul(sel_md, sub(vb_lo, yq_lo)))
    singles.append(mul(sel_md, sub(vb_hi, yq_hi)))
    # res = the quotient x on DIV/DIVU and SRL rows (SRA adjusts below).
    sel_qres = add(add(sel_by[0x04], sel_by[0x06]), sel_srlf)
    singles.append(mul(sel_qres, sub(res_lo, xq_lo)))
    singles.append(mul(sel_qres, sub(res_hi, xq_hi)))
    sel_rres = add(sel_by[0x05], sel_by[0x07])
    singles.append(mul(sel_rres, sub(res_lo, dr_lo)))
    singles.append(mul(sel_rres, sub(res_hi, dr_hi)))
    # Carry reconstructions (k0 a bare chunk; k1/k6 chunk + 1 bit;
    # k2..k5 chunk + 2 bits) with bit boolean constraints.
    kvals = [col(COL_K0)]
    for cc, bits in ((COL_K1C, 1), (COL_K2C, 2), (COL_K3C, 2),
                     (COL_K4C, 2), (COL_K5C, 2), (COL_K6C, 1)):
        b0v = col(cc + 1)
        singles.append(boolean(b0v))
        hi_part = b0v
        if bits == 2:
            b1v = col(cc + 2)
            singles.append(boolean(b1v))
            hi_part = add(b0v, mulc(b1v, 2))
        kvals.append(add(col(cc), mul(hi_part, two10)))
    # Column sums s_t = sum_{i+j=t} xq_i * yq_j (degree 2).
    s_sums = []
    for t in range(7):
        acc = None
        for i in range(4):
            j = t - i
            if 0 <= j < 4:
                term = mul(xq[i], yq[j])
                acc = term if acc is None else add(acc, term)
        s_sums.append(acc)
    res_ch = [col(COL_RES_CH0 + i) for i in range(4)]
    # Low chain (stages 0..3): result chunks on MUL rows; pl chunks on
    # MULH/DIV rows.  Every term < 2^23 << p: field identity == integers.
    sel_plchain = add(add(sel_mulh, sel_divf), sel_srx)
    sel_mullow = add(sel_mul, sel_sllf)  # result chunks = low product
    for t in range(4):
        base_e = s_sums[t] if t == 0 else add(s_sums[t], kvals[t - 1])
        k_sh = mul(kvals[t], two10)
        singles.append(mul(sel_mullow, sub(base_e, add(res_ch[t], k_sh))))
        singles.append(mul(sel_plchain, sub(base_e, add(pl[t], k_sh))))
    # MULH high chain (stages 4..6 -> res chunks 0..2; chunk 7 = k6).
    for t in range(4, 7):
        base_e = add(s_sums[t], kvals[t - 1])
        singles.append(mul(sel_mulh, sub(
            base_e, add(res_ch[t - 4], mul(kvals[t], two10)))))
    singles.append(mul(sel_mulh, sub(res_ch[3], kvals[6])))
    # Division: q*b < 2^40 (high stages vanish), a = q*b + r exactly,
    # and r < b via u = b - 1 - r >= 0.
    sel_divx = add(sel_divf, sel_srx)
    singles.append(mul(sel_divx, add(s_sums[4], kvals[3])))
    singles.append(mul(sel_divx, s_sums[5]))
    singles.append(mul(sel_divx, s_sums[6]))
    cd0, e0 = col(COL_CD0), col(COL_E0)
    singles.append(boolean(cd0))
    singles.append(boolean(e0))
    singles.append(mul(sel_divf, sub(
        add(pl_lo, dr_lo), add(va_lo, mul(cd0, two20)))))
    singles.append(mul(sel_divf, sub(
        add(add(pl_hi, dr_hi), cd0), va_hi)))
    singles.append(mul(sel_divf, sub(
        add(add(u_lo, one), dr_lo), add(vb_lo, mul(e0, two20)))))
    singles.append(mul(sel_divf, sub(
        add(add(u_hi, dr_hi), e0), vb_hi)))

    # --- Shift block (trace.py SH_BASE layout) ---
    # The aux shift channel pins (s_eff, d, pm) to a real table row
    # (s_eff < 64, d = chunk position, pm = chunk value of y = 2^s_eff);
    # the constraints below bind s_eff to the instruction's shamt, y's
    # chunks to (d, pm), and the result through the shared multiplier.
    s_raw = col(COL_SH_S)
    s_eff = col(COL_SH_SEFF)
    shq = col(COL_SH_SHQ)
    z_sh = col(COL_SH_Z)
    zinv = col(COL_SH_ZINV)
    d_sh = [col(COL_SH_D0 + j) for j in range(5)]
    pm = col(COL_SH_PM)
    xd_lo, xd_hi = col(COL_SH_XD_LO), col(COL_SH_XD_HI)
    # z = [shq == 0] (ungated: non-shift rows default shq=0, z=1).
    singles.append(boolean(z_sh))
    singles.append(mul(z_sh, shq))
    singles.append(sub(add(z_sh, mul(shq, zinv)), one))
    # d one-hot (ungated: non-shift rows default d0 = 1).
    dsum = d_sh[0]
    for j in range(5):
        singles.append(boolean(d_sh[j]))
        if j:
            dsum = add(dsum, d_sh[j])
    singles.append(sub(dsum, one))
    # shq range: shqc0/shqc1 channels force shq < 2^20, making the
    # masking decomposition src = s + 64 shq unique (s < 64 by the table).
    singles.append(sub(shq, add(col(COL_SH_SHQC0),
                                mulc(col(COL_SH_SHQC1), 1 << 10))))
    # Masking: register shifts take shamt = vb mod 64 (execute.rs shamt
    # & 0x3F); immediate shifts decompose the sext'd immediate limb.
    singles.append(mul(sel_shr3, sub(vb_lo, add(s_raw, mulc(shq, 64)))))
    singles.append(mul(sel_shi3, sub(i_lo, add(s_raw, mulc(shq, 64)))))
    # s_eff: = s on register shifts; immediates with shq != 0 (imm >= 64)
    # behave like shift-63 (>= 40 => zero / sign fill, same as imm).
    singles.append(mul(sel_shr3, sub(s_eff, s_raw)))
    singles.append(mul(sel_shi3, sub(
        s_eff, add(mul(z_sh, s_raw), mulc(sub(one, z_sh), 63)))))
    # y = 2^s_eff: chunk d is pm, the rest are zero (d=4 => y = 0).
    for j in range(4):
        singles.append(mul(sel_shf, sub(yq[j], mul(d_sh[j], pm))))
    # SRA: sign decomposition of va (reuses the compare block's sa
    # gadget), the conditionally complemented dividend xd, and the
    # complement-adjusted result res = sa ? ~x : x.
    singles.append(mul(sel_sraf, sub(va_hi, sign_dec_a)))
    m20c = (1 << 20) - 1
    singles.append(mul(sel_sraf, sub(
        xd_lo, add(va_lo, mul(sa, sub(K(m20c), mulc(va_lo, 2)))))))
    singles.append(mul(sel_sraf, sub(
        xd_hi, add(va_hi, mul(sa, sub(K(m20c), mulc(va_hi, 2)))))))
    singles.append(mul(sel_sraf, sub(
        res_lo, add(xq_lo, mul(sa, sub(K(m20c), mulc(xq_lo, 2)))))))
    singles.append(mul(sel_sraf, sub(
        res_hi, add(xq_hi, mul(sa, sub(K(m20c), mulc(xq_hi, 2)))))))
    # SRL uses va directly as the dividend.
    singles.append(mul(sel_srlf, sub(xd_lo, va_lo)))
    singles.append(mul(sel_srlf, sub(xd_hi, va_hi)))
    # Division identity xd = x*y + r with r < y, gated out on d=4 rows
    # (y = 0); every term < 2^21 so the field identities are integral.
    g_live = mul(sel_srx, sub(one, d_sh[4]))
    y_lo = comb2(yq[0], yq[1])
    y_hi = comb2(yq[2], yq[3])
    singles.append(mul(g_live, sub(
        add(pl_lo, dr_lo), add(xd_lo, mul(cd0, two20)))))
    singles.append(mul(g_live, sub(
        add(add(pl_hi, dr_hi), cd0), xd_hi)))
    singles.append(mul(g_live, sub(
        add(add(u_lo, one), dr_lo), add(y_lo, mul(e0, two20)))))
    singles.append(mul(g_live, sub(
        add(add(u_hi, dr_hi), e0), y_hi)))
    # d=4 (shift >= 40): SLL/SRL results are 0 (SLL gets it free from the
    # zero product through the result chain); SRA is the full sign fill.
    sel_srl_d4 = mul(sel_srlf, d_sh[4])
    singles.append(mul(sel_srl_d4, res_lo))
    singles.append(mul(sel_srl_d4, res_hi))
    sel_sra_d4 = mul(sel_sraf, d_sh[4])
    singles.append(mul(sel_sra_d4, sub(res_lo, mulc(sa, m20c))))
    singles.append(mul(sel_sra_d4, sub(res_hi, mulc(sa, m20c))))

    # --- Transitions ---
    pc_lo, pc_hi = col(COL_PC_LO), col(COL_PC_HI)
    pc_lo_n, pc_hi_n = nxt(COL_PC_LO), nxt(COL_PC_HI)
    t1_inner = add(sub(sub(pc_lo_n, pc_lo), four), mul(carry, two20))
    t2_inner = sub(sub(pc_hi_n, pc_hi), carry)
    transitions = [
        mul(s_seq, t1_inner),
        mul(s_seq, t2_inner),
    ]

    # Register-file write consistency: register r may change into the next
    # row only if this row writes it (w * e_r, both one-hot-derived) or is
    # an ECALL writing R10 (the syscall result register, syscall.rs:94-97).
    w = None
    for j, v in enumerate(OP_VALUES):
        if v in WRITING_OPS:
            w = sel[j] if w is None else add(w, sel[j])
    sel_ecall = sel[OP_VALUES.index(OP_ECALL)]
    for r in range(1, 16):
        allow = mul(w, e[r])
        if r == 10:
            allow = add(allow, sel_ecall)
        factor = sub(one, allow)
        for base in (COL_REG_LO, COL_REG_HI):
            delta = sub(nxt(base + r), col(base + r))
            transitions.append(mul(factor, delta))

    # Result binding: on a writing row the destination register's next-row
    # value must equal the committed result limbs (degree 3).
    for r in range(1, 16):
        we = mul(w, e[r])
        transitions.append(mul(we, sub(nxt(COL_REG_LO + r), res_lo)))
        transitions.append(mul(we, sub(nxt(COL_REG_HI + r), res_hi)))

    # Branch/jump pc-target semantics (trace.py control-flow block).
    sel_br = selsum(BRANCH_OPS)
    d_lo = add(mul(taken, i_lo), mul(sub(one, taken), four))
    transitions.append(mul(sel_br, add(
        sub(sub(nxt(COL_PC_LO), pc_lo), d_lo), c2_sh)))
    transitions.append(mul(sel_br, add(
        sub(sub(sub(nxt(COL_PC_HI), pc_hi), mul(taken, i_hi)), c2),
        c3_sh)))
    # JAL: pc' = pc + sext21(16*imm + rs1); sign bit of the 21-bit offset
    # is word bit 31 = imm_s; (2^40 - 2^21) has limbs (0, 0xFFFFE).
    jal_off = add(mulc(col(COL_IMM_LO), 16), col(COL_RS1))
    transitions.append(mul(sel_by[0x48], add(
        sub(sub(nxt(COL_PC_LO), pc_lo), jal_off), c2_sh)))
    transitions.append(mul(sel_by[0x48], add(
        sub(sub(sub(nxt(COL_PC_HI), pc_hi), mulc(s_imm, 0xFFFFE)), c2),
        c3_sh)))
    # JALR: pc' = (rs1_val + sext17(imm)) & ~1.
    transitions.append(mul(sel_by[0x49], add(add(
        sub(sub(nxt(COL_PC_LO), a_lo), i_lo), b_lsb), c2_sh)))
    transitions.append(mul(sel_by[0x49], add(
        sub(sub(sub(nxt(COL_PC_HI), a_hi), i_hi), c2), c3_sh)))

    # Halt chain: a halted machine keeps halting.  An EBREAK row's
    # successor must be an EBREAK row; an exit-ECALL row's successor
    # likewise; a non-exit ECALL advances pc by exactly 4 (vm.rs:277-279),
    # reusing the carry column (free on non-seq rows).
    sel_eb_next = nxt(COL_SEL0 + OP_VALUES.index(0x51))
    transitions.append(mul(sel_eb, sub(one, sel_eb_next)))
    transitions.append(mul(mul(sel_ec, eex), sub(one, sel_eb_next)))
    # pc advances by 4 on non-exit ECALL rows EXCEPT non-final crypto
    # chunk rows (more = 1): a chain freezes pc until its last chunk
    # (more => ecr => eex = 0, so the gate stays degree 1).
    more = col(COL_CMORE)
    ec_adv = mul(sel_ec, sub(sub(one, eex), more))
    transitions.append(mul(ec_adv, t1_inner))
    transitions.append(mul(ec_adv, t2_inner))
    transitions.append(mul(more, sub(nxt(COL_PC_LO), pc_lo)))
    transitions.append(mul(more, sub(nxt(COL_PC_HI), pc_hi)))

    # --- I/O-tape block (trace.py IO_BASE): syscall-number bits,
    # READ/WRITE flags, running tape indices (syscall.rs:18-97).
    b0, b1, b2 = col(COL_IO_B0), col(COL_IO_B1), col(COL_IO_B2)
    erd, ewr = col(COL_ERD), col(COL_EWR)
    for b in (b0, b1, b2):
        singles.append(boolean(b))
        singles.append(mul(sub(one, sel_ec), b))  # bits live on ECALL only
    # num = b0 + 2 b1 + 4 b2 pins R10 on ECALL rows (high limb zero) and
    # b0 b1 b2 = 0 caps num at 6 — an InvalidSyscall number (> 6, which
    # halts the oracle with an error) cannot appear on an accepted ECALL
    # row at all (syscall.rs:18-24, runtime/errors.py InvalidSyscall).
    num = add(b0, add(mulc(b1, 2), mulc(b2, 4)))
    singles.append(mul(sel_ec, sub(col(COL_REG_LO + 10), num)))
    singles.append(mul(sel_ec, col(COL_REG_HI + 10)))
    singles.append(mul(mul(b0, b1), b2))
    # erd = [num == 1], ewr = [num == 2]: exact degree-3 pins (the bits
    # vanish off ECALL rows, so the flags do too).
    singles.append(sub(erd, mul(mul(b0, sub(one, b1)), sub(one, b2))))
    singles.append(sub(ewr, mul(mul(sub(one, b0), b1), sub(one, b2))))
    # Crypto syscalls (num >= 3) write result 0 to R10 AFTER the final
    # chunk row (syscall.rs:121-177); non-final chunk rows freeze R10
    # (the chain's num continuity rides the frozen register).  WRITE
    # does NOT touch R10 (syscall.rs:114-119) so it pins persistence
    # instead; READ results are pinned to the public input tape by the
    # io multiset channel (io_multiset).
    res0 = mul(sel_ec, sub(sub(sub(sub(one, erd), ewr), eex), more))
    transitions.append(mul(res0, nxt(COL_REG_LO + 10)))
    transitions.append(mul(res0, nxt(COL_REG_HI + 10)))
    transitions.append(mul(more, sub(nxt(COL_REG_LO + 10),
                                     col(COL_REG_LO + 10))))
    transitions.append(mul(more, sub(nxt(COL_REG_HI + 10),
                                     col(COL_REG_HI + 10))))
    transitions.append(mul(ewr, sub(nxt(COL_REG_LO + 10),
                                    col(COL_REG_LO + 10))))
    transitions.append(mul(ewr, sub(nxt(COL_REG_HI + 10),
                                    col(COL_REG_HI + 10))))
    # Tape-index chains: +1 per READ / WRITE row, from 0.
    transitions.append(sub(sub(nxt(COL_RIDX), col(COL_RIDX)), erd))
    transitions.append(sub(sub(nxt(COL_WIDX), col(COL_WIDX)), ewr))

    # --- Crypto-syscall block (trace.py CR_BASE; challenge-free part) ---
    # ecr = [num in 3..6] on ECALL rows: with b0 b1 b2 = 0 pinned above,
    # that is exactly b2 + b0*b1 (3 = 011, 4..6 have b2 = 1).
    ecr = col(COL_ECR)
    singles.append(sub(ecr, add(b2, mul(b0, b1))))
    # cidx chain: +1 per crypto row, from 0.
    transitions.append(sub(sub(nxt(COL_CIDX), col(COL_CIDX)), ecr))
    # Active-slot-count one-hot; non-crypto rows pin the nc = 0 entry.
    na = [col(COL_CNA0 + c) for c in range(8)]
    na_sum = na[0]
    for c in range(1, 8):
        singles.append(boolean(na[c]))
        na_sum = add(na_sum, na[c])
    singles.append(boolean(na[0]))
    singles.append(sub(na_sum, one))
    singles.append(mul(sub(one, ecr), sub(one, na[0])))
    # len = R12 binding via the CHAIN-REMAINDER column crem (multi-block
    # chaining, trace.py layout comment at CR_BASE): crem starts at
    # R12_lo (R12_hi pinned zero -> len < 2^20), drops 56 per non-final
    # chunk row, and the final chunk row pins crem = 8*nc - pad — so
    # the chain length and total hashed byte count are forced by R12
    # (no 56k-step wrap fits any < 2^25-row domain).
    pad_c = col(COL_CPAD)
    singles.append(mul(sub(one, ecr), pad_c))
    nc_expr = None
    for c in range(1, 8):
        term = mulc(na[c], c)
        nc_expr = term if nc_expr is None else add(nc_expr, term)
    len_expr = sub(mulc(nc_expr, 8), pad_c)
    crem = col(COL_CREM)
    cblk = col(COL_CBLK)
    elast = sub(ecr, more)              # final chunk row flag
    singles.append(boolean(more))
    singles.append(mul(more, sub(one, ecr)))     # more only on crypto rows
    singles.append(mul(sub(one, ecr), cblk))     # chain state zero off
    singles.append(mul(sub(one, ecr), crem))     # crypto rows
    singles.append(mul(elast, sub(crem, len_expr)))
    singles.append(mul(more, sub(len_expr, K(56))))  # full chunks inside
    singles.append(mul(ecr, col(COL_REG_HI + 12)))
    # Non-final chunk rows carry no digest: their write slots are
    # inactive in the memory argument (crypto_slot_constraints gates on
    # elast) and their cwo/cwd bytes are pinned zero so the public tape
    # compression stays well defined.
    for base_c in (COL_CWO0, COL_CWD0):
        for k in range(8 * N_WRITE_SLOTS):
            singles.append(mul(more, col(base_c + k)))
    # Chain transitions: a more-row's successor is its continuation —
    # same syscall (pc + registers frozen above), cblk + 1, crem - 56 —
    # and every fresh crypto row (not preceded by more) starts at
    # cblk = 0 with crem = R12_lo.
    transitions.append(mul(more, sub(one, nxt(COL_ECR))))
    transitions.append(mul(more, sub(sub(nxt(COL_CBLK), cblk), one)))
    transitions.append(mul(more, sub(add(nxt(COL_CREM), K(56)), crem)))
    fresh = sub(nxt(COL_ECR), more)     # 1 iff next row starts a chain
    transitions.append(mul(fresh, nxt(COL_CBLK)))
    transitions.append(mul(fresh, sub(nxt(COL_CREM),
                                      nxt(COL_REG_LO + 12))))
    # Slot-key carry bits: boolean, zero off crypto rows.
    for cc in ([COL_CRC0]
               + [COL_CRC1 + i for i in range(N_READ_SLOTS - 1)]
               + [COL_CWC1 + i for i in range(N_WRITE_SLOTS - 1)]):
        singles.append(boolean(col(cc)))
        singles.append(mul(sub(one, ecr), col(cc)))
    # Inactive-slot byte zeroing: read slot i is active iff i < nc, i.e.
    # active_i = sum_{c > i} na_c; its bytes vanish otherwise (this also
    # zeroes every slot byte on non-crypto rows, keeping the public
    # crypto-tape compression well defined).
    for i in range(N_READ_SLOTS):
        active = None
        for c in range(i + 1, 8):
            active = na[c] if active is None else add(active, na[c])
        gate = sub(one, active)
        for j in range(8):
            singles.append(mul(gate, col(COL_CRB0 + 8 * i + j)))
    # Write slots are always live on crypto rows (32-byte digest) and
    # dead elsewhere.
    not_ecr = sub(one, ecr)
    for base_c in (COL_CWO0, COL_CWD0):
        for k in range(8 * N_WRITE_SLOTS):
            singles.append(mul(not_ecr, col(base_c + k)))

    # Boundary: the machine starts with a zeroed register file.
    firsts = [col(base + r)
              for r in range(1, 16) for base in (COL_REG_LO, COL_REG_HI)]
    firsts += [col(COL_RIDX), col(COL_WIDX), col(COL_CIDX)]
    # A crypto row at index 0 starts a chain: cblk = 0, crem = R12_lo
    # (rows > 0 get this from the `fresh` transition above).
    firsts += [mul(ecr, cblk),
               mul(ecr, sub(crem, col(COL_REG_LO + 12)))]
    return singles, transitions, firsts


def memory_constraints(A):
    """(cell, clk)-sorted memory UPDATE-table constraints (active in
    range_lookup mode; the prover fills the block in _build_memory_table).

    A table row is one cell update (old bytes -> new bytes at clk); the
    chain encodes read-modify-write consistency for every access width:

    singles: m_real/m_same/m_hieq booleans.
    firsts:  m_same = 0; exec clk = 0; a run-opening real row starts
             from the zero cell (real * ob_j = 0).
    transitions (next-row chunks D' = cha' + 2^10 chb' gap-check both
    the clk-strict-increase within a cell run and the cell-key
    strict-increase between runs):
        clk' = clk + 1                      (exec clk chain)
        real' => real                       (real rows first)
        same' => q' = q and ahi' = ahi      (run continues the cell)
        hieq' => ahi' = ahi
        !same' => key' = key + 1 + D' on the lexicographic limb (q|ahi)
        same' => clk_m' = clk_m + 1 + D'
        same' => ob'_j = nb_j               (updates chain: the next
                                             update's pre-state is this
                                             update's post-state)
        !same' & real' => ob'_j = 0         (fresh cells start zeroed;
                                             code/data initial values
                                             arrive as clk-0 init rows
                                             whose multiset demand the
                                             verifier computes from the
                                             public program)
    """
    add, sub, mul, col, nxt, K = A.add, A.sub, A.mul, A.col, A.nxt, A.const
    one = K(1)

    def boolean(b):
        return mul(b, sub(b, one))

    m_real = col(M_REAL)
    m_same, m_hieq = col(M_SAME), col(M_HIEQ)
    singles = [boolean(b) for b in (m_real, m_same, m_hieq)]

    firsts = [m_same, col(COL_CLK)]
    firsts += [mul(m_real, col(M_OB0 + j)) for j in range(8)]

    same_n, hieq_n = nxt(M_SAME), nxt(M_HIEQ)
    real_n = nxt(M_REAL)
    not_same_n = sub(one, same_n)
    d_gap = add(add(nxt(M_CHA), A.mulc(nxt(M_CHB), 1 << 10)),
                A.mulc(nxt(M_CHC), 1 << 20))

    def q_at(get):
        return add(get(M_QA), A.mulc(get(M_QB), 1 << 10))

    def inc_gap_expr(nxt_e, cur_e):
        return sub(sub(sub(nxt_e, cur_e), one), d_gap)

    transitions = [
        sub(sub(nxt(COL_CLK), col(COL_CLK)), one),
        mul(sub(one, m_real), real_n),
        mul(same_n, sub(q_at(nxt), q_at(col))),
        mul(same_n, sub(nxt(M_AHI), col(M_AHI))),
        mul(hieq_n, sub(nxt(M_AHI), col(M_AHI))),
        mul(not_same_n, add(
            mul(hieq_n, inc_gap_expr(q_at(nxt), q_at(col))),
            mul(sub(one, hieq_n),
                inc_gap_expr(nxt(M_AHI), col(M_AHI))))),
        mul(same_n, inc_gap_expr(nxt(M_CLK), col(M_CLK))),
    ]
    for j in range(8):
        transitions.append(
            mul(same_n, sub(nxt(M_OB0 + j), col(M_NB0 + j))))
        transitions.append(
            mul(mul(not_same_n, real_n), nxt(M_OB0 + j)))
    return singles, transitions, firsts


def lookup_channels(A, beta):
    """The cyclic LogUp constraints, one per CHANNELS entry.

    Per channel k (w = the channel's affine witness, m = multiplicities,
    t = table — all CM31-valued; beta and the phase-2 partial-sum column
    S are QM31):

        (S' - S) (beta - w) (beta - t)  -  (beta - t)  +  m (beta - w) = 0

    Degree 3; divides by Z_H (holds cyclically on every row — the
    telescoping around the cycle IS the multiset identity)."""
    add, col, K = A.add, A.col, A.const
    beta_q = A.qconst(beta)
    bt = A.qsub(beta_q, A.qlift(col(COL_TABLE)))
    out = []
    for k, (_, const, terms) in enumerate(CHANNELS):
        w = K(const)
        for c, coef in terms:
            w = add(w, A.mulc(col(c), coef))
        m = col(COL_MULT0 + k)
        bw = A.qsub(beta_q, A.qlift(w))
        lhs = A.qmul(A.qmul(A.qsub(A.snxt(k), A.scol(k)), bw), bt)
        rhs = A.qsub(bt, A.qmul_c(bw, m))
        out.append(A.qsub(lhs, rhs))
    return out


def aux_channels(A, beta, eta):
    """The challenge-compressed aux-table LogUp constraints, one per
    AUX_CHANNELS entry: witness w = w0 + eta*w1 + eta^2*w2 vs table
    t = t0 + eta*t1 + eta^2*t2 (preprocessed columns, aux_table.py;
    eta/beta QM31), in the same (S'-S)(b-w)(b-t) = (b-t) - m(b-w)
    cyclic form."""
    from ..ops.qm31 import qm31_mul_scalar

    add, col, K = A.add, A.col, A.const
    beta_q = A.qconst(beta)
    eta2 = qm31_mul_scalar(eta, eta)
    out = []
    for k, (_, wspecs, t_base, _idx) in enumerate(AUX_CHANNELS):
        parts = []
        for terms in wspecs:
            acc = None
            for c, coef in terms:
                term = A.mulc(col(c), coef) if coef != 1 else col(c)
                acc = term if acc is None else add(acc, term)
            parts.append(acc)
        w = A.qadd(A.qlift(parts[0]),
                   A.qadd(A.qscale(parts[1], eta),
                          A.qscale(parts[2], eta2)))
        t = A.qadd(A.qlift(A.acol(t_base)),
                   A.qadd(A.qscale(A.acol(t_base + 1), eta),
                          A.qscale(A.acol(t_base + 2), eta2)))
        m = col(COL_AUXM0 + k)
        bw = A.qsub(beta_q, w)
        bt = A.qsub(beta_q, t)
        lhs = A.qmul(A.qmul(A.qsub(A.asnxt(k), A.ascol(k)), bw), bt)
        rhs = A.qsub(bt, A.qmul_c(bw, m))
        out.append(A.qsub(lhs, rhs))
    return out


def table_pins(A):
    """The staircase-table pins: t(first) = 0 (F divisor), increments in
    {0,1} (T), t(last) = 1023 (L).  Start 0 + 0/1 steps + end 1023 over n
    rows => every value of [0, 1024) appears."""
    sub, mul, col, K = A.sub, A.mul, A.col, A.const
    t = col(COL_TABLE)
    dt = sub(A.nxt(COL_TABLE), t)
    stair = mul(dt, sub(dt, K(1)))
    return t, stair, sub(t, K(1023))


def _compress_delta(A, components, delta):
    """sum_k comp_k * delta^k over QM31 for CM31-valued components."""
    from ..ops.qm31 import qm31_mul_scalar

    acc = A.qlift(components[0])
    pw = delta
    for c in components[1:]:
        acc = A.qadd(acc, A.qscale(c, pw))
        pw = qm31_mul_scalar(pw, delta)
    return acc


def crypto_slot_constraints(A, beta, delta):
    """Per-slot inverse pins tying crypto-syscall memory traffic into the
    byte-level memory-update multiset.

    Read slot i (i < 7) covers input cell (R11 >> 3) + i at timestamp
    2*clk + 1 with old == new bytes; write slot i covers digest cell
    (R13 >> 3) + i at 2*clk + 2 (old -> digest bytes).  Slot keys derive
    from the register file: q_0 = R11_lo * 8^-1 (field-exact — an
    unaligned pointer has no in-range preimage, and the table-side
    tqa/tqb channels keep every table key < 2^17, so a wrong carry bit
    can never find a matching row).  Pin per slot s (inv_s a committed
    phase-2 QM31 column):

        inv_s * (beta - w_s) - active_s = 0          (H, degree 2)

    so inv_s = active_s / (beta - w_s) and the memory multiset's F
    column absorbs sum_s inv_s (memory_multiset ``slot_sum``).

    Returns (pins, slot_sum)."""
    add, sub, mul, col, K = A.add, A.sub, A.mul, A.col, A.const
    one = K(1)
    inv8 = pow(8, P - 2, P)
    beta_q = A.qconst(beta)
    ts_read = add(A.mulc(col(COL_CLK), 2), one)       # 2*clk + 1
    ts_write = add(A.mulc(col(COL_CLK), 2), K(2))     # 2*clk + 2
    ecr = col(COL_ECR)
    na = [col(COL_CNA0 + c) for c in range(8)]
    # Multi-block chains: chunk cblk's read slots advance 7 cells per
    # chunk; the digest writes fire only on the final chunk row.
    cblk7 = A.mulc(col(COL_CBLK), 7)
    elast = sub(ecr, col(COL_CMORE))

    pins = []
    slot_sum = None
    for s in range(N_SLOTS):
        if s < N_READ_SLOTS:
            i = s
            base_lo, base_hi = COL_REG_LO + 11, COL_REG_HI + 11
            # Every read slot has a carry bit (slot 0's lives in CRC0:
            # a later chunk's base key q0 + 7*cblk can itself cross the
            # 2^17 cell-key boundary).
            carry_col = COL_CRC0 if i == 0 else COL_CRC1 + i - 1
            ts = ts_read
            ob = [col(COL_CRB0 + 8 * i + j) for j in range(8)]
            nb = ob
            offset = add(K(i), cblk7)
            active = None
            for c in range(i + 1, 8):
                active = na[c] if active is None else add(active, na[c])
        else:
            i = s - N_READ_SLOTS
            base_lo, base_hi = COL_REG_LO + 13, COL_REG_HI + 13
            carry_col = None if i == 0 else COL_CWC1 + i - 1
            ts = ts_write
            ob = [col(COL_CWO0 + 8 * i + j) for j in range(8)]
            nb = [col(COL_CWD0 + 8 * i + j) for j in range(8)]
            offset = K(i)
            active = elast
        q0 = A.mulc(col(base_lo), inv8)
        if carry_col is None:
            q_s, ahi_s = q0, col(base_hi)
        else:
            cb = col(carry_col)
            q_s = sub(add(q0, offset), A.mulc(cb, 1 << 17))
            ahi_s = add(col(base_hi), cb)
        w_s = _compress_delta(A, [q_s, ahi_s, ts] + ob + nb, delta)
        inv_s = A.crinv(s)
        pins.append(A.qsub(A.qmul(inv_s, A.qsub(beta_q, w_s)),
                           A.qlift(active)))
        slot_sum = inv_s if slot_sum is None else A.qadd(slot_sum, inv_s)
    return pins, slot_sum


def crypto_tape_channel(A, beta, delta, d_crypto):
    """The public crypto-tape multiset: every crypto row's
    (num, cidx, len, 56 input bytes, 32 digest bytes) tuple must equal
    the VERIFIER-computed demand ``d_crypto`` — computed from the
    proof's claimed tape by RE-HASHING each input
    (prover.crypto_tape_demand), so the digest bytes are bound to the
    input bytes without an in-AIR hash.  Same committed-F shape as
    io_multiset:

        H: F (beta - w) - ecr = 0
        T: S' - S - F = 0
        F: S = 0
        L: S + F - d_crypto = 0
    """
    add, sub, col, K = A.add, A.sub, A.col, A.const
    b0, b1, b2 = col(COL_IO_B0), col(COL_IO_B1), col(COL_IO_B2)
    num = add(b0, add(A.mulc(b1, 2), A.mulc(b2, 4)))
    na = [col(COL_CNA0 + c) for c in range(8)]
    nc_expr = None
    for c in range(1, 8):
        term = A.mulc(na[c], c)
        nc_expr = term if nc_expr is None else add(nc_expr, term)
    len_expr = sub(A.mulc(nc_expr, 8), col(COL_CPAD))
    # The chain's more flag joins the tuple so the verifier can
    # reassemble multi-block messages from consecutive entries
    # (prover.crypto_tape_demand).
    comps = [num, col(COL_CIDX), len_expr, col(COL_CMORE)]
    comps += [col(COL_CRB0 + k) for k in range(8 * N_READ_SLOTS)]
    comps += [col(COL_CWD0 + k) for k in range(8 * N_WRITE_SLOTS)]
    w = _compress_delta(A, comps, delta)
    beta_q = A.qconst(beta)
    f = A.crfcol()
    s_col = A.crcol()
    pin = A.qsub(A.qmul(f, A.qsub(beta_q, w)), A.qlift(col(COL_ECR)))
    trans = A.qsub(A.qsub(A.crnxt(), s_col), f)
    first = s_col
    last = A.qsub(A.qadd(s_col, f), A.qconst(d_crypto))
    return pin, trans, first, last


def memory_multiset(A, beta, delta, d_init, slot_sum=None):
    """The memory-update multiset LogUp constraints.

    Exec tuples (cell q, addr_hi, clk+1, ob0-7, nb0-7) of EVERY
    load/store row, plus the verifier-computed init demand ``d_init``
    (one tuple (cell, 0, zeros, initial bytes) per code/data cell of the
    public program), must equal the real table rows:

        sum_rows v/(beta - w)  +  d_init  =  sum_rows real/(beta - t)

    Because the total is a nonzero public constant, the cyclic LogUp
    form cannot close this channel; instead the per-row term
    F = v/(beta-w) - real/(beta-t) is its own committed column (so the
    boundary constraints stay degree <= 1 and the L-divisor quotient
    stays in budget):

        H: F (beta-w)(beta-t) - v (beta-t) + real (beta-w) = 0
        T: S' - S - F = 0
        F: S = 0
        L: S + F + d_init = 0

    Returns (pin, transition, first, last) constraint expressions."""
    from ..ops.qm31 import qm31_mul_scalar

    add, col, K = A.add, A.col, A.const

    def compress(components):
        acc = A.qlift(components[0])
        pw = delta
        for c in components[1:]:
            acc = A.qadd(acc, A.qscale(c, pw))
            pw = qm31_mul_scalar(pw, delta)
        return acc

    sel_loads = None
    for vop in LOAD_OPS:
        s = col(COL_SEL0 + OP_VALUES.index(vop))
        sel_loads = s if sel_loads is None else add(sel_loads, s)
    sel_stores = None
    for vop in STORE_OPS:
        s = col(COL_SEL0 + OP_VALUES.index(vop))
        sel_stores = s if sel_stores is None else add(sel_stores, s)
    v = add(sel_loads, sel_stores)

    # Regular load/store timestamps are 2*clk + 2 (crypto-slot reads
    # take 2*clk + 1, writes 2*clk + 2 — crypto_slot_constraints — so an
    # in-place hash chains read-before-write within one row).
    q_exec = add(col(COL_MQA), A.mulc(col(COL_MQB), 1 << 10))
    w_comp = [q_exec, col(COL_MEM_ADDR_HI),
              add(A.mulc(col(COL_CLK), 2), K(2))]
    w_comp += [col(COL_OB0 + j) for j in range(8)]
    w_comp += [col(COL_NB0 + j) for j in range(8)]
    w = compress(w_comp)

    q_tab = add(col(M_QA), A.mulc(col(M_QB), 1 << 10))
    t_comp = [q_tab, col(M_AHI), col(M_CLK)]
    t_comp += [col(M_OB0 + j) for j in range(8)]
    t_comp += [col(M_NB0 + j) for j in range(8)]
    t_mem = compress(t_comp)

    beta_q = A.qconst(beta)
    bw = A.qsub(beta_q, w)
    bt = A.qsub(beta_q, t_mem)
    f = A.mfcol()
    # F also carries the crypto-slot demands (sum_s inv_s, each pinned by
    # crypto_slot_constraints); the load/store part must satisfy the
    # rational identity on its own.
    f_ls = f if slot_sum is None else A.qsub(f, slot_sum)
    pin = A.qsub(A.qmul(A.qmul(f_ls, bw), bt),
                 A.qsub(A.qmul_c(bt, v), A.qmul_c(bw, col(M_REAL))))
    trans = A.qsub(A.qsub(A.mnxt(), A.mcol()), f)
    first = A.mcol()
    last = A.qadd(A.qadd(A.mcol(), f), A.qconst(d_init))
    return pin, trans, first, last


def io_multiset(A, beta, delta, d_io):
    """The I/O-tape multiset LogUp constraints.

    READ tuples (1, ridx, next-row R10 limbs — the syscall result) and
    WRITE tuples (2, widx, this row's R11 limbs) of every flagged ECALL
    row must equal the public tape demand ``d_io`` the VERIFIER computes
    from the proof's claimed tapes (prover.io_tape_demand).  Because the
    running indices start at 0 and increment by exactly 1 per flagged
    row (air_constraints), multiset equality forces the i-th READ to
    return exactly inputs[i] and the WRITE sequence to be exactly the
    outputs — an accepted proof attests the full I/O behavior
    (syscall.rs:54-78).  Same committed-F shape as memory_multiset:

        H: F (beta-wr)(beta-ww) - erd (beta-ww) - ewr (beta-wr) = 0
        T: S' - S - F = 0
        F: S = 0
        L: S + F - d_io = 0
    """
    from ..ops.qm31 import qm31_mul_scalar

    col = A.col
    d2 = qm31_mul_scalar(delta, delta)
    d3 = qm31_mul_scalar(d2, delta)

    def compress(tag, idx, lo, hi):
        return A.qadd(A.qadd(A.qconst((tag, 0, 0, 0)),
                             A.qscale(idx, delta)),
                      A.qadd(A.qscale(lo, d2), A.qscale(hi, d3)))

    w_r = compress(1, col(COL_RIDX),
                   A.nxt(COL_REG_LO + 10), A.nxt(COL_REG_HI + 10))
    w_w = compress(2, col(COL_WIDX),
                   col(COL_REG_LO + 11), col(COL_REG_HI + 11))
    beta_q = A.qconst(beta)
    bwr = A.qsub(beta_q, w_r)
    bww = A.qsub(beta_q, w_w)
    erd, ewr = col(COL_ERD), col(COL_EWR)
    f = A.iofcol()
    pin = A.qsub(A.qmul(A.qmul(f, bwr), bww),
                 A.qadd(A.qmul_c(bww, erd), A.qmul_c(bwr, ewr)))
    trans = A.qsub(A.qsub(A.ionxt(), A.iocol()), f)
    first = A.iocol()
    last = A.qsub(A.qadd(A.iocol(), f), A.qconst(d_io))
    return pin, trans, first, last


def program_channel(A, beta, gamma):
    """The program-binding LogUp constraint: every executed row's
    (pc, instruction-field) tuple is a member of the preprocessed program
    table (gamma — QM31 — compresses the 4-tuple; see PROG_F_TERMS)."""
    from ..ops.qm31 import qm31_mul_scalar

    add, col = A.add, A.col
    g2 = qm31_mul_scalar(gamma, gamma)
    g3 = qm31_mul_scalar(g2, gamma)
    f = col(PROG_F_TERMS[0][0])
    for c, coef in PROG_F_TERMS[1:]:
        f = add(f, A.mulc(col(c), coef))
    w = A.qadd(A.qadd(A.qlift(col(COL_PC_LO)),
                      A.qscale(col(COL_PC_HI), gamma)),
               A.qadd(A.qscale(f, g2), A.qscale(col(COL_IMM_LO), g3)))
    t_prog = A.qadd(A.qadd(A.qlift(A.pcol(0)), A.qscale(A.pcol(1), gamma)),
                    A.qadd(A.qscale(A.pcol(2), g2),
                           A.qscale(A.pcol(3), g3)))
    beta_q = A.qconst(beta)
    bw = A.qsub(beta_q, w)
    bt = A.qsub(beta_q, t_prog)
    lhs = A.qmul(A.qmul(A.qsub(A.psnxt(), A.pscol()), bw), bt)
    rhs = A.qsub(bt, A.qmul_c(bw, col(COL_PROG_M)))
    return A.qsub(lhs, rhs)


def program_boundary(A, entry):
    """First-row pins: the trace starts at the program's entry point.

    ``entry`` is the entry-point int, or a pre-split ``(e_lo, e_hi)``
    tuple when the caller traces it through a jitted kernel (a 40-bit
    value cannot ride a single uint32 scalar)."""
    if isinstance(entry, tuple):
        e_lo, e_hi = entry
    else:
        e_lo = entry & ((1 << 20) - 1)
        e_hi = (entry >> 20) & ((1 << 20) - 1)
    return [A.sub(A.col(COL_PC_LO), A.const(e_lo)),
            A.sub(A.col(COL_PC_HI), A.const(e_hi))]


def quotient_terms(A, lookup=None, aux=None, memory=None, program=None,
                   io=None, crypto=None):
    """Every constraint paired with its divisor tag, in the canonical
    alpha-power order shared by prover and verifier.

    Tags: H = Z_H (all rows), T = Z_trans (all but last), F = Z_first,
    L = Z_last.  ``lookup`` = beta; ``aux`` = (beta, eta);
    ``memory`` = (beta, delta, d_init); ``program`` = (beta, gamma,
    entry); ``io`` = (beta, delta, d_io); ``crypto`` = (beta, delta,
    d_crypto) — requires ``memory`` (the slot demands ride its F)."""
    singles, transitions, firsts = air_constraints(A)
    terms = [("H", c) for c in singles]
    terms += [("T", c) for c in transitions]
    terms += [("F", c) for c in firsts]
    if lookup is not None:
        terms += [("H", c) for c in lookup_channels(A, lookup)]
        t, stair, t_last = table_pins(A)
        terms += [("F", t), ("T", stair), ("L", t_last)]
    if aux is not None:
        beta, eta = aux
        terms += [("H", c) for c in aux_channels(A, beta, eta)]
    if memory is not None:
        beta, delta, d_init = memory
        m_s, m_t, m_f = memory_constraints(A)
        terms += [("H", c) for c in m_s]
        terms += [("T", c) for c in m_t]
        terms += [("F", c) for c in m_f]
        slot_sum = None
        if crypto is not None:
            pins, slot_sum = crypto_slot_constraints(A, beta, delta)
            terms += [("H", c) for c in pins]
        ms_h, ms_t, ms_f, ms_l = memory_multiset(A, beta, delta, d_init,
                                                 slot_sum=slot_sum)
        terms += [("H", ms_h), ("T", ms_t), ("F", ms_f), ("L", ms_l)]
    if io is not None:
        beta, delta, d_io = io
        io_h, io_t, io_f, io_l = io_multiset(A, beta, delta, d_io)
        terms += [("H", io_h), ("T", io_t), ("F", io_f), ("L", io_l)]
    if crypto is not None:
        beta, delta, d_crypto = crypto
        cr_h, cr_t, cr_f, cr_l = crypto_tape_channel(A, beta, delta,
                                                     d_crypto)
        terms += [("H", cr_h), ("T", cr_t), ("F", cr_f), ("L", cr_l)]
    if program is not None:
        beta, gamma, entry = program
        terms.append(("H", program_channel(A, beta, gamma)))
        terms += [("F", c) for c in program_boundary(A, entry)]
    return terms


# ============================================================================
# Public entry points (prover: whole-domain; verifier: one opened point).
# ============================================================================


def _vec_alg(ext_r, ext_i, log_blowup: int, lookup=None, aux=None,
             program=None, memory=None, io=None, crypto=None):
    """The torch ``VecAlg`` over the committed columns, and the keyword
    arguments of ``quotient_terms`` (its challenges), from the
    prover-side arguments of ``quotient_evals``."""
    chan_sums = mem_sum = prog_sum = prog_ext = None
    aux_ext = aux_sums = io_sum = cr_sums = None
    lk = ak = mk = pk = ik = ck = None
    if lookup is not None:
        chan_sums, beta = lookup
        lk = beta
    if aux is not None:
        aux_ext, aux_sums, eta = aux
        ak = (beta, eta)
    if memory is not None:
        mem_sum, delta, d_init = memory
        mk = (beta, delta, d_init)
    if io is not None:
        io_sum, delta_io, d_io = io
        ik = (beta, delta_io, d_io)
    if crypto is not None:
        cr_sums, delta_c, d_crypto = crypto
        ck = (beta, delta_c, d_crypto)
    if program is not None:
        prog_ext, prog_sum, gamma, entry = program
        pk = (beta, gamma, entry)
    A = VecAlg(ext_r, ext_i, log_blowup, chan_sums=chan_sums,
               mem_sum=mem_sum, prog_sum=prog_sum, prog_ext=prog_ext,
               aux_ext=aux_ext, aux_sums=aux_sums, io_sum=io_sum,
               cr_sums=cr_sums)
    return A, dict(lookup=lk, aux=ak, memory=mk, program=pk, io=ik,
                   crypto=ck)


def _vec_terms(ext_r, ext_i, log_blowup: int, lookup, aux, program, memory,
               io, crypto):
    """The torch ``VecAlg`` over the committed columns and every quotient
    term evaluated on it, from the prover-side arguments of
    ``quotient_evals``."""
    A, keys = _vec_alg(ext_r, ext_i, log_blowup, lookup, aux, program,
                       memory, io, crypto)
    return A, quotient_terms(A, **keys)


def quotient_evals(ext_r, ext_i, log_n: int, log_blowup: int,
                   shift: Tuple[int, int], alpha: Tuple[int, int],
                   lookup=None, aux=None, program=None, memory=None,
                   io=None, crypto=None):
    """Q(x) = sum_j alpha^j C_j(x) / D_j(x) on the coset LDE domain, as a
    QM31 4-tuple of [N] tensors on the device of ``ext_r``.

    ``lookup``: optional (s_ext, beta) enabling the LogUp constraints.
    ``aux``: optional (aux_ext, s_aux_ext, eta) enabling the aux-table
    channels (requires ``lookup`` for beta).
    ``program``: optional (prog_ext, s_prog_ext, gamma, entry).
    ``memory``: optional (s_mem_ext, delta, d_init).
    ``io``: optional (s_io_ext, delta, d_io) — the I/O-tape channel.
    ``crypto``: optional (cr_exts, delta, d_crypto) with cr_exts =
    (slot inverses [N_SLOTS], tape S, tape F) — the crypto-syscall
    binding (requires ``memory``).

    CUDA tensors take the generated kernels
    (``quotient_codegen.quotient_evals_cuda``), CPU tensors the plain
    version ``quotient_evals_plain``."""
    args = dict(lookup=lookup, aux=aux, program=program, memory=memory,
                io=io, crypto=crypto)
    if ext_r.is_cuda:
        from .quotient_codegen import quotient_evals_cuda

        return quotient_evals_cuda(ext_r, ext_i, log_n, log_blowup, shift,
                                   alpha, **args)
    return quotient_evals_plain(ext_r, ext_i, log_n, log_blowup, shift,
                                alpha, **args)


def quotient_evals_plain(ext_r, ext_i, log_n: int, log_blowup: int,
                         shift: Tuple[int, int], alpha: Tuple[int, int],
                         lookup=None, aux=None, program=None, memory=None,
                         io=None, crypto=None):
    """``quotient_evals`` as the reference's eager branch, on any device:
    every term evaluated on a torch ``VecAlg`` and accumulated per
    divisor tag."""
    A, terms = _vec_terms(ext_r, ext_i, log_blowup, lookup, aux, program,
                          memory, io, crypto)
    return _accumulate_quotient(A, terms,
                                _alpha_powers_np(alpha, len(terms)),
                                _dinv(log_n, log_blowup, shift,
                                      ext_r.device))


def _dinv(log_n, log_blowup, shift, device):
    """The four divisor inverses as CM31 tensor pairs on ``device``."""
    t = [torch.from_numpy(a.astype(np.int64)).to(device)
         for a in _vanishing_tables(log_n, log_blowup, tuple(shift))]
    return {"H": (t[0], t[1]), "T": (t[2], t[3]), "F": (t[4], t[5]),
            "L": (t[6], t[7])}


def _contract_cm31(xr, xi, pr, pi):
    """sum_k (pr_k + i pi_k) * x_k over CM31 for stacks [K, N] and power
    vectors [K]: one broadcast CM31 product, then one sum over K reduced
    mod p (K < 2^32 words of < 2^31 each cannot overflow int64)."""
    tr, ti = cm31_mul((xr, xi), (pr[:, None], pi[:, None]))
    return tr.sum(dim=0) % P, ti.sum(dim=0) % P


def _accumulate_quotient(A: VecAlg, terms, pw, dinv):
    """sum_j alpha^j C_j / D_j over mixed CM31 (len-2) and QM31 (len-4)
    term values, with the alpha powers precomputed as a [n_terms, 4]
    array ``pw``.  Terms are grouped per divisor tag, the power multiply
    runs as stacked contractions, and each tag group divides once.
    Returns a QM31 4-tuple of [N] tensors."""
    pw = torch.from_numpy(np.asarray(pw, dtype=np.int64)).to(
        A.ext_r.device)
    qzero = tuple(A._zeros() for _ in range(4))
    acc = qzero
    for tag in "HTFL":
        idx_cm = [j for j, (t, c) in enumerate(terms)
                  if t == tag and len(c) == 2]
        idx_qm = [j for j, (t, c) in enumerate(terms)
                  if t == tag and len(c) == 4]
        tag_acc = qzero
        if idx_cm:
            xr = torch.stack([terms[j][1][0] for j in idx_cm])
            xi = torch.stack([terms[j][1][1] for j in idx_cm])
            pa = pw[idx_cm]
            a_out = _contract_cm31(xr, xi, pa[:, 0], pa[:, 1])
            b_out = _contract_cm31(xr, xi, pa[:, 2], pa[:, 3])
            tag_acc = A.qadd(tag_acc,
                             (a_out[0], a_out[1], b_out[0], b_out[1]))
        if idx_qm:
            ar = torch.stack([terms[j][1][0] for j in idx_qm])
            ai = torch.stack([terms[j][1][1] for j in idx_qm])
            br = torch.stack([terms[j][1][2] for j in idx_qm])
            bi = torch.stack([terms[j][1][3] for j in idx_qm])
            pa = pw[idx_qm]
            # (a + b u)(pa + pb u) = (a pa + R b pb) + (a pb + b pa) u
            a_pa = _contract_cm31(ar, ai, pa[:, 0], pa[:, 1])
            b_pb = _contract_cm31(br, bi, pa[:, 2], pa[:, 3])
            a_pb = _contract_cm31(ar, ai, pa[:, 2], pa[:, 3])
            b_pa = _contract_cm31(br, bi, pa[:, 0], pa[:, 1])
            rb = _times_r(b_pb)
            a_out = cm31_add(a_pa, rb)
            b_out = cm31_add(a_pb, b_pa)
            tag_acc = A.qadd(tag_acc,
                             (a_out[0], a_out[1], b_out[0], b_out[1]))
        acc = A.qadd(acc, A.qmul_c(tag_acc, dinv[tag]))
    return acc


def _alpha_powers_np(alpha, n_terms: int) -> np.ndarray:
    from ..ops.qm31 import qm31_mul_scalar

    pw = np.zeros((n_terms, 4), dtype=np.uint32)
    power = (1, 0, 0, 0)
    for k in range(n_terms):
        pw[k] = power
        power = qm31_mul_scalar(power, alpha)
    return pw


def quotient_value_at(row, next_row, n_cols: int, index: int, log_n: int,
                      log_blowup: int, shift: Tuple[int, int],
                      alpha: Tuple[int, int], lookup=None, aux=None,
                      program=None, memory=None, io=None, crypto=None):
    """Scalar Q(x_index) recomputed from opened rows (verifier side).

    ``lookup``: optional (s_row, s_next, beta).
    ``aux``: optional (aux_row, eta); its partial sums are sums columns
    NUM_LOOKUP..NUM_LOOKUP+NUM_AUX.
    ``memory``: optional (delta, d_init); its partial sums are sums
    columns NUM_LOOKUP + NUM_AUX and + 1.
    ``io``: optional (delta, d_io); its partial sums are sums columns
    NUM_LOOKUP + NUM_AUX + 2 and + 3.
    ``crypto``: optional (delta, d_crypto); its slot inverses and tape
    S/F are sums columns NUM_LOOKUP + NUM_AUX + 4 .. + 4 + N_CR_SUMS.
    ``program``: optional (prog_row, gamma, entry); its partial sum is
    the last sums column."""
    s_row = s_next = prog_row = aux_row = None
    n_sums = 0
    lk = ak = mk = pk = ik = ck = None
    if lookup is not None:
        s_row, s_next, beta = lookup
        n_sums = (NUM_LOOKUP
                  + (NUM_AUX if aux is not None else 0)
                  + (2 if memory is not None else 0)
                  + (2 if io is not None else 0)
                  + (N_CR_SUMS if crypto is not None else 0)
                  + (1 if program is not None else 0))
        lk = beta
    if aux is not None:
        aux_row, eta = aux
        ak = (beta, eta)
    if memory is not None:
        delta, d_init = memory
        mk = (beta, delta, d_init)
    if io is not None:
        delta_io, d_io = io
        ik = (beta, delta_io, d_io)
    if crypto is not None:
        delta_c, d_crypto = crypto
        ck = (beta, delta_c, d_crypto)
    if program is not None:
        prog_row, gamma, entry = program
        pk = (beta, gamma, entry)
    A = ScalarAlg(row, next_row, n_cols, s_row=s_row, s_next=s_next,
                  n_sums=n_sums, prog_row=prog_row, aux_row=aux_row)
    terms = quotient_terms(A, lookup=lk, aux=ak, memory=mk, program=pk,
                           io=ik, crypto=ck)

    from ..ops.qm31 import qm31_add_scalar, qm31_mul_cm31_scalar, \
        qm31_mul_scalar

    n = 1 << log_n
    x = cm31_mul_scalar(shift,
                        cm31_pow_scalar(root_of_unity(log_n + log_blowup),
                                        index))
    zh = A.sub(cm31_pow_scalar(x, n), (1, 0))
    last = cm31_pow_scalar(root_of_unity(log_n), n - 1)
    x_last = A.sub(x, last)
    dinv = {
        "H": cm31_inv_scalar(zh),
        "T": cm31_inv_scalar(cm31_mul_scalar(zh, cm31_inv_scalar(x_last))),
        "F": cm31_inv_scalar(A.sub(x, (1, 0))),
        "L": cm31_inv_scalar(x_last),
    }
    acc = (0, 0, 0, 0)
    power = (1, 0, 0, 0)
    for tag, c in terms:
        cq = (c[0], c[1], 0, 0) if len(c) == 2 else c
        term = qm31_mul_scalar(qm31_mul_cm31_scalar(cq, dinv[tag]), power)
        acc = qm31_add_scalar(acc, term)
        power = qm31_mul_scalar(power, alpha)
    return acc


def diagnose_violations(ext_r, ext_i, log_n: int, log_blowup: int,
                        shift: Tuple[int, int], lookup=None, aux=None,
                        program=None, memory=None, io=None, crypto=None,
                        max_report: int = 8) -> str:
    """Name every violated constraint term and its first offending rows.

    Completeness-debug path: called only after ``prove_trace``'s
    self-check has already found nonzero high quotient coefficients, so
    cost does not matter.  For each quotient term the numerator C_j is
    interpolated off the coset LDE (degree <= 3(n-1) < 4n, so the 4n
    coefficients determine it exactly) and re-evaluated on the *plain*
    trace subgroup; nonzero values at the rows the divisor covers mean
    the committed trace violates that constraint there."""
    _, terms = _vec_terms(ext_r, ext_i, log_blowup, lookup, aux, program,
                          memory, io, crypto)

    n = 1 << log_n
    big = 1 << (log_n + log_blowup)
    stride = 1 << log_blowup
    reports = []
    for j, (tag, c) in enumerate(terms):
        # Numerator coefficients from the coset evaluations, then values
        # on the plain subgroup (stride-blowup indices of the big group).
        # QM31 terms: check both CM31 coordinates.
        vals = np.zeros(big // stride, dtype=np.int64)
        for base in range(0, len(c), 2):
            cr, ci = coset_intt(c[base], c[base + 1], log_n + log_blowup,
                                shift=shift)
            vr, vi = ntt(cr, ci, log_n + log_blowup)
            vals |= (vr[::stride].cpu().numpy()
                     | (vi[::stride].cpu().numpy() << 32))
        if tag == "T":
            vals[n - 1] = 0          # transition skips the last row
        elif tag == "F":
            vals[1:] = 0             # first-row constraint: row 0 only
        elif tag == "L":
            vals[:n - 1] = 0         # last-row constraint
        bad = np.nonzero(vals)[0]
        if bad.size:
            reports.append(
                f"term #{j} (divisor {tag}) violated at rows "
                f"{bad[:4].tolist()}{'...' if bad.size > 4 else ''}")
        if len(reports) >= max_report:
            reports.append("... (more)")
            break
    return "; ".join(reports) if reports else \
        "(no per-term violation found on the trace subgroup -- the " \
        "high-coefficient mass may come from a degree overflow)"
