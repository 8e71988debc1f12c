"""Preprocessed auxiliary lookup tables (AND chunks + shift powers).

Host copy of ``zkir_tpu/prover/aux_table.py``'s table layout.  Its
commitment, ``preprocess_aux``, lives in ``prover.py`` beside
``preprocess_program``: both are one LDE and one tree on a device.

Two fixed tables, committed once per ``log_n`` as a deterministic
Merkle tree whose root the verifier recomputes (the same trust model as
the program table, ``prover.preprocess_program``):

  AND table (rows 0..1023): every pair of 5-bit values and their AND —
      columns (ta, tb, tc) with ta = i % 32, tb = i // 32, tc = ta & tb.
      One bitwise table suffices for the whole logical family
      (execute.rs semantics, reference zkir-runtime/src/execute.rs):
          a AND b = c           (looked up chunk-wise)
          a XOR b = a + b - 2c  (carry-free, holds per 20-bit limb)
          a OR  b = a + b - c
  shift table (rows 0..63): the 6-bit shift amounts with their power
      decomposition — columns (ts, td, tpm) with, for s < 40,
      td = s // 10 (which 10-bit chunk of y = 2^s is live) and
      tpm = 2^(s % 10) (its value); for s >= 40, td = 4 and tpm = 0
      (shifts at or beyond the 40-bit width: y = 0).
      Rows >= 64 repeat row 0 (duplicate table entries are harmless in
      LogUp; multiplicities histogram into the first occurrence).

Lookups against these tables are CHALLENGE-COMPRESSED (LogUp witness
w = c0 + eta*c1 + eta^2*c2 vs table t = t0 + eta*t1 + eta^2*t2 with a
transcript challenge eta drawn after the trace commitment): matching
compressed values forces component-wise equality except with
probability ~2/|CM31| per row, so the witness chunks need NO separate
range checks — membership pins them to real table components.
"""

from __future__ import annotations

import numpy as np

N_AUX_COLS = 6
AUX_AND_BASE = 0          # ta, tb, tc
AUX_SHIFT_BASE = 3        # ts, td, tpm


def aux_table_columns(log_n: int) -> np.ndarray:
    """The aux-table column values, uint32 [N_AUX_COLS, 2^log_n].

    Requires log_n >= 10 (the AND table needs 1024 rows — the same
    minimum the staircase range table already imposes)."""
    n = 1 << log_n
    if n < 1024:
        raise ValueError("aux tables need >= 1024 rows")
    cols = np.zeros((N_AUX_COLS, n), dtype=np.uint32)
    i = np.arange(1024, dtype=np.uint32)
    cols[AUX_AND_BASE + 0, :1024] = i % 32
    cols[AUX_AND_BASE + 1, :1024] = i // 32
    cols[AUX_AND_BASE + 2, :1024] = (i % 32) & (i // 32)
    s = np.arange(64, dtype=np.uint32)
    cols[AUX_SHIFT_BASE + 0, :64] = s
    cols[AUX_SHIFT_BASE + 1, :64] = np.where(s < 40, s // 10, 4)
    cols[AUX_SHIFT_BASE + 2, :64] = np.where(s < 40,
                                             (1 << (s % 10)).astype(np.uint32),
                                             0)
    # Rows beyond each table's extent duplicate row 0 of that table:
    # for the AND table that is (0,0,0) == the zero fill; for the shift
    # table row 0 is (0, 0, 1).
    cols[AUX_SHIFT_BASE + 2, 64:] = 1
    return cols


def and_row_index(a_chunk: np.ndarray, b_chunk: np.ndarray) -> np.ndarray:
    """The AND-table row holding the pair (a, b) of 5-bit chunks."""
    return a_chunk + 32 * b_chunk
