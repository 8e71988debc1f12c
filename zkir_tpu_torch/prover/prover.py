"""End-to-end STARK-style trace proof: commitment + constraints + FRI (torch).

Counterpart of ``zkir_tpu/prover/prover.py``: ``prove_trace`` with and
without ``range_lookup=True`` (the full constraint set: in-circuit LogUp
range checks, the aux-table channels, the memory-consistency, I/O-tape and
crypto-tape multisets) and ``program=`` (program binding), and
``verify_trace`` for all of them.  The heavy stages run on the device given
to ``prove_trace``; the transcript, the padding, the witness functions and
the verifier's scalar checks are host copies of the reference's.  Proofs
equal the reference's dict for dict (after a JSON round trip).

Pipeline (on one device, or SPMD on every rank of a ``parallel`` mesh:
with ``mesh=`` each rank extends its block of the columns, the blocks are
resharded to rows for hashing, and the later stages run on every rank
over the gathered extension; ``prove_trace``'s docstring):

1. pad the trace matrix to 2^log_n rows; with ``range_lookup`` fill the
   sorted memory table and append the table and multiplicity columns;
2. low-degree-extend every column onto a *coset* of the larger subgroup
   (CM31 NTT; the coset keeps the trace-domain vanishing polynomial
   invertible at every committed point);
3. commit the extended matrix with a Poseidon2 Merkle tree (root_1);
4. with ``range_lookup``: draw beta, gamma, delta, eta; build the LogUp
   partial-sum columns (compress -> batched inversion -> prefix sums),
   extend and commit them (root_s);
5. draw the constraint combiner alpha_c and evaluate the AIR quotient
   Q = sum alpha_c^j C_j / D_j on the coset (``prover.constraints``);
6. commit Q with its own tree (root_2);
7. draw the batch combiner alpha_b; FRI-prove the combined polynomial
   sum alpha_b^i col_i over the trace, sums and quotient columns;
8. for every FRI query index k open every tree at k, k+half and their
   next-row rotations — the verifier recomputes the batch combination
   (binding FRI to the commitments) AND re-evaluates the constraints,
   checking Q at the opened points.

The reference contains no prover at all (vm.rs:234-243 shapes witness data
for an absent Plonky3-style consumer); this module is that missing stage.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import merkle
from ..ops.field_ops import m31_mul, m31_sub
from ..ops.ntt import (
    _find_generator,
    cm31_mul,
    cm31_mul_scalar,
    cm31_pow_scalar,
    coset_intt,
    coset_ntt,
    lde,
    root_of_unity,
)
from ..ops.qm31 import (cm31_mul_np, exclusive_cumsum4, qm31_add,
                        qm31_add_scalar, qm31_batch_inv, qm31_inv_scaled,
                        qm31_mul_cm31_scalar, qm31_mul_scalar, qm31_powers_np)
from ..parallel.distributed import all_gather_rows, cols_to_rows, dist_lde
from ..spec.field import M31_PRIME
from .aux_table import N_AUX_COLS, aux_table_columns
from .challenger import Challenger
from .constraints import (NUM_AUX, NUM_LOOKUP, diagnose_violations,
                          quotient_evals, quotient_values_at)
from .fri import FriConfig, fri_prove, fri_verify

P = M31_PRIME


class ConstraintViolation(Exception):
    """The trace fed to ``prove_trace`` violates the AIR.

    Raised by the prove-time completeness self-check (the high quotient
    coefficients that chunking would discard are nonzero), with the
    violated constraint term(s) and row(s) named.  Without this check a
    bad trace — or a wrong constraint — produces a "proof" that fails
    only at the verifier."""


def _coset_shift() -> Tuple[int, int]:
    """A point outside every 2-power subgroup: the full-group generator."""
    return _find_generator()


def _pad_rows(matrix: np.ndarray, min_log: int = 2):
    """Pad to 2^log_n rows with EBREAK rows ("a halted machine keeps
    halting"): opcode 0x51, valid one-hot selector blocks, and the final
    row's register file replicated — so the decode, is_seq-lookup,
    register-write-consistency and result-binding constraints all hold
    on padding.

    Requires the final real row to be a halt (EBREAK/ECALL): the
    post-state of a final *writing* row is unobservable, and a final
    branch/jump row has no successor pc, so either would violate an
    honest trace's result-binding / pc-target constraints."""
    from .constraints import (
        COL_CEQ, COL_CLK, COL_OPCODE, COL_RD1H0, COL_REG_LO, COL_RIDX,
        COL_RS1H0, COL_RS2H0, COL_SEL0, COL_SH_D0, COL_SH_PM, COL_SH_Z,
        COL_WIDX, OP_VALUES)
    from .trace import COL_CIDX, COL_CNA0

    n_rows = matrix.shape[0]
    if n_rows > 0 and int(matrix[-1, COL_OPCODE]) not in (0x50, 0x51):
        raise ValueError(
            "trace must end in a halt (ECALL/EBREAK) row; got opcode "
            f"{int(matrix[-1, COL_OPCODE]):#x}")
    if n_rows > 0 and int(matrix[-1, COL_OPCODE]) == 0x50:
        # The halt-chain AIR requires a final ECALL to be EXIT (r10 == 0):
        # non-exit ECALLs advance pc by 4 into a successor row.
        r10 = (int(matrix[-1, COL_REG_LO + 10])
               + (int(matrix[-1, COL_REG_LO + 26]) << 20))
        if r10 != 0:
            raise ValueError(
                "trace must end in a halt: final ECALL row has r10 = "
                f"{r10:#x} (not EXIT)")
    log_n = max((n_rows - 1).bit_length(), min_log)
    if (1 << log_n) == n_rows and matrix.dtype == np.uint32:
        return matrix, log_n        # nothing to pad: no copy either
    padded = np.zeros(((1 << log_n), matrix.shape[1]), dtype=np.uint32)
    padded[:n_rows] = matrix
    if (1 << log_n) > n_rows and n_rows > 0:
        padded[n_rows:, COL_OPCODE] = 0x51
        padded[n_rows:, COL_SEL0 + OP_VALUES.index(0x51)] = 1
        padded[n_rows:, COL_RD1H0] = 1          # rd field 0 -> e_0
        padded[n_rows:, COL_RS1H0] = 1
        padded[n_rows:, COL_RS2H0] = 1
        padded[n_rows:, COL_REG_LO:COL_REG_LO + 32] = \
            matrix[-1, COL_REG_LO:COL_REG_LO + 32]
        # The exec clk chain (clk' = clk + 1) runs through padding.
        padded[n_rows:, COL_CLK] = np.arange(n_rows, 1 << log_n,
                                             dtype=np.uint32)
        # The io tape-index chains run through padding unchanged (the
        # final real row is a halt, so erd = ewr = 0 there and on every
        # EBREAK padding row).
        padded[n_rows:, COL_RIDX] = matrix[-1, COL_RIDX]
        padded[n_rows:, COL_WIDX] = matrix[-1, COL_WIDX]
        padded[n_rows:, COL_CEQ] = 1    # eq gadget: cu = 0 on padding
        padded[n_rows:, COL_SH_Z] = 1   # shq = 0 on padding
        padded[n_rows:, COL_SH_D0] = 1  # shift-table row 0: (0, 0, 1)
        padded[n_rows:, COL_SH_PM] = 1
        padded[n_rows:, COL_CNA0] = 1   # crypto block: nc = 0 one-hot
        padded[n_rows:, COL_CIDX] = matrix[-1, COL_CIDX]
    return padded, log_n


def _initial_cells(program):
    """{cell_index: 64-bit LE value} of the public program's code+data
    segments (the machine's nonzero initial memory)."""
    from ..spec.memlayout import CODE_BASE

    if program is None:
        return {}
    image = bytearray()
    for w in program.code:
        image += int(w).to_bytes(4, "little")
    image += bytes(program.data)
    cells = {}
    for cell_base in range(CODE_BASE & ~7, CODE_BASE + len(image), 8):
        value = 0
        for j in range(8):
            a = cell_base + j - CODE_BASE
            if 0 <= a < len(image):
                value |= image[a] << (8 * j)
        if value:
            cells[cell_base >> 3] = value
    return cells


def _build_memory_table(padded: np.ndarray, n_real: int,
                        program=None) -> None:
    """Fill the (cell, ts)-sorted memory UPDATE table (trace.py
    M_BASE..M_BASE+25) in place: one row per load/store exec row (any
    width) carrying (cell key, 2*clk + 2, old cell bytes, new cell
    bytes); per crypto-syscall row, one read row per input cell at
    2*clk + 1 (bytes unchanged) and 4 digest-write rows at 2*clk + 2;
    plus one ts-0 init row per nonzero code/data cell of the public
    program, sorted by (addr_hi, q, ts); padding rows continue the last
    cell's run as no-op updates (old = new = last bytes, ts advancing).
    Gap chunks cha/chb/chc (3 x 10 bits -> gaps < 2^30) witness the
    strict increase of ts within a run and of the cell key between
    runs."""
    from .constraints import (COL_CLK, COL_MEM_ADDR_HI, COL_MQA, COL_MQB,
                              COL_NB0, COL_OB0, COL_OPCODE, LOAD_OPS,
                              M_AHI, M_CHA, M_CHB, M_CHC, M_CLK, M_HIEQ,
                              M_NB0, M_OB0, M_QA, M_QB, M_REAL, M_SAME,
                              STORE_OPS)
    from .trace import (COL_CBLK, COL_CMORE, COL_CNA0, COL_CRB0,
                        COL_CWD0, COL_CWO0, COL_ECR, N_WRITE_SLOTS)

    n = padded.shape[0]
    op = padded[:n_real, COL_OPCODE]
    rows = np.nonzero(np.isin(op, LOAD_OPS + STORE_OPS))[0]
    init = _initial_cells(program)
    crows = np.nonzero(padded[:n_real, COL_ECR])[0]
    crypto_rows = []     # (q, ahi, ts, ob[8], nb[8]) per slot row
    for r in crows:
        nc = int(np.nonzero(padded[r, COL_CNA0:COL_CNA0 + 8])[0][0])
        clk = int(padded[r, COL_CLK])
        cblk = int(padded[r, COL_CBLK])
        more = int(padded[r, COL_CMORE])
        r11 = (int(padded[r, 8 + 11]) + (int(padded[r, 24 + 11]) << 20))
        r13 = (int(padded[r, 8 + 13]) + (int(padded[r, 24 + 13]) << 20))
        for s in range(nc):
            cell = (r11 >> 3) + 7 * cblk + s
            b = [int(padded[r, COL_CRB0 + 8 * s + j]) for j in range(8)]
            crypto_rows.append((cell & 0x1FFFF, cell >> 17,
                                2 * clk + 1, b, b))
        if more:
            continue        # digest writes fire on the final chunk only
        for s in range(N_WRITE_SLOTS):
            cell = (r13 >> 3) + s
            ob = [int(padded[r, COL_CWO0 + 8 * s + j]) for j in range(8)]
            nb = [int(padded[r, COL_CWD0 + 8 * s + j]) for j in range(8)]
            crypto_rows.append((cell & 0x1FFFF, cell >> 17,
                                2 * clk + 2, ob, nb))
    k = len(rows) + len(init) + len(crypto_rows)
    if k > n:
        raise ValueError(
            f"memory table needs {k} rows (exec memory ops + crypto "
            f"slots + program init cells) but the padded trace has only "
            f"{n}; re-prove with a larger padding size")

    t_q = np.zeros(n, dtype=np.int64)
    t_ah = np.zeros(n, dtype=np.int64)
    t_clk = np.zeros(n, dtype=np.int64)
    t_ob = np.zeros((n, 8), dtype=np.uint32)
    t_nb = np.zeros((n, 8), dtype=np.uint32)
    ke = len(rows)
    if ke:
        t_q[:ke] = (padded[rows, COL_MQA].astype(np.int64)
                    + (padded[rows, COL_MQB].astype(np.int64) << 10))
        t_ah[:ke] = padded[rows, COL_MEM_ADDR_HI].astype(np.int64)
        t_clk[:ke] = 2 * padded[rows, COL_CLK].astype(np.int64) + 2
        for j in range(8):
            t_ob[:ke, j] = padded[rows, COL_OB0 + j]
            t_nb[:ke, j] = padded[rows, COL_NB0 + j]
    for i, (cq, cah, ts, ob, nb) in enumerate(crypto_rows):
        r = ke + i
        t_q[r], t_ah[r], t_clk[r] = cq, cah, ts
        for j in range(8):
            t_ob[r, j] = ob[j]
            t_nb[r, j] = nb[j]
    ke += len(crypto_rows)
    for i, (cell, value) in enumerate(sorted(init.items())):
        r = ke + i
        t_q[r] = cell & 0x1FFFF
        t_ah[r] = cell >> 17
        t_clk[r] = 0
        for j in range(8):
            t_nb[r, j] = (value >> (8 * j)) & 0xFF
    if k:
        order = np.lexsort((t_clk[:k], t_q[:k], t_ah[:k]))
        t_q[:k], t_ah[:k], t_clk[:k] = (t_q[:k][order], t_ah[:k][order],
                                        t_clk[:k][order])
        t_ob[:k] = t_ob[:k][order]
        t_nb[:k] = t_nb[:k][order]
        # padding: continue the last run with no-op updates
        t_q[k:], t_ah[k:] = t_q[k - 1], t_ah[k - 1]
        t_clk[k:] = t_clk[k - 1] + np.arange(1, n - k + 1)
        t_ob[k:] = t_nb[k - 1]
        t_nb[k:] = t_nb[k - 1]
    else:
        t_clk[:] = np.arange(n)
    same = np.zeros(n, dtype=np.uint32)
    hieq = np.zeros(n, dtype=np.uint32)
    same[1:] = ((t_q[1:] == t_q[:-1]) & (t_ah[1:] == t_ah[:-1])) \
        .astype(np.uint32)
    hieq[1:] = (t_ah[1:] == t_ah[:-1]).astype(np.uint32)
    gap = np.zeros(n, dtype=np.int64)
    gap[1:] = np.where(
        same[1:] == 1, t_clk[1:] - t_clk[:-1] - 1,
        np.where(hieq[1:] == 1, t_q[1:] - t_q[:-1] - 1,
                 t_ah[1:] - t_ah[:-1] - 1))
    if k and not ((gap[1:] >= 0).all() and (gap[1:] < 1 << 30).all()):
        at = int(np.nonzero((gap[1:] < 0) | (gap[1:] >= 1 << 30))[0][0]) + 1
        raise ValueError(
            "memory-consistency completeness limit: the gap between "
            f"consecutive sorted-table rows {at - 1} and {at} "
            f"(cell {int(t_ah[at]):#x}:{int(t_q[at]):#x}, clk "
            f"{int(t_clk[at])}) exceeds the 30-bit gap-chunk budget.  "
            "Two accesses to the same cell must be < 2^30 rows apart "
            "(insert a refresh load, or split the trace); cell runs "
            "must start < 2^30 above the previous run's key limb")
    padded[:, M_QA] = (t_q & 1023).astype(np.uint32)
    padded[:, M_QB] = (t_q >> 10).astype(np.uint32)
    padded[:, M_AHI] = t_ah.astype(np.uint32)
    padded[:, M_CLK] = t_clk.astype(np.uint32)
    for j in range(8):
        padded[:, M_OB0 + j] = t_ob[:, j]
        padded[:, M_NB0 + j] = t_nb[:, j]
    padded[:, M_REAL] = (np.arange(n) < k).astype(np.uint32)
    padded[:, M_SAME], padded[:, M_HIEQ] = same, hieq
    padded[:, M_CHA] = (gap & 1023).astype(np.uint32)
    padded[:, M_CHB] = ((gap >> 10) & 1023).astype(np.uint32)
    padded[:, M_CHC] = (gap >> 20).astype(np.uint32)


# ----------------------------------------------------------------------
# Device-side QM31 LogUp helpers: the compress -> batch-invert ->
# prefix-sum pipeline of every partial sum, on int64 tensors over the
# port's field layer.  Challenges are QM31 (the degree-4 extension).
#
# The padded matrix crosses to the device once, as columns ``cols``
# [n_cols, n]; every per-row tuple component below is a row of it or a few
# exact int64 operations on rows (sums and products stay below 2^63, as
# the reference's host uint64 arithmetic does), so nothing is built on the
# host or uploaded again.
# ----------------------------------------------------------------------


def _words(arr, device):
    """A host array of words below 2^32 as an int64 tensor on ``device``
    (uint32 crosses as 4-byte words and is widened there)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).to(device).to(
            torch.int64) & 0xFFFFFFFF
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def _beta_minus_compress(components, beta, delta):
    """(beta - sum_k comp_k delta^k) over QM31 for a list of M31-valued
    int64 tensors of one shape: a QM31 4-tuple of tensors of that shape.

    The components are stacked; each coordinate is then one broadcast
    product with the column of delta powers and one sum over the
    components, reduced mod p (a product is below 2^62 and a few hundred
    of them cannot overflow int64) — the words that
    ``_beta_minus_compress_np`` accumulates one component at a time."""
    comp = torch.stack(components) % P
    pw = np.zeros((len(components), 4), dtype=np.int64)
    power = (1, 0, 0, 0)
    for k in range(len(components)):
        pw[k] = [x % P for x in power]
        power = qm31_mul_scalar(power, delta)
    pw = torch.from_numpy(pw).to(comp.device).reshape(
        len(components), 4, *([1] * (comp.dim() - 1)))
    return tuple(m31_sub(int(beta[k]) % P,
                         m31_mul(comp, pw[:, k]).sum(dim=0) % P)
                 for k in range(4))


def _beta_minus_compress_np(components, beta, delta):
    """(beta - sum_k comp_k delta^k) as a host uint32 [4, ...] array: one
    uint64 multiply-accumulate per component and coordinate.  The public
    demands use it (a handful of entries on the host); the per-row
    columns take ``_beta_minus_compress``."""
    c0 = np.asarray(components[0], dtype=np.uint64) % P
    acc = [c0.copy(), np.zeros_like(c0), np.zeros_like(c0),
           np.zeros_like(c0)]
    pw = delta
    for c in components[1:]:
        cj = np.asarray(c, dtype=np.uint64) % P
        for k in range(4):
            if pw[k] % P:
                acc[k] = (acc[k] + cj * (pw[k] % P)) % P
        pw = qm31_mul_scalar(pw, delta)
    return np.stack([((beta[k] - acc[k].astype(np.int64)) % P)
                     .astype(np.uint32) for k in range(4)])


def _masked_inv_kernel(bw4, mask):
    """mask / bw over QM31 (batched inversion; zero maps to zero): one
    ``qm31_inv_scaled`` on a GPU."""
    return qm31_inv_scaled(bw4, mask)


def _qm31_inv_sum_kernel(w4):
    """sum_j 1/w_j over QM31 for a 4-tuple of [m] vectors, as host ints
    (the public demand computations)."""
    return tuple(int(c.sum() % P) for c in qm31_batch_inv(w4))


def _mem_tuple_components(cols):
    """(exec components, table components), 19 [n] tensors each, of the
    memory update tuples: (q, addr_hi, ts = 2*clk + 2, ob0-7, nb0-7)."""
    from .constraints import (COL_CLK, COL_MEM_ADDR_HI, COL_MQA, COL_MQB,
                              COL_NB0, COL_OB0, M_AHI, M_CLK, M_NB0,
                              M_OB0, M_QA, M_QB)

    w = [cols[COL_MQA] + (cols[COL_MQB] << 10), cols[COL_MEM_ADDR_HI],
         2 * cols[COL_CLK] + 2]
    w += [cols[COL_OB0 + j] for j in range(8)]
    w += [cols[COL_NB0 + j] for j in range(8)]
    t = [cols[M_QA] + (cols[M_QB] << 10), cols[M_AHI], cols[M_CLK]]
    t += [cols[M_OB0 + j] for j in range(8)]
    t += [cols[M_NB0 + j] for j in range(8)]
    return w, t


def memory_init_demand(program, beta, delta, *, device):
    """The verifier-computable init-demand scalar: sum over the public
    program's nonzero code/data cells of 1/(beta - compress(cell tuple))
    where the tuple is (q, addr_hi, clk=0, old bytes=0, new bytes=cell
    bytes) — the clk-0 init rows the prover placed in the table.
    Returns a QM31 4-tuple; zero when there is no program."""
    init = _initial_cells(program)
    if not init:
        return (0, 0, 0, 0)
    cells = sorted(init.items())
    m = len(cells)
    comp = [np.zeros(m, dtype=np.uint32) for _ in range(19)]
    for i, (cell, value) in enumerate(cells):
        comp[0][i] = cell & 0x1FFFF
        comp[1][i] = cell >> 17
        for j in range(8):
            comp[11 + j][i] = (value >> (8 * j)) & 0xFF
    bw = _beta_minus_compress_np(comp, beta, delta)
    return _qm31_inv_sum_kernel(tuple(_words(r, device) for r in bw))


def _memory_partial_sum_kernel(w4, t4, v, real):
    """term = v/w - real/t per row (one ``qm31_inv_scaled``), with its
    exclusive prefix sums (one ``exclusive_cumsum4``)."""
    term = qm31_inv_scaled(w4, v, t4, real, subtract=True)
    return exclusive_cumsum4(term), term


def _memory_partial_sum(cols, beta, delta):
    """The memory-update multiset's per-row term F (QM31 4-tuple [n]),
    F_i = v_i/(beta - w_i) - real_i/(beta - t_i), whose exclusive prefix
    sums are the partial-sum column S:

    s[0] = 0; s[i+1] = s[i] + F_i

    where w/t delta-compress the 19-component exec-row and table update
    tuples; the telescope closes against -d_init at the last row
    (boundary constraint, constraints.memory_multiset).  Only F is
    returned: the sums columns add the crypto slots' demands to F before
    they scan it (``_sums_columns``)."""
    from .constraints import COL_OPCODE, LOAD_OPS, M_REAL, STORE_OPS

    w_comp, t_comp = _mem_tuple_components(cols)
    w4 = _beta_minus_compress(w_comp, beta, delta)
    t4 = _beta_minus_compress(t_comp, beta, delta)
    mem_ops = torch.tensor(LOAD_OPS + STORE_OPS, dtype=torch.int64,
                           device=cols.device)
    v = torch.isin(cols[COL_OPCODE], mem_ops).to(torch.int64)
    return qm31_inv_scaled(w4, v, t4, cols[M_REAL], subtract=True)


def _observe_io(challenger, inputs, outputs) -> None:
    """Feed the claimed I/O tapes into the Fiat-Shamir transcript
    (identically on prover and verifier)."""
    challenger.observe(len(inputs))
    for v in inputs:
        challenger.observe(v & 0xFFFFF)
        challenger.observe((v >> 20) & 0xFFFFF)
    challenger.observe(len(outputs))
    for v in outputs:
        challenger.observe(v & 0xFFFFF)
        challenger.observe((v >> 20) & 0xFFFFF)


def extract_io(matrix: np.ndarray):
    """The claimed public I/O tapes read off a trace matrix: (inputs
    consumed, outputs written), each a list of 40-bit ints in tape
    order.  ``inputs`` is the CONSUMED read sequence — reads past the
    provided tape's end appear as trailing zeros (syscall.rs:54-62)."""
    op = matrix[:, 2]
    r10 = (matrix[:, 8 + 10].astype(np.uint64)
           + (matrix[:, 24 + 10].astype(np.uint64) << 20))
    r11 = (matrix[:, 8 + 11].astype(np.uint64)
           + (matrix[:, 24 + 11].astype(np.uint64) << 20))
    is_ec = op == 0x50
    rd_rows = np.nonzero(is_ec & (r10 == 1))[0]
    wr_rows = np.nonzero(is_ec & (r10 == 2))[0]
    inputs = [int(r10[i + 1]) for i in rd_rows]   # next-row R10 = result
    outputs = [int(r11[i]) for i in wr_rows]
    return inputs, outputs


def io_tape_demand(inputs, outputs, beta, delta, *, device):
    """The verifier-computable I/O demand: sum over the claimed tapes of
    1/(beta - (tag + idx*delta + lo*delta^2 + hi*delta^3)) with tag 1
    for inputs and 2 for outputs (matching constraints.io_multiset).
    Returns a QM31 4-tuple; zero for empty tapes."""
    entries = ([(1, i, v) for i, v in enumerate(inputs)]
               + [(2, j, v) for j, v in enumerate(outputs)])
    if not entries:
        return (0, 0, 0, 0)
    m = len(entries)
    comp = [np.zeros(m, dtype=np.uint32) for _ in range(4)]
    for r, (tag, idx, v) in enumerate(entries):
        comp[0][r] = tag
        comp[1][r] = idx
        comp[2][r] = v & 0xFFFFF
        comp[3][r] = (v >> 20) & 0xFFFFF
    bw = _beta_minus_compress_np(comp, beta, delta)
    return _qm31_inv_sum_kernel(tuple(_words(r, device) for r in bw))


def _two_sided_sum_kernel(wr4, ww4, num_r, num_w):
    """F = num_r/(wr) + num_w/(ww) per row, with its exclusive prefix
    sums (both QM31)."""
    term = qm31_inv_scaled(wr4, num_r, ww4, num_w)
    return exclusive_cumsum4(term), term


def _io_partial_sum(cols, beta, delta):
    """The I/O multiset partial-sum (S, exclusive) and per-row term (F)
    columns (QM31 4-tuples, [n] each): F_i = erd_i/(beta - wr_i)
    + ewr_i/(beta - ww_i) with wr/ww the delta-compressed READ/WRITE
    tuples of constraints.io_multiset."""
    from .constraints import COL_ERD, COL_EWR, COL_RIDX, COL_WIDX

    one = torch.ones_like(cols[0])
    wr_comp = [one, cols[COL_RIDX],
               torch.roll(cols[8 + 10], -1), torch.roll(cols[24 + 10], -1)]
    ww_comp = [2 * one, cols[COL_WIDX], cols[8 + 11], cols[24 + 11]]
    wr4 = _beta_minus_compress(wr_comp, beta, delta)
    ww4 = _beta_minus_compress(ww_comp, beta, delta)
    return _two_sided_sum_kernel(wr4, ww4, cols[COL_ERD], cols[COL_EWR])


def extract_crypto_tape(matrix: np.ndarray):
    """The claimed public crypto tape read off a trace matrix: one
    entry per crypto CHUNK ROW (in cidx order) of
    ``(num, len, more, msg_bytes)`` where len is THIS chunk's byte
    count (8*nc - pad), ``more`` flags a non-final chunk, and msg_bytes
    are the 56 committed input-cell bytes (zero beyond the active
    slots; the chunk's hash input is ``msg_bytes[:len]``).  A chain's
    full message is the concatenation of its consecutive entries."""
    from .trace import (COL_CMORE, COL_CNA0, COL_CPAD, COL_CRB0, COL_ECR,
                        N_READ_SLOTS)

    rows = np.nonzero(matrix[:, COL_ECR])[0]
    entries = []
    for r in rows:
        num = int(matrix[r, 8 + 10])
        nc = int(np.nonzero(matrix[r, COL_CNA0:COL_CNA0 + 8])[0][0])
        ln = 8 * nc - int(matrix[r, COL_CPAD])
        msg = [int(matrix[r, COL_CRB0 + k])
               for k in range(8 * N_READ_SLOTS)]
        entries.append({"num": num, "len": ln,
                        "more": int(matrix[r, COL_CMORE]), "msg": msg})
    return entries


def crypto_tape_demand(entries, beta, delta, *, device):
    """The VERIFIER-computed crypto-tape demand.  Entries are per
    CHUNK ROW; consecutive entries with ``more = 1`` chain into one
    logical message (multi-block hashing — trace.py layout comment at
    CR_BASE), whose digest is RECOMPUTED from the claimed chunk bytes
    (trace.crypto_digest) and demanded on the FINAL entry (non-final
    entries demand all-zero digest bytes, matching the pinned-zero
    write slots) — so an accepted proof attests that every crypto
    syscall's in-memory digest is the true hash of its full in-memory
    input, however many chunks it spans.  Returns a QM31 4-tuple; zero
    for an empty tape; None (reject) for a malformed claimed tape."""
    from .trace import CRYPTO_MAX_LEN, N_READ_SLOTS, crypto_digest

    if not entries:
        return (0, 0, 0, 0)
    m = len(entries)
    n_comp = 4 + 8 * N_READ_SLOTS + 32
    comp = [np.zeros(m, dtype=np.uint32) for _ in range(n_comp)]
    acc = bytearray()      # current chain's accumulated message
    acc_num = None
    for i, e in enumerate(entries):
        num, ln = int(e["num"]), int(e["len"])
        more = int(e.get("more", 0))
        msg = [int(b) for b in e["msg"]]
        if not (3 <= num <= 6) or not (0 <= ln <= CRYPTO_MAX_LEN) \
                or more not in (0, 1) \
                or len(msg) != 8 * N_READ_SLOTS \
                or any(not 0 <= b < 256 for b in msg):
            return None  # malformed claimed tape -> reject
        if acc_num is not None and num != acc_num:
            return None  # a chain cannot change algorithm mid-way
        if more and ln != CRYPTO_MAX_LEN:
            return None  # non-final chunks carry exactly 56 bytes
        acc += bytes(msg[:ln])
        acc_num = num
        digest = b"\x00" * 32 if more else crypto_digest(num, bytes(acc))
        if not more:
            acc = bytearray()
            acc_num = None
        comp[0][i] = num
        comp[1][i] = i
        comp[2][i] = ln
        comp[3][i] = more
        for k in range(8 * N_READ_SLOTS):
            comp[4 + k][i] = msg[k]
        for k in range(32):
            comp[4 + 8 * N_READ_SLOTS + k][i] = digest[k]
    if acc_num is not None:
        return None  # dangling chain (last entry claims more)
    bw = _beta_minus_compress_np(comp, beta, delta)
    return _qm31_inv_sum_kernel(tuple(_words(r, device) for r in bw))


def _observe_crypto(challenger, entries) -> None:
    """Feed the claimed crypto tape into the Fiat-Shamir transcript
    (identically on prover and verifier)."""
    challenger.observe(len(entries))
    for e in entries:
        challenger.observe(int(e["num"]))
        challenger.observe(int(e["len"]))
        challenger.observe(int(e.get("more", 0)))
        challenger.observe_many(int(b) for b in e["msg"])


def _crypto_slot_inverses(cols, beta, delta):
    """The committed phase-2 slot-inverse columns (QM31 4-tuple
    [N_SLOTS, n]): inv_s = active_s / (beta - w_s) with w_s the
    delta-compressed 19-component slot tuple (constraints.
    crypto_slot_constraints).  Their per-row sum joins the memory F
    column."""
    from .constraints import COL_CLK, N_SLOTS
    from .trace import (COL_CBLK, COL_CMORE, COL_CNA0, COL_CRB0, COL_CRC0,
                        COL_CRC1, COL_CWC1, COL_CWD0, COL_CWO0, COL_ECR,
                        N_READ_SLOTS)

    inv8 = pow(8, P - 2, P)
    clk = cols[COL_CLK]
    na = cols[COL_CNA0:COL_CNA0 + 8]
    cblk7 = 7 * cols[COL_CBLK]
    elast = (cols[COL_ECR] - cols[COL_CMORE]) % P
    w_stack = []     # per-slot component lists
    act_stack = []
    for s in range(N_SLOTS):
        if s < N_READ_SLOTS:
            i = s
            lo, hi = cols[8 + 11], cols[24 + 11]
            carry = cols[COL_CRC0] if i == 0 else cols[COL_CRC1 + i - 1]
            ts = 2 * clk + 1
            ob = [cols[COL_CRB0 + 8 * i + j] for j in range(8)]
            nb = ob
            offset = cblk7 + i
            active = na[i + 1:].sum(dim=0)
        else:
            i = s - N_READ_SLOTS
            lo, hi = cols[8 + 13], cols[24 + 13]
            carry = (torch.zeros_like(clk) if i == 0
                     else cols[COL_CWC1 + i - 1])
            ts = 2 * clk + 2
            ob = [cols[COL_CWO0 + 8 * i + j] for j in range(8)]
            nb = [cols[COL_CWD0 + 8 * i + j] for j in range(8)]
            offset = i
            active = elast
        q_s = (lo * inv8 + offset + (P - ((carry << 17) % P))) % P
        ahi_s = (hi + carry) % P
        w_stack.append([q_s, ahi_s, ts] + ob + nb)
        act_stack.append(active)
    comp_mats = [torch.stack([w_stack[s][c] for s in range(N_SLOTS)])
                 for c in range(19)]
    bw4 = _beta_minus_compress(comp_mats, beta, delta)
    return _masked_inv_kernel(bw4, torch.stack(act_stack))


def _crypto_tape_partial_sum(cols, beta, delta):
    """The crypto-tape channel's S (exclusive partial sums) and F
    (per-row term ecr/(beta - w_tape)) columns (QM31 4-tuples [n])."""
    from .trace import (COL_CIDX, COL_CMORE, COL_CNA0, COL_CPAD,
                        COL_CRB0, COL_CWD0, COL_ECR, N_READ_SLOTS,
                        N_WRITE_SLOTS)

    num = cols[8 + 10] * cols[COL_ECR]   # R10 low limb on crypto rows
    # (= b0 + 2 b1 + 4 b2 there), zero elsewhere.
    nc = (cols[COL_CNA0:COL_CNA0 + 8]
          * torch.arange(8, device=cols.device)[:, None]).sum(dim=0)
    ln = (8 * nc - cols[COL_CPAD]) % P
    comps = [num, cols[COL_CIDX], ln, cols[COL_CMORE]]
    comps += [cols[COL_CRB0 + k] for k in range(8 * N_READ_SLOTS)]
    comps += [cols[COL_CWD0 + k] for k in range(8 * N_WRITE_SLOTS)]
    bw4 = _beta_minus_compress(comps, beta, delta)
    f4 = _masked_inv_kernel(bw4, cols[COL_ECR])
    return exclusive_cumsum4(f4), f4


def _channel_witnesses(padded: np.ndarray) -> np.ndarray:
    """Evaluate every CHANNELS affine witness over the trace rows:
    uint32 [n_channels, n] (values in [0, p))."""
    from .constraints import CHANNELS

    n = padded.shape[0]
    out = np.zeros((len(CHANNELS), n), dtype=np.uint32)
    for k, (_, const, terms) in enumerate(CHANNELS):
        acc = np.full(n, const % P, dtype=np.uint64)
        for c, coef in terms:
            acc = (acc + padded[:, c].astype(np.uint64) * (coef % P)) % P
        out[k] = acc.astype(np.uint32)
    return out


def _build_lookup_columns(padded: np.ndarray, witnesses: np.ndarray):
    """The columns that ``range_lookup`` appends to the trace, uint32
    [n, 1 + n_channels + NUM_AUX]: the table column t_i = min(i, 1023), one
    multiplicity histogram per lookup channel (of ``witnesses``, from
    ``_channel_witnesses``), and one per aux-table channel (all
    challenge-independent -> phase 1)."""
    from .constraints import AUX_CHANNELS

    n = padded.shape[0]
    assert n >= 1024, "range lookup needs >= 1024 rows (full table)"
    t_col = np.minimum(np.arange(n), 1023).astype(np.uint32)
    m_cols = [
        np.bincount(w, minlength=n)[:n].astype(np.uint32)
        for w in witnesses
    ]
    for _, _, _, idx_terms in AUX_CHANNELS:
        idx = np.zeros(n, dtype=np.int64)
        for c, coef in idx_terms:
            idx += padded[:, c].astype(np.int64) * coef
        if (idx < 0).any() or (idx >= n).any():
            raise ValueError("aux-channel witness outside its table")
        m_cols.append(np.bincount(idx, minlength=n)[:n].astype(np.uint32))
    return np.stack([t_col] + m_cols, axis=1)


def _channel_sum_kernel(witnesses, t, m, beta):
    """All plain lookup channels at once: witnesses [n_ch, n], table t
    [n], multiplicities m [n_ch, n], beta a host QM31 4-tuple.
    Term: 1/(beta - w) - m/(beta - t); S = exclusive cumsum.  beta's
    coordinates 1-3 are constants, and t is one row for every channel
    (``qm31_inv_scaled`` inverts it once per column)."""
    n_ch = witnesses.shape[0]
    d0 = m31_sub(int(beta[0]) % P, torch.cat([witnesses, t[None, :]]))
    rest = tuple(int(beta[k]) % P for k in range(1, 4))
    term = qm31_inv_scaled((d0[:n_ch], *rest), 1, (d0[n_ch:], *rest), m,
                           subtract=True)
    return exclusive_cumsum4(term), term


def _build_partial_sums(cols, witnesses, beta):
    """The LogUp partial-sum columns on the trace domain (QM31
    4-tuples [n_ch, n]), one per channel of ``witnesses`` [n_ch, n]:

    s_k[0] = 0; s_k[i+1] = s_k[i] + 1/(beta - w_k[i]) - m_k[i]/(beta - t_i).
    """
    from .constraints import COL_MULT0, COL_TABLE

    n_ch = witnesses.shape[0]
    (s4, _f4) = _channel_sum_kernel(
        witnesses, cols[COL_TABLE], cols[COL_MULT0:COL_MULT0 + n_ch], beta)
    return s4


def _build_aux_partial_sums(cols, aux_cols, beta, eta):
    """The aux-table channels' LogUp partial-sum columns (QM31 4-tuples,
    [NUM_AUX, n]): witness and table triples are eta-compressed
    (aux_table.py), so both sides are QM31-valued.  ``aux_cols``: the
    aux-table columns [N_AUX_COLS, n] on the device."""
    from .constraints import AUX_CHANNELS, COL_AUXM0

    w_comp = [[], [], []]     # component j: one [n] tensor per channel
    t_comp = [[], [], []]
    for _, wspecs, t_base, _idx in AUX_CHANNELS:
        for j, terms in enumerate(wspecs):
            acc = torch.zeros_like(cols[0])
            for c, coef in terms:
                acc = (acc + cols[c] * coef) % P
            w_comp[j].append(acc)
            t_comp[j].append(aux_cols[t_base + j])
    bw4 = _beta_minus_compress([torch.stack(c) for c in w_comp], beta, eta)
    bt4 = _beta_minus_compress([torch.stack(c) for c in t_comp], beta, eta)
    (s4, _f4) = _aux_sum_kernel(
        bw4, bt4, cols[COL_AUXM0:COL_AUXM0 + NUM_AUX])
    return s4


def _aux_sum_kernel(bw4, bt4, m):
    """term = 1/bw - m/bt per channel and row, and S = exclusive cumsum."""
    term = qm31_inv_scaled(bw4, 1, bt4, m, subtract=True)
    return exclusive_cumsum4(term), term


CODE_BASE = 0x1000
_M20 = (1 << 20) - 1


def _program_table(code_words, log_n: int) -> np.ndarray:
    """The preprocessed program table, uint32 [4, n]: per instruction i at
    pc = CODE_BASE + 4i the tuple (pc_lo, pc_hi, word & 0x7FFF,
    word >> 15); rows beyond the program hold the halt entry
    (0, 0, EBREAK, 0) that padding rows consume."""
    n = 1 << log_n
    n_code = len(code_words)
    if n_code + 1 > n:
        raise ValueError("program binding needs n_rows >= n_code + 1")
    cols = np.zeros((4, n), dtype=np.uint32)
    words = np.asarray(code_words, dtype=np.uint64)
    pcs = CODE_BASE + 4 * np.arange(n_code, dtype=np.uint64)
    cols[0, :n_code] = pcs & _M20
    cols[1, :n_code] = (pcs >> 20) & _M20
    cols[2, :n_code] = words & 0x7FFF
    cols[3, :n_code] = words >> 15
    cols[2, n_code:] = 0x51
    return cols


def _preprocess(cols: np.ndarray, log_n: int, log_blowup: int, device):
    """Deterministic preprocessed commitment of table columns [C, n]: LDE
    onto the proof coset + Poseidon2 Merkle tree.  ``cols_dev``, ``ext``
    and ``rows`` (the committed [N, 2C] matrix) stay on ``device``;
    openings gather the queried rows from there."""
    cols_dev = _words(cols, device)
    ext_r, ext_i = lde(cols_dev, None, log_n, log_blowup,
                       shift=_coset_shift())
    rows = _interleave_rows(ext_r, ext_i)
    levels = merkle.to_host(merkle.build_tree_fused(merkle.hash_rows(rows)))
    return {
        "cols": cols,
        "cols_dev": cols_dev,
        "ext": (ext_r, ext_i),
        "rows": rows,
        "levels": levels,
        "root": [int(x) for x in merkle.root(levels)],
    }


@functools.lru_cache(maxsize=8)
def _preprocess_aux_cached(log_n: int, log_blowup: int, device: str):
    return _preprocess(aux_table_columns(log_n), log_n, log_blowup, device)


def preprocess_aux(log_n: int, log_blowup: int, *, device):
    """Deterministic preprocessed commitment of the aux tables for a
    trace size.  The root is a deterministic function of (log_n,
    log_blowup), so the verifier recomputes it (cached per device) rather
    than trusting the proof.  The cache is keyed by the device with its
    index resolved, so ``cuda`` and ``cuda:0`` share one entry."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _preprocess_aux_cached(int(log_n), int(log_blowup), str(device))


def preprocess_program(code_words, log_n: int,
                       fri_config: FriConfig = FriConfig(), *, device):
    """Deterministic preprocessed commitment of a program: LDE the table
    columns onto the proof coset and Merkle-commit them.  The root is the
    PUBLIC INPUT binding proofs to this program — verifiers recompute it
    per (program, log_n) and compare."""
    return _preprocess(_program_table(code_words, log_n), log_n,
                       fri_config.log_blowup, device)


def _program_multiplicity(padded: np.ndarray, n_real: int,
                          n_code: int) -> np.ndarray:
    """Executions per program row (+ padding count on the halt entry)."""
    from .constraints import COL_PC_HI, COL_PC_LO

    n = padded.shape[0]
    pc = (padded[:, COL_PC_LO].astype(np.int64)
          + (padded[:, COL_PC_HI].astype(np.int64) << 20))
    idx = (pc - CODE_BASE) >> 2
    idx[n_real:] = n_code                     # padding -> halt entry
    if ((idx < 0) | (idx >= n)).any():
        raise ValueError("trace pc outside the program table")
    return np.bincount(idx, minlength=n)[:n].astype(np.uint32)


def _program_partial_sum(cols, prog_cols, beta, gamma):
    """The program-channel LogUp partial-sum column (QM31 4-tuple [n]):
    term = 1/(beta - w) - m/(beta - t) with the gamma-compressed
    (pc, field, imm) tuples of constraints.program_channel.
    ``prog_cols``: the program table [4, n] on the device."""
    from .constraints import COL_IMM_LO, COL_PC_HI, COL_PC_LO, COL_PROG_M, \
        PROG_F_TERMS

    f_trace = torch.zeros_like(cols[0])
    for c, coef in PROG_F_TERMS:
        f_trace = (f_trace + cols[c] * coef) % P

    bw4 = _beta_minus_compress(
        [cols[COL_PC_LO], cols[COL_PC_HI], f_trace, cols[COL_IMM_LO]],
        beta, gamma)
    bt4 = _beta_minus_compress(list(prog_cols[:4]), beta, gamma)
    m = cols[COL_PROG_M]
    # term = 1/(beta - w) - m/(beta - t): the memory kernel's shape.
    (s4, _f4) = _memory_partial_sum_kernel(bw4, bt4, 1, m)
    return s4


def _combine_kernel(ar, ai, pw_r, pw_i):
    """sum_c pw_c * col_c over CM31 for columns [C, N] and power vectors
    [C]: one broadcast CM31 product, then one sum over C reduced mod p (the
    order of a field sum does not matter; C words of < 2^31 each cannot
    overflow int64)."""
    tr, ti = cm31_mul((ar, ai), (pw_r[:, None], pw_i[:, None]))
    return tr.sum(dim=0) % P, ti.sum(dim=0) % P


def _batch_powers(n_total: int, alpha, device) -> torch.Tensor:
    """alpha^0 .. alpha^(n_total - 1) of a QM31 alpha as int64 [n_total, 4]
    on ``device``: the batch combination's weights, one per committed
    column in batch order."""
    pw = np.zeros((n_total, 4), dtype=np.int64)
    power = (1, 0, 0, 0)
    for k in range(n_total):
        pw[k] = power
        power = qm31_mul_scalar(power, alpha)
    return torch.from_numpy(pw).to(device)


def _combine_block(re, im, pw):
    """sum_c pw_c col_c for CM31 columns [C, N] and QM31 weights pw
    [C, 4]: the QM31 4-tuple of [N] tensors, its a/b coordinates each one
    run of the CM31 combine kernel."""
    return (*_combine_kernel(re, im, pw[:, 0], pw[:, 1]),
            *_combine_kernel(re, im, pw[:, 2], pw[:, 3]))


def _combine(blocks, alpha):
    """sum_i alpha^i col_i with a QM31 alpha over the CM31-valued committed
    columns of ``blocks`` (``(re, im)`` pairs of [C_b, N] tensors, in batch
    order).  A field sum is order-free, so each block is contracted
    against its own slice of the power table and the results are added:
    no second copy of the columns is made."""
    pw = _batch_powers(sum(re.shape[0] for re, _ in blocks), alpha,
                       blocks[0][0].device)
    acc = None
    at = 0
    for re, im in blocks:
        part = _combine_block(re, im, pw[at:at + re.shape[0]])
        at += re.shape[0]
        acc = part if acc is None else qm31_add(acc, part)
    return acc


def _interleave_rows(ext_r, ext_i):
    """[C, N] CM31 column evals -> committed rows [N, 2C] with the
    (re_c, im_c) pairs INTERLEAVED (the reference's layout, which a
    column-streaming commit produces)."""
    return torch.stack([ext_r.T, ext_i.T], dim=2).reshape(
        ext_r.shape[1], -1)


def _open_rows(committed_np, levels, indices):
    """``committed_np``: a full [N, w] host array OR a {row_index: row}
    dict from ``_gather_rows`` (only the queried rows transferred)."""
    return {
        str(j): {
            "row": [int(x) for x in committed_np[j]],
            "path": [[int(x) for x in sib]
                     for sib in merkle.open_path(levels, j)],
        }
        for j in indices
    }


def _gather_rows(matrix_dev, indices):
    """Fetch only the needed rows of a committed device matrix to host:
    one gather + one small transfer instead of materializing [N, w]."""
    idx = sorted(set(int(j) for j in indices))
    sel = torch.tensor(idx, dtype=torch.int64, device=matrix_dev.device)
    vals = matrix_dev.index_select(0, sel).cpu().numpy()
    return {j: vals[k] for k, j in enumerate(idx)}


class _StageStore:
    """Per-stage prove checkpoints (elastic recovery): each heavy stage's
    artifacts persist under ``dir/<key>.<stage>.pkl`` where the key binds
    the full prove input (trace bytes + FRI config + program + flags).  A
    killed prove rerun with the same inputs loads completed stages and
    recomputes only the rest; all challenges are Fiat-Shamir, so the
    resumed proof is bit-identical.  Device tensors are stored as numpy
    uint32 words.  Corrupt/partial files (a kill mid-write) are treated as
    absent — stages write to a temp file and rename, so a torn write
    never wins.  The files are pickles: point ``directory`` only at files
    this prover wrote."""

    def __init__(self, directory, matrix, fri_config, range_lookup,
                 program):
        import hashlib
        import os

        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        h = hashlib.sha256()
        h.update(matrix.tobytes())
        h.update(repr((matrix.shape, fri_config, range_lookup)).encode())
        h.update(program.to_bytes() if program is not None else b"")
        self.key = h.hexdigest()[:24]

    def _path(self, stage):
        import os

        return os.path.join(self.dir, f"{self.key}.{stage}.pkl")

    def load(self, stage):
        import pickle

        try:
            with open(self._path(stage), "rb") as f:
                return pickle.load(f)
        except Exception:       # absent, torn or foreign: recompute
            return None

    def save(self, stage, obj) -> None:
        import os
        import pickle

        tmp = self._path(stage) + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(obj, f, protocol=4)
        os.replace(tmp, self._path(stage))


def _to_store(t: torch.Tensor) -> np.ndarray:
    """Canonical words of a device tensor as host uint32."""
    return t.cpu().numpy().astype(np.uint32)


def _stage_logger(device):
    """Opt-in stage timing (ZKIR_PROVE_LOG=1): one stderr line per prove
    stage, the device synchronised first so that each line holds the
    stage's own time, with the kernel launches made so far (all entry
    points; 0 on the CPU, where nothing launches)."""
    import os
    import sys
    import time as _t

    from .. import _kernels

    if not os.environ.get("ZKIR_PROVE_LOG"):
        return lambda msg: None
    t0 = _t.perf_counter()
    n0 = sum(_kernels.launches.values())
    cuda = torch.device(device).type == "cuda"

    def log(msg):
        if cuda:
            torch.cuda.synchronize(device)
        print(f"[prove {_t.perf_counter() - t0:9.4f}s] {msg} "
              f"[launches {sum(_kernels.launches.values()) - n0}]",
              file=sys.stderr, flush=True)
    return log


def _mesh_device(mesh, device) -> str:
    """The device of a prove on ``mesh``: this rank's mesh device.  A
    ``device`` that names another is refused; ``"cuda"`` names the current
    card, which ``make_mesh`` made the rank's."""
    want, have = torch.device(device), mesh.device
    if want.type != have.type or want.index not in (None, have.index):
        raise ValueError(f"device {device} is not this rank's mesh device "
                         f"{have}")
    if mesh.index is None:
        raise ValueError("this rank is not in the mesh")
    return str(have)


def _check_mesh(mesh, n_rows: int) -> None:
    """A mesh the prover can shard a trace of ``n_rows`` (a power of two)
    over: a power of two that divides the rows, so that every rank's block
    of rows on the trace subgroup and on each LDE coset is whole."""
    d = mesh.size()
    if d & (d - 1):
        raise ValueError(f"a mesh of {d} devices: the prover shards over a "
                         "power of two")
    if n_rows % d:
        raise ValueError(f"a mesh of {d} devices does not divide the "
                         f"trace's {n_rows} rows")


def _zero_padded(cols, lo: int, hi: int, width: int):
    """Rows ``lo`` .. ``hi`` of ``cols`` ([C, n]) followed by zero rows up to
    ``width`` rows."""
    part = cols[lo:hi]
    if hi - lo == width:
        return part
    return torch.cat([part, part.new_zeros((width - (hi - lo),
                                            cols.shape[1]))])


def _sharded_commit(cols, mesh, log_n: int, log_blowup: int, shift, log):
    """The trace commitment of ``prove_trace(mesh=)`` on this rank: the
    columns ([C, n], every rank the same) padded with zero columns to a
    multiple of D; this rank's block extended (``dist_lde``); the blocks
    resharded to rows (``cols_to_rows``), the pad columns dropped, this
    rank's N/D interleaved rows hashed; the digests gathered in rank
    order.  Returns the whole extension (the pad columns dropped,
    ``all_gather``-ed for the later stages) and the [N, 8] leaf digests."""
    d, n_cols = mesh.size(), cols.shape[0]
    w = -(-n_cols // d)
    blk_r, blk_i = dist_lde(_zero_padded(cols, 0, n_cols, d * w), None, mesh,
                            log_n, log_blowup, shift=shift)
    log(f"lde done ({n_cols} cols, {w} a rank)")
    rows_r, rows_i = (cols_to_rows(b, mesh)[:, :n_cols]
                      for b in (blk_r, blk_i))
    leaves = all_gather_rows(
        merkle.hash_rows(_interleave_rows(rows_r.T, rows_i.T)), mesh)
    del rows_r, rows_i
    ext_r, ext_i = (all_gather_rows(b, mesh)[:n_cols] for b in (blk_r, blk_i))
    return ext_r, ext_i, leaves


def _sums_columns(cols, witnesses, aux_pre, prog, beta, gamma, delta, eta):
    """The LogUp partial-sum columns on the trace domain, committed as
    CM31 pairs: (re, im), each [2 n_sums, n], the QM31 a-parts above the
    b-parts.  Sums-column order: NUM_LOOKUP channel sums, NUM_AUX
    aux-table channel sums, the memory multiset S and F, the io S and F,
    the crypto slot inverses and tape S and F, then (if program-bound)
    the program sum.  ``cols``: the trace columns [n_cols, n] on the
    device; ``witnesses``: the channel witnesses there."""
    s_chan = _build_partial_sums(cols, witnesses, beta)
    s_aux = _build_aux_partial_sums(cols, aux_pre["cols_dev"], beta, eta)
    slot_inv4 = _crypto_slot_inverses(cols, beta, delta)
    fm4 = _memory_partial_sum(cols, beta, delta)
    # The memory F column carries the crypto-slot demands too
    # (constraints.memory_multiset slot_sum); fold them in, then take its
    # exclusive prefix sums (an int64 sum over the slots is exact).
    slot_total = tuple(c.sum(dim=0) % P for c in slot_inv4)
    fm4 = qm31_add(fm4, slot_total)
    sm4 = exclusive_cumsum4(fm4)
    si4, fi4 = _io_partial_sum(cols, beta, delta)
    scr4, fcr4 = _crypto_tape_partial_sum(cols, beta, delta)
    groups = [s_chan, s_aux,
              tuple(c[None, :] for c in sm4),
              tuple(c[None, :] for c in fm4),
              tuple(c[None, :] for c in si4),
              tuple(c[None, :] for c in fi4),
              slot_inv4,
              tuple(c[None, :] for c in scr4),
              tuple(c[None, :] for c in fcr4)]
    if prog is not None:
        sp4 = _program_partial_sum(cols, prog["cols_dev"], beta, gamma)
        groups.append(tuple(c[None, :] for c in sp4))
    return (torch.cat([g[k] for k in (0, 2) for g in groups], dim=0),
            torch.cat([g[k] for k in (1, 3) for g in groups], dim=0))


def _quotient_args(s_ext_r, s_ext_i, aux_ext, prog_ext, challenges):
    """``quotient_evals``'s keyword arguments of the full constraint set
    over the sums columns' evaluations (``s_ext_r``/``s_ext_i``, [2 n_sums,
    N]), the aux table's and, program-bound, the program table's
    (``prog_ext``, else None); ``challenges`` = (beta, gamma, delta, eta,
    entry point, memory init demand, I/O demand, crypto demand).  The
    arguments hold views of the sums rows, no copies."""
    from .constraints import N_CR_SUMS, N_SLOTS

    beta, gamma, delta, eta, entry_point, d_init, d_io, d_cr = challenges
    n_sums = s_ext_r.shape[0] // 2

    def sq(lo, hi=None):
        """QM31 view of sums columns [lo, hi) (or a single one)."""
        if hi is None:
            return (s_ext_r[lo], s_ext_i[lo],
                    s_ext_r[n_sums + lo], s_ext_i[n_sums + lo])
        return (s_ext_r[lo:hi], s_ext_i[lo:hi],
                s_ext_r[n_sums + lo:n_sums + hi],
                s_ext_i[n_sums + lo:n_sums + hi])

    i_mem = NUM_LOOKUP + NUM_AUX
    i_cr = i_mem + 4
    return dict(
        lookup=(sq(0, NUM_LOOKUP), beta),
        aux=(aux_ext, sq(NUM_LOOKUP, i_mem), eta),
        memory=((sq(i_mem), sq(i_mem + 1)), delta, d_init),
        io=((sq(i_mem + 2), sq(i_mem + 3)), delta, d_io),
        crypto=((sq(i_cr, i_cr + N_SLOTS), sq(i_cr + N_SLOTS),
                 sq(i_cr + N_SLOTS + 1)), delta, d_cr),
        program=(None if prog_ext is None else
                 (prog_ext, sq(i_cr + N_CR_SUMS), gamma, entry_point)))


def _quotient_too_high(q_coef, n_rows: int) -> bool:
    """Whether the quotient's coefficients (two CM31 pairs) reach degree
    2n: the chunking into two degree-< n polynomials would drop them."""
    return any(bool(c[2 * n_rows:].any()) for pair in q_coef for c in pair)


def _quotient_chunks(q_coef, n_rows: int, log_big: int, shift):
    """The committed quotient columns: Q = Q0 + x^n Q1, each chunk's CM31
    coordinate polynomials evaluated on the LDE coset, as (re, im) pairs
    in batch order (chunk0_a, chunk0_b, chunk1_a, chunk1_b)."""
    q_cm_cols = []
    for j in range(2):
        for coord in range(2):
            # n_rows coefficients: the transform reads the rest as zero.
            chunk = [q_coef[coord][part][j * n_rows:(j + 1) * n_rows]
                     for part in range(2)]
            q_cm_cols.append(coset_ntt(chunk[0], chunk[1], log_big,
                                       shift=shift))
    return q_cm_cols


def _query_indices(k: int, big: int, blowup: int):
    """The rows one FRI query opens: k, k + half and their next rows."""
    half = big // 2
    return sorted({k, (k + blowup) % big, k + half,
                   (k + half + blowup) % big})


def prove_trace(matrix: np.ndarray,
                fri_config: FriConfig = FriConfig(),
                mesh=None, range_lookup: bool = False,
                program=None, selfcheck: bool = True,
                checkpoint_dir=None, *, device) -> Dict[str, Any]:
    """Prove the trace matrix (host uint32 [rows, N_COLUMNS]) on
    ``device`` (required, e.g. ``"cuda"`` or ``"cpu"``), returning the
    reference's proof dict.

    With ``range_lookup``, the chunk-decomposition witness columns are
    additionally proven to lie in [0, 1024) via in-circuit LogUp: table +
    multiplicity columns join phase 1, partial-sum columns are committed
    in a second phase after the beta challenge, and the degree-3 LogUp +
    table-pinning constraints enter the quotient — with the aux-table
    channels and the memory, I/O-tape and crypto-tape multisets.

    With ``program`` (a spec.Program; requires ``range_lookup``), every
    row's (pc, instruction-field) tuple is additionally LogUp-bound to
    the preprocessed program table whose Merkle root is a public input
    (``preprocess_program``), and the first row is pinned to the entry
    point.

    With ``checkpoint_dir``, each heavy stage (trace commit, partial
    sums, quotient, FRI) persists its artifacts there; a killed prove
    rerun with identical inputs resumes past completed stages and emits
    a bit-identical proof (all challenges are Fiat-Shamir).

    With ``mesh`` (a ``parallel.make_mesh`` mesh of D ranks, D a power of
    two that divides the padded rows), every rank of the mesh calls this
    with the same arguments, on its mesh device (``device`` must name it),
    and gets the same proof, equal to the single-device one.  The trace
    commit is sharded: the columns, padded with zero columns to a multiple
    of D, are extended a block a rank (``dist_lde``), resharded from
    columns to rows (``cols_to_rows``; the pad columns dropped), and each
    rank hashes its N/D rows; the digests are ``all_gather``-ed and every
    rank builds the whole tree (the openings read every level).  The later
    stages run on every rank over the whole extension, gathered from the
    blocks.  With ``checkpoint_dir`` on a mesh, rank 0 writes the stage
    files and the ranks meet at a barrier after each; every rank resumes
    from them."""
    if program is not None and not range_lookup:
        raise ValueError("program binding requires range_lookup=True")
    if mesh is not None:
        device = _mesh_device(mesh, device)
    log = _stage_logger(device)
    matrix = np.asarray(matrix, dtype=np.uint32)
    store = (None if checkpoint_dir is None else
             _StageStore(checkpoint_dir, matrix, fri_config, range_lookup,
                         program))

    def stage(name):
        """The stage's stored artifacts, or None where it must run.  On a
        mesh every rank has looked before any rank writes the stage."""
        if store is None:
            return None
        ck = store.load(name)
        if mesh is not None:
            dist.barrier(group=mesh.group)
        if ck is not None:
            log(f"stage {name} resumed from its checkpoint")
        return ck

    def save(name, artifacts):
        """Store the stage's artifacts (``artifacts()``): on a mesh rank 0
        writes them, then the ranks meet."""
        if store is None:
            return
        if mesh is None or mesh.index == 0:
            store.save(name, artifacts())
        if mesh is not None:
            dist.barrier(group=mesh.group)

    n_real = matrix.shape[0]
    padded, log_n = _pad_rows(matrix, min_log=10 if range_lookup else 2)
    if mesh is not None:
        _check_mesh(mesh, 1 << log_n)
    prog = None
    entry_point = 0
    aux_pre = None
    if range_lookup:
        if padded is matrix:
            padded = matrix.copy()      # the memory table is filled in place
        _build_memory_table(padded, n_real, program=program)
        aux_pre = preprocess_aux(log_n, fri_config.log_blowup, device=device)
    if program is not None:
        code_words = list(program.code)
        entry_point = int(program.header.entry_point)
        prog = preprocess_program(code_words, log_n, fri_config,
                                  device=device)
    # The columns that range_lookup appends stay a block of their own on
    # the host: they join the trace columns on the device.
    witnesses = extra = None
    if range_lookup:
        witnesses = _channel_witnesses(padded)
        extra = _build_lookup_columns(padded, witnesses)
        if prog is not None:
            m_prog = _program_multiplicity(padded, n_real, len(code_words))
            extra = np.concatenate([extra, m_prog[:, None]], axis=1)
        log("witness columns built")
    n_cols = padded.shape[1] + (0 if extra is None else extra.shape[1])
    log_big = log_n + fri_config.log_blowup
    big = 1 << log_big
    shift = _coset_shift()

    # Coset LDE of all columns: [cols, n] -> [cols, N], then phase 1:
    # commit the trace columns.
    # The matrix crosses to the device as it is (4-byte words, row-major);
    # the transpose to columns and the widening to int64 happen there.
    cols = _words(padded, device).T
    if extra is not None:
        cols = torch.cat([cols, _words(extra, device).T])
    cols = cols.contiguous()
    ck = stage("commit")
    if ck is not None:
        ext_r = _words(ck["ext_r"], device)
        ext_i = _words(ck["ext_i"], device)
        levels1 = ck["levels1"]
        trace_rows = _interleave_rows(ext_r, ext_i)
    elif mesh is None:
        ext_r, ext_i = lde(cols, None, log_n, fri_config.log_blowup,
                           shift=shift)
        log(f"lde done ({n_cols} cols)")
        trace_rows = _interleave_rows(ext_r, ext_i)
        levels1 = merkle.to_host(merkle.build_tree_fused(
            merkle.hash_rows(trace_rows)))
    else:
        ext_r, ext_i, leaves1 = _sharded_commit(
            cols, mesh, log_n, fri_config.log_blowup, shift, log)
        levels1 = merkle.to_host(merkle.build_tree_fused(leaves1))
        del leaves1
        trace_rows = _interleave_rows(ext_r, ext_i)
    if ck is None:
        save("commit", lambda: {"ext_r": _to_store(ext_r),
                                "ext_i": _to_store(ext_i),
                                "levels1": levels1})
    if not range_lookup:
        del cols
    root1 = merkle.root(levels1)
    log(f"trace committed ({n_cols} cols, 2^{log_n} rows)")

    challenger = Challenger(device=device)
    challenger.observe(log_n)
    challenger.observe(n_cols)
    challenger.observe_many(int(x) for x in root1)
    if aux_pre is not None:
        challenger.observe_many(int(x) for x in aux_pre["root"])
    if prog is not None:
        challenger.observe_many(int(x) for x in prog["root"])
        challenger.observe(entry_point)
        challenger.observe(len(code_words))
    io_inputs = io_outputs = None
    crypto_tape = None
    if range_lookup:
        # The claimed public I/O and crypto tapes enter the transcript
        # before the beta/delta draws (Fiat-Shamir binding).
        io_inputs, io_outputs = extract_io(padded)
        _observe_io(challenger, io_inputs, io_outputs)
        crypto_tape = extract_crypto_tape(padded)
        _observe_crypto(challenger, crypto_tape)

    # Phase 1.5 (lookup only): beta challenge -> partial-sum columns
    # (``_sums_columns``).  All challenges are QM31 (ops/qm31.py).
    levels_s = None
    s_rows = None
    s_ext_r = s_ext_i = None
    from .constraints import N_CR_SUMS

    n_sums = (NUM_LOOKUP + NUM_AUX + 4 + N_CR_SUMS
              + (1 if program is not None else 0)) if range_lookup else 0
    # End-to-end soundness floor: the QM31 batching/DEEP term must also
    # clear min_security (see FriConfig.security_bits).
    total_terms = n_cols + 2 * n_sums + 4
    if fri_config.security_bits(log_big, total_terms) \
            < fri_config.min_security:
        raise ValueError(
            f"end-to-end soundness {fri_config.security_bits(log_big, total_terms)}"
            f" bits < min_security={fri_config.min_security} for "
            f"log_n={log_n} with {total_terms} batched terms")
    if range_lookup:
        beta = challenger.sample_qm31()
        gamma = challenger.sample_qm31() if prog is not None else None
        delta = challenger.sample_qm31()
        eta = challenger.sample_qm31()
        ck = stage("sums")
        if ck is not None:
            s_ext_r = _words(ck["s_ext_r"], device)
            s_ext_i = _words(ck["s_ext_i"], device)
            levels_s = ck["levels_s"]
            s_rows = _interleave_rows(s_ext_r, s_ext_i)
            del cols
        else:
            s_r, s_i = _sums_columns(cols, _words(witnesses, device),
                                     aux_pre, prog, beta, gamma, delta, eta)
            del cols
            log(f"partial sums built ({n_sums} QM31 columns)")
            s_ext_r, s_ext_i = lde(s_r, s_i, log_n, fri_config.log_blowup,
                                   shift=shift)
            del s_r, s_i
            s_rows = _interleave_rows(s_ext_r, s_ext_i)
            levels_s = merkle.to_host(
                merkle.build_tree_fused(merkle.hash_rows(s_rows)))
            save("sums", lambda: {"s_ext_r": _to_store(s_ext_r),
                                  "s_ext_i": _to_store(s_ext_i),
                                  "levels_s": levels_s})
        root_s = merkle.root(levels_s)
        log(f"partial sums committed ({n_sums} QM31 columns)")
        challenger.observe_many(int(x) for x in root_s)

        challenges = (beta, gamma, delta, eta, entry_point,
                      memory_init_demand(program, beta, delta, device=device),
                      io_tape_demand(io_inputs, io_outputs, beta, delta,
                                     device=device),
                      crypto_tape_demand(crypto_tape, beta, delta,
                                         device=device))
        lookup_kwargs = _quotient_args(
            s_ext_r, s_ext_i, aux_pre["ext"],
            None if prog is None else prog["ext"], challenges)
    else:
        lookup_kwargs = {}

    alpha_c = challenger.sample_qm31()

    # Phase 2: quotient (QM31-valued), split into degree-< n chunks
    # Q(x) = Q0(x) + x^n Q1(x).  Each QM31 chunk is committed as two
    # CM31 coordinate columns (a + b*u), so q_rows is [N, 8].
    n_rows = 1 << log_n
    ck = stage("quotient")
    if ck is not None:
        q_cm_cols = [(_words(ck[f"q{k}r"], device),
                      _words(ck[f"q{k}i"], device)) for k in range(4)]
        levels2 = ck["levels2"]
    else:
        q = quotient_evals(ext_r, ext_i, log_n, fri_config.log_blowup,
                           shift, alpha_c, **lookup_kwargs)
        log("quotient evaluated")
        q_coef = [coset_intt(q[0], q[1], log_big, shift=shift),
                  coset_intt(q[2], q[3], log_big, shift=shift)]
        del q
        if selfcheck and _quotient_too_high(q_coef, n_rows):
            # Completeness self-check: Q is a polynomial of degree < 2n
            # iff every constraint divides cleanly.  The chunking below
            # DISCARDS coefficients [2n, 4n): catch a violated constraint
            # here, at prove time, with a name.
            detail = diagnose_violations(
                ext_r, ext_i, log_n, fri_config.log_blowup, shift,
                **lookup_kwargs)
            raise ConstraintViolation(
                "trace violates the constraint system (quotient has "
                f"degree >= 2n): {detail}")
        q_cm_cols = _quotient_chunks(q_coef, n_rows, log_big, shift)
        del q_coef
    del lookup_kwargs
    q_rows = torch.stack(
        [c for pair in q_cm_cols for c in pair], dim=1)   # [N, 8]
    if ck is None:
        levels2 = merkle.to_host(merkle.build_tree_fused(
            merkle.hash_rows(q_rows)))
        save("quotient", lambda: {
            "levels2": levels2,
            **{f"q{k}{part}": _to_store(q_cm_cols[k][j])
               for k in range(4) for j, part in enumerate("ri")}})
    root2 = merkle.root(levels2)
    log("quotient committed")
    challenger.observe_many(int(x) for x in root2)
    alpha_b = challenger.sample_qm31()

    # The challenger is not consulted after fri_prove, so a loaded FRI
    # proof needs no transcript replay.
    fri_proof = stage("fri")
    if fri_proof is None:
        blocks = [(ext_r, ext_i)]
        if range_lookup:
            blocks.append((s_ext_r, s_ext_i))
        blocks.append((torch.stack([c[0] for c in q_cm_cols]),
                       torch.stack([c[1] for c in q_cm_cols])))
        batch4 = _combine(blocks, alpha_b)
        del blocks
        fri_proof = fri_prove(batch4, log_big, challenger, fri_config,
                              shift=shift)
        del batch4
        log("fri done")
        save("fri", lambda: fri_proof)
    del ext_r, ext_i, s_ext_r, s_ext_i, q_cm_cols

    # Phase 3: open commitment rows at the FRI query points (and their
    # next-row rotations for the transition constraints).  Only the
    # queried rows are transferred to host (one gather per matrix).
    blowup = 1 << fri_config.log_blowup
    all_indices = sorted({
        j for steps in fri_proof["queries"]
        for j in _query_indices(steps[0]["leaf_idx"], big, blowup)})
    trees = [("trace", trace_rows, levels1), ("quotient", q_rows, levels2)]
    if range_lookup:
        trees += [("sums", s_rows, levels_s),
                  ("aux", aux_pre["rows"], aux_pre["levels"])]
    if prog is not None:
        trees.append(("prog", prog["rows"], prog["levels"]))
    gathered = [(name, _gather_rows(rows, all_indices), levels)
                for name, rows, levels in trees]
    openings = []
    for steps in fri_proof["queries"]:
        indices = _query_indices(steps[0]["leaf_idx"], big, blowup)
        openings.append({name: _open_rows(rows_np, levels, indices)
                         for name, rows_np, levels in gathered})
    log("openings done")

    out = {
        "log_n": log_n,
        "n_cols": n_cols,
        "range_lookup": range_lookup,
        "trace_root": [int(x) for x in root1],
        "quotient_root": [int(x) for x in root2],
        "fri": fri_proof,
        "openings": openings,
    }
    if range_lookup:
        out["sums_root"] = [int(x) for x in merkle.root(levels_s)]
        out["io"] = {"inputs": io_inputs, "outputs": io_outputs}
        out["crypto"] = crypto_tape
    if prog is not None:
        out["program"] = {
            "root": prog["root"],
            "entry": entry_point,
            "n_code": len(code_words),
        }
    return out


def verify_trace(proof: Dict[str, Any], program=None, *, device) -> bool:
    """Verify a trace proof.  ``device`` (required) is where the
    preprocessed aux and program tables of a ``range_lookup`` proof are
    recomputed (one small LDE and tree each) and the public demands are
    inverted; the transcript and every per-query check are host code.

    With ``program`` (a spec.Program), the proof's program-binding
    commitment is recomputed from the public program and must match —
    i.e. the proof attests that THIS program executed from its entry
    point.  Without it, a program-bound proof is still checked for
    internal consistency against its committed (untrusted) table."""
    log_n = proof["log_n"]
    n_cols = proof["n_cols"]
    range_lookup = proof.get("range_lookup", False)
    prog_pub = proof.get("program")
    fri_proof = proof["fri"]
    config: FriConfig = fri_proof["config"]
    log_big = log_n + config.log_blowup
    big = 1 << log_big
    half = big // 2
    blowup = 1 << config.log_blowup
    shift = _coset_shift()

    if program is not None:
        if prog_pub is None:
            return False
        # Recomputed on every verify, never read from the proof.
        expected = preprocess_program(list(program.code), log_n, config,
                                      device=device)
        if (list(prog_pub["root"]) != expected["root"]
                or int(prog_pub["entry"]) != int(program.header.entry_point)
                or int(prog_pub["n_code"]) != len(program.code)):
            return False
    if prog_pub is not None and not range_lookup:
        return False

    aux_pre = preprocess_aux(log_n, config.log_blowup, device=device) \
        if range_lookup else None

    challenger = Challenger()
    challenger.observe(log_n)
    challenger.observe(n_cols)
    challenger.observe_many(int(x) for x in proof["trace_root"])
    if aux_pre is not None:
        # The aux-table root is recomputed from scratch (deterministic
        # per log_n), never read from the proof.
        challenger.observe_many(int(x) for x in aux_pre["root"])
    if prog_pub is not None:
        challenger.observe_many(int(x) for x in prog_pub["root"])
        challenger.observe(int(prog_pub["entry"]))
        challenger.observe(int(prog_pub["n_code"]))
    beta = None
    gamma = None
    delta = None
    eta = None
    from .constraints import N_CR_SUMS

    n_sums = (NUM_LOOKUP + NUM_AUX + 4 + N_CR_SUMS
              + (1 if prog_pub is not None else 0))
    d_init = (0, 0, 0, 0)
    d_io = (0, 0, 0, 0)
    d_cr = (0, 0, 0, 0)
    io_pub = proof.get("io")
    crypto_pub = proof.get("crypto")
    if range_lookup:
        if (not isinstance(io_pub, dict) or "inputs" not in io_pub
                or "outputs" not in io_pub):
            return False
        if not isinstance(crypto_pub, list):
            return False
        io_inputs = [int(v) for v in io_pub["inputs"]]
        io_outputs = [int(v) for v in io_pub["outputs"]]
        _observe_io(challenger, io_inputs, io_outputs)
        _observe_crypto(challenger, crypto_pub)
        beta = challenger.sample_qm31()
        if prog_pub is not None:
            gamma = challenger.sample_qm31()
        delta = challenger.sample_qm31()
        eta = challenger.sample_qm31()
        challenger.observe_many(int(x) for x in proof["sums_root"])
        # The public init demand: recomputed from the PUBLIC program when
        # given (sound binding); absent one, a program-bound proof's
        # memory argument cannot be anchored, so fall back to zero-init
        # (unbound proofs prove zero-initialized memory only).
        d_init = memory_init_demand(program, beta, delta, device=device)
        # The public I/O demand: recomputed from the proof's CLAIMED
        # tapes — an accepted proof attests exactly these tapes.
        d_io = io_tape_demand(io_inputs, io_outputs, beta, delta,
                              device=device)
        # The crypto demand: each claimed entry's digest is RECOMPUTED
        # from its claimed input bytes — a forged digest cannot match.
        d_cr = crypto_tape_demand(crypto_pub, beta, delta, device=device)
        if d_cr is None:
            return False
    alpha_c = challenger.sample_qm31()
    challenger.observe_many(int(x) for x in proof["quotient_root"])
    alpha_b = challenger.sample_qm31()

    if tuple(fri_proof.get("shift", (1, 0))) != tuple(shift):
        return False
    if not fri_verify(fri_proof, challenger):
        return False

    # name -> (root, row width) of every tree this proof opens.
    trees = {"trace": (proof["trace_root"], 2 * n_cols),
             "quotient": (proof["quotient_root"], 8)}
    if range_lookup:
        trees["sums"] = (proof["sums_root"], 4 * n_sums)
        trees["aux"] = (aux_pre["root"], 2 * N_AUX_COLS)
    if prog_pub is not None:
        trees["prog"] = (prog_pub["root"], 8)

    # Every query's needed rows must be opened at the right width; their
    # digests and Merkle paths are then checked in one batch per tree
    # (the reference checks them row by row).
    opened: Dict[str, List[Tuple[int, Dict[str, Any]]]] = {
        name: [] for name in trees}
    per_query = []
    for q_idx, steps in enumerate(fri_proof["queries"]):
        k = steps[0]["leaf_idx"]
        opening = proof["openings"][q_idx]
        vals: Dict[str, Dict[int, List[int]]] = {name: {} for name in trees}
        for j in _query_indices(k, big, blowup):
            for name, (_, width) in trees.items():
                entry = opening.get(name, {}).get(str(j))
                if entry is None or len(entry["row"]) != width:
                    return False
                opened[name].append((j, entry))
                vals[name][j] = entry["row"]
        per_query.append((k, vals))
    for name, (root, _) in trees.items():
        if not all(merkle.verify_rows(
                np.asarray(root, dtype=np.uint32),
                [j for j, _ in opened[name]],
                [e["row"] for _, e in opened[name]],
                [e["path"] for _, e in opened[name]], log_big)):
            return False

    # Every query point's index, recomputed Q value and opened rows (the
    # constraint check's inputs), in query order.
    points, q_at = [], []
    opened_rows = {name: [] for name in ("rows", "next", "sums",
                                         "sums next", "aux", "prog")}
    for steps, (k, vals) in zip(fri_proof["queries"], per_query):
        rows = vals["trace"]
        for j, fri_value in ((k, tuple(steps[0]["lo"])),
                             (k + half, tuple(steps[0]["hi"]))):
            # 1. Batch combination binds FRI layer 0 to the commitments:
            # every committed CM31 column (trace, 2*n_sums sums
            # coordinates, 4 quotient coordinates) times successive QM31
            # alpha_b powers.
            batched = list(rows[j])
            if range_lookup:
                batched += vals["sums"][j]
            qrow = vals["quotient"][j]
            batched += qrow
            # (re, im) pairs as int64 [2, C], weighed by the powers in one
            # numpy pass.
            pairs = np.asarray(batched, dtype=np.int64).reshape(-1, 2).T % P
            pw = qm31_powers_np(tuple(int(a) % P for a in alpha_b),
                                pairs.shape[1])
            acc = tuple(int(v) % P for v in np.concatenate(
                [cm31_mul_np(pw[:2], pairs),
                 cm31_mul_np(pw[2:], pairs)]).sum(axis=1))
            if acc != fri_value:
                return False

            # 2. Constraint check: Q(x_j) = Q0 + x^n Q1 must equal the
            # recomputed combination of constraints at the opened rows
            # (every point's at once, below).
            jn = (j + blowup) % big
            x = cm31_mul_scalar(
                shift, cm31_pow_scalar(root_of_unity(log_big), j))
            xn = cm31_pow_scalar(x, 1 << log_n)
            # QM31 chunks (chunk0_a, chunk0_b | chunk1_a, chunk1_b): CM31
            # coordinate pairs in q_rows order.
            q_at.append(qm31_add_scalar(
                tuple(qrow[0:4]),
                qm31_mul_cm31_scalar(tuple(qrow[4:8]), xn)))
            points.append(j)
            for name, at in (("rows", rows[j]), ("next", rows[jn])):
                opened_rows[name].append(at)
            if range_lookup:
                opened_rows["sums"].append(vals["sums"][j])
                opened_rows["sums next"].append(vals["sums"][jn])
                opened_rows["aux"].append(vals["aux"][j])
            if prog_pub is not None:
                opened_rows["prog"].append(vals["prog"][j])

    lookup_args = aux_args = memory_args = io_args = crypto_args = None
    program_args = None
    if range_lookup:
        lookup_args = (opened_rows["sums"], opened_rows["sums next"], beta)
        aux_args = (opened_rows["aux"], eta)
        memory_args = (delta, d_init)
        io_args = (delta, d_io)
        crypto_args = (delta, d_cr)
    if prog_pub is not None:
        program_args = (opened_rows["prog"], gamma, int(prog_pub["entry"]))
    expected_q = quotient_values_at(
        opened_rows["rows"], opened_rows["next"], n_cols, points, log_n,
        config.log_blowup, shift, alpha_c, lookup=lookup_args,
        aux=aux_args, program=program_args, memory=memory_args, io=io_args,
        crypto=crypto_args)
    return q_at == expected_q
