"""End-to-end STARK-style trace proof: commitment + constraints + FRI (torch).

Counterpart of ``zkir_tpu/prover/prover.py`` for ``range_lookup=False``
proofs.  The heavy stages run on the device given to ``prove_trace``;
the transcript, the padding and the verifier are host copies.  Proofs
equal the reference's dict for dict (after a JSON round trip).

Pipeline (one device; sharding is not ported yet):

1. pad the trace matrix to 2^log_n rows;
2. low-degree-extend every column onto a *coset* of the larger subgroup
   (CM31 NTT; the coset keeps the trace-domain vanishing polynomial
   invertible at every committed point);
3. commit the extended matrix with a Poseidon2 Merkle tree (root_1);
4. draw the constraint combiner alpha_c and evaluate the AIR quotient
   Q = sum alpha_c^j C_j / D_j on the coset (``prover.constraints``);
5. commit Q with a second tree (root_2);
6. draw the batch combiner alpha_b; FRI-prove the combined polynomial
   sum alpha_b^i col_i + alpha_b^{n_cols} Q is low degree;
7. for every FRI query index k open both trees at k, k+half and their
   next-row rotations — the verifier recomputes the batch combination
   (binding FRI to the commitments) AND re-evaluates the constraints,
   checking Q at the opened points.

The reference contains no prover at all (vm.rs:234-243 shapes witness data
for an absent Plonky3-style consumer); this module is that missing stage.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..ops import merkle
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
from ..ops.qm31 import (qm31_add_scalar, qm31_mul_cm31_scalar,
                        qm31_mul_scalar)
from ..spec.field import M31_PRIME
from .challenger import Challenger
from .constraints import (diagnose_violations, quotient_evals,
                          quotient_value_at)
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


def _combine_kernel(ar, ai, pw_r, pw_i):
    """sum_c pw_c * col_c over CM31 for columns [C, N] and power vectors
    [C]: one broadcast CM31 product, then one sum over C reduced mod p (the
    order of a field sum does not matter; C words of < 2^31 each cannot
    overflow int64)."""
    tr, ti = cm31_mul((ar, ai), (pw_r[:, None], pw_i[:, None]))
    return tr.sum(dim=0) % P, ti.sum(dim=0) % P


def _combine(ext_r, ext_i, extra_cols, alpha):
    """sum_i alpha^i col_i + sum_j alpha^(n_cols+j) extra_j with a QM31
    alpha over CM31-valued committed columns: the result is QM31 — its
    a/b coordinates are each one run of the CM31 combine kernel."""
    n_cols = ext_r.shape[0]
    n_total = n_cols + len(extra_cols)
    pw = np.zeros((n_total, 4), dtype=np.int64)
    power = (1, 0, 0, 0)
    for k in range(n_total):
        pw[k] = power
        power = qm31_mul_scalar(power, alpha)
    pw = torch.from_numpy(pw).to(ext_r.device)
    if extra_cols:
        ar = torch.cat([ext_r, torch.stack([c[0] for c in extra_cols])])
        ai = torch.cat([ext_i, torch.stack([c[1] for c in extra_cols])])
    else:
        ar, ai = ext_r, ext_i
    a_part = _combine_kernel(ar, ai, pw[:, 0], pw[:, 1])
    b_part = _combine_kernel(ar, ai, pw[:, 2], pw[:, 3])
    return (a_part[0], a_part[1], b_part[0], b_part[1])


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


def _stage_logger(device):
    """Opt-in stage timing (ZKIR_PROVE_LOG=1): one stderr line per prove
    stage, the device synchronised first so that each line holds the
    stage's own time."""
    import os
    import sys
    import time as _t

    if not os.environ.get("ZKIR_PROVE_LOG"):
        return lambda msg: None
    t0 = _t.perf_counter()
    cuda = torch.device(device).type == "cuda"

    def log(msg):
        if cuda:
            torch.cuda.synchronize(device)
        print(f"[prove {_t.perf_counter() - t0:9.4f}s] {msg}",
              file=sys.stderr, flush=True)
    return log


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to zkir_tpu_torch yet (ROADMAP Queue 1: "
        f"{item})")


def prove_trace(matrix: np.ndarray,
                fri_config: FriConfig = FriConfig(),
                mesh=None, range_lookup: bool = False,
                program=None, selfcheck: bool = True,
                checkpoint_dir=None, *, device) -> Dict[str, Any]:
    """Prove the trace matrix (host uint32 [rows, N_COLUMNS]) on
    ``device`` (required, e.g. ``"cuda"`` or ``"cpu"``), returning the
    reference's proof dict.

    The ``range_lookup=False`` path of ``zkir_tpu.prover.prove_trace``:
    coset LDE + Poseidon2 Merkle commit of the trace, the AIR quotient
    in 2 degree-< n QM31 chunks (4 CM31 columns) with its own commit,
    the alpha_b batch combination, FRI, and the openings.  ``mesh``,
    ``range_lookup``, ``program`` and ``checkpoint_dir`` raise
    ``NotImplementedError``, naming the ROADMAP item that ports them."""
    if mesh is not None:
        raise _not_ported("prove_trace(mesh=...)", "multi-GPU")
    if range_lookup:
        raise _not_ported("prove_trace(range_lookup=True)",
                          "range_lookup partial sums and preprocess_aux")
    if program is not None:
        raise _not_ported("prove_trace(program=...)", "program binding")
    if checkpoint_dir is not None:
        raise _not_ported("prove_trace(checkpoint_dir=...)",
                          "_StageStore checkpoints")
    log = _stage_logger(device)
    matrix = np.asarray(matrix, dtype=np.uint32)
    padded, log_n = _pad_rows(matrix, min_log=2)
    n_cols = padded.shape[1]
    log_big = log_n + fri_config.log_blowup
    big = 1 << log_big
    shift = _coset_shift()

    # Coset LDE of all columns: [cols, n] -> [cols, N], then phase 1:
    # commit the trace columns.
    # The matrix crosses to the device as it is (4-byte words, row-major);
    # the transpose to columns and the widening to int64 happen there.
    rows_dev = torch.from_numpy(
        np.ascontiguousarray(padded).view(np.int32)).to(device)
    cols_r = (rows_dev.T.to(torch.int64) & 0xFFFFFFFF).contiguous()
    del rows_dev
    ext_r, ext_i = lde(cols_r, None, log_n, fri_config.log_blowup,
                       shift=shift)
    del cols_r
    log(f"lde done ({n_cols} cols)")
    trace_rows = _interleave_rows(ext_r, ext_i)
    levels1 = merkle.to_host(merkle.build_tree_fused(
        merkle.hash_rows(trace_rows)))
    root1 = merkle.root(levels1)
    log(f"trace committed ({n_cols} cols, 2^{log_n} rows)")

    challenger = Challenger(device=device)
    challenger.observe(log_n)
    challenger.observe(n_cols)
    challenger.observe_many(int(x) for x in root1)

    # End-to-end soundness floor: the QM31 batching/DEEP term must also
    # clear min_security (see FriConfig.security_bits).
    total_terms = n_cols + 4
    if fri_config.security_bits(log_big, total_terms) \
            < fri_config.min_security:
        raise ValueError(
            f"end-to-end soundness {fri_config.security_bits(log_big, total_terms)}"
            f" bits < min_security={fri_config.min_security} for "
            f"log_n={log_n} with {total_terms} batched terms")
    alpha_c = challenger.sample_qm31()

    # Phase 2: quotient (QM31-valued), split into degree-< n chunks
    # Q(x) = Q0(x) + x^n Q1(x).  Each QM31 chunk is committed as two
    # CM31 coordinate columns (a + b*u), so q_rows is [N, 8].
    n_rows = 1 << log_n
    q = quotient_evals(ext_r, ext_i, log_n, fri_config.log_blowup,
                       shift, alpha_c)
    log("quotient evaluated")
    q_coef = [coset_intt(q[0], q[1], log_big, shift=shift),
              coset_intt(q[2], q[3], log_big, shift=shift)]
    del q
    if selfcheck:
        # Completeness self-check: Q is a polynomial of degree < 2n
        # iff every constraint divides cleanly.  The chunking below
        # DISCARDS coefficients [2n, 4n): catch a violated constraint
        # here, at prove time, with a name.
        bad = any(bool(c[2 * n_rows:].any())
                  for pair in q_coef for c in pair)
        if bad:
            detail = diagnose_violations(
                ext_r, ext_i, log_n, fri_config.log_blowup, shift)
            raise ConstraintViolation(
                "trace violates the constraint system (quotient has "
                f"degree >= 2n): {detail}")
    # CM31 coordinate columns in batch order:
    # (chunk0_a, chunk0_b, chunk1_a, chunk1_b).
    q_cm_cols = []
    for j in range(2):
        for coord in range(2):
            # n_rows coefficients: the transform reads the rest as zero.
            chunk = [q_coef[coord][part][j * n_rows:(j + 1) * n_rows]
                     for part in range(2)]
            q_cm_cols.append(coset_ntt(chunk[0], chunk[1], log_big,
                                       shift=shift))
    del q_coef
    q_rows = torch.stack(
        [c for pair in q_cm_cols for c in pair], dim=1)   # [N, 8]
    levels2 = merkle.to_host(merkle.build_tree_fused(
        merkle.hash_rows(q_rows)))
    root2 = merkle.root(levels2)
    log("quotient committed")
    challenger.observe_many(int(x) for x in root2)
    alpha_b = challenger.sample_qm31()

    batch4 = _combine(ext_r, ext_i, q_cm_cols, alpha_b)
    del ext_r, ext_i, q_cm_cols
    fri_proof = fri_prove(batch4, log_big, challenger, fri_config,
                          shift=shift)
    del batch4
    log("fri done")

    # Phase 3: open commitment rows at the FRI query points (and their
    # next-row rotations for the transition constraints).  Only the
    # queried rows are transferred to host (one gather per matrix).
    half = big // 2
    blowup = 1 << fri_config.log_blowup
    all_indices = sorted({
        j
        for steps in fri_proof["queries"]
        for k in (steps[0]["leaf_idx"],)
        for j in (k, (k + blowup) % big, k + half,
                  (k + half + blowup) % big)
    })
    trace_np = _gather_rows(trace_rows, all_indices)
    q_np = _gather_rows(q_rows, all_indices)
    openings = []
    for steps in fri_proof["queries"]:
        k = steps[0]["leaf_idx"]
        indices = sorted({
            k, (k + blowup) % big,
            k + half, (k + half + blowup) % big,
        })
        openings.append({
            "trace": _open_rows(trace_np, levels1, indices),
            "quotient": _open_rows(q_np, levels2, indices),
        })
    log("openings done")

    return {
        "log_n": log_n,
        "n_cols": n_cols,
        "range_lookup": False,
        "trace_root": [int(x) for x in root1],
        "quotient_root": [int(x) for x in root2],
        "fri": fri_proof,
        "openings": openings,
    }


def verify_trace(proof: Dict[str, Any], program=None) -> bool:
    """Verify a trace proof (host code: a copy of the reference's
    ``verify_trace`` for proofs without ``range_lookup``).

    Program-bound and ``range_lookup`` proofs need the preprocessed aux
    and program tables, which are not ported yet: they raise
    ``NotImplementedError`` rather than returning a verdict."""
    if program is not None or proof.get("program") is not None:
        raise _not_ported("verify_trace of a program-bound proof",
                          "program binding")
    if proof.get("range_lookup", False):
        raise _not_ported("verify_trace of a range_lookup proof",
                          "range_lookup partial sums and preprocess_aux")
    log_n = proof["log_n"]
    n_cols = proof["n_cols"]
    fri_proof = proof["fri"]
    config: FriConfig = fri_proof["config"]
    log_big = log_n + config.log_blowup
    big = 1 << log_big
    half = big // 2
    blowup = 1 << config.log_blowup
    shift = _coset_shift()

    challenger = Challenger()
    challenger.observe(log_n)
    challenger.observe(n_cols)
    challenger.observe_many(int(x) for x in proof["trace_root"])
    alpha_c = challenger.sample_qm31()
    challenger.observe_many(int(x) for x in proof["quotient_root"])
    alpha_b = challenger.sample_qm31()

    if tuple(fri_proof.get("shift", (1, 0))) != tuple(shift):
        return False
    if not fri_verify(fri_proof, challenger):
        return False

    trace_root = np.asarray(proof["trace_root"], dtype=np.uint32)
    q_root = np.asarray(proof["quotient_root"], dtype=np.uint32)

    # Every query's needed rows must be opened at the right width; their
    # digests and Merkle paths are then checked in one batch per tree
    # (the reference checks them row by row).
    opened_trace: List[Tuple[int, Dict[str, Any]]] = []
    opened_q: List[Tuple[int, Dict[str, Any]]] = []
    per_query = []
    for q_idx, steps in enumerate(fri_proof["queries"]):
        k = steps[0]["leaf_idx"]
        opening = proof["openings"][q_idx]
        rows: Dict[int, List[int]] = {}
        q_vals: Dict[int, Tuple[int, int]] = {}
        needed = {k, (k + blowup) % big, k + half, (k + half + blowup) % big}
        for j in needed:
            entry = opening["trace"].get(str(j))
            qentry = opening["quotient"].get(str(j))
            if entry is None or len(entry["row"]) != 2 * n_cols or \
                    qentry is None or len(qentry["row"]) != 8:
                return False
            opened_trace.append((j, entry))
            opened_q.append((j, qentry))
            rows[j] = entry["row"]
            qrow = qentry["row"]
            # QM31 chunks: (chunk0_a, chunk0_b, chunk1_a, chunk1_b)
            # CM31 coordinate pairs in q_rows order.
            q_vals[j] = (tuple(qrow[0:4]), tuple(qrow[4:8]))
        per_query.append((k, rows, q_vals))
    for root, opened in ((trace_root, opened_trace), (q_root, opened_q)):
        if not all(merkle.verify_rows(
                root, [j for j, _ in opened], [e["row"] for _, e in opened],
                [e["path"] for _, e in opened], log_big)):
            return False

    for steps, (k, rows, q_vals) in zip(fri_proof["queries"], per_query):
        for j, fri_value in ((k, tuple(steps[0]["lo"])),
                             (k + half, tuple(steps[0]["hi"]))):
            # 1. Batch combination binds FRI layer 0 to the commitments:
            # every committed CM31 column (trace, 4 quotient
            # coordinates) times successive QM31 alpha_b powers.
            acc = (0, 0, 0, 0)
            power = (1, 0, 0, 0)
            row = rows[j]

            def _absorb(cm_col, acc, power):
                term = qm31_mul_cm31_scalar(power, cm_col)
                return (qm31_add_scalar(acc, term),
                        qm31_mul_scalar(power, alpha_b))

            for c in range(n_cols):
                acc, power = _absorb((row[2 * c], row[2 * c + 1]),
                                     acc, power)
            for qchunk in q_vals[j]:
                acc, power = _absorb((qchunk[0], qchunk[1]), acc, power)
                acc, power = _absorb((qchunk[2], qchunk[3]), acc, power)
            if acc != fri_value:
                return False

            # 2. Constraint check: Q(x_j) = Q0 + x^n Q1 must equal the
            # recomputed combination of constraints at the opened rows.
            jn = (j + blowup) % big
            expected_q = quotient_value_at(
                rows[j], rows[jn], n_cols, j, log_n, config.log_blowup,
                shift, alpha_c)
            x = cm31_mul_scalar(
                shift, cm31_pow_scalar(root_of_unity(log_big), j))
            xn = cm31_pow_scalar(x, 1 << log_n)
            q_at = qm31_add_scalar(
                q_vals[j][0], qm31_mul_cm31_scalar(q_vals[j][1], xn))
            if q_at != expected_q:
                return False

    return True
