"""Column-streaming prover: bounded peak device memory (torch).

Counterpart of ``zkir_tpu/prover/streaming.py``.  ``prove_trace`` holds
every committed column's evaluations on the whole LDE domain at once: at
2^16 rows its peak is some 10 GB, and it grows with the rows.
``prove_trace_streaming`` proves the SAME statement with the SAME
transcript (proofs equal to ``prove_trace(range_lookup=True)``'s) while
the device holds only:

- the padded trace VALUES [n_cols, n] and the partial sums' values
  [2 n_sums, n];
- for the commits, the batch combination and the openings, one column
  block's evaluations on one interleaved coset at a time (two size-n
  transforms a block);
- for the quotient, every column's evaluations on ONE coset.

The structure it leans on:

* The blowup-B LDE domain splits into B interleaved cosets: index
  j = c + B m is the point shift w_N^c w_n^m, so coset c is a size-n
  coset NTT with shift_c = shift w_N^c, and the AIR's next-row rotation
  (a roll by B in domain order) is a roll by ONE within a coset: the
  quotient runs there at ``log_blowup = 0``.
* Z_H(x) = x^n - 1 is constant on each coset (x^n = shift_c^n), so the
  quotient's divisors at ``log_blowup = 0`` and ``shift_c`` are the
  restriction of the whole domain's.
* Row hashing streams: ``merkle.RowSponge`` absorbs each column block's
  (re, im)-interleaved rows and yields exactly ``hash_rows``'s digests.
* The batch combination is a sum over columns: it accumulates block by
  block.

Every stage runs on ``device``; only the roots, the FRI layers and the
queried rows go to the host.  With ``mesh=`` (SPMD on every rank of a
``parallel`` mesh) the commits shard: each rank transforms its share of a
block's columns, the shares are resharded from columns to rows, and each
rank's sponge absorbs its n/D rows of every coset; the digests are
gathered.  The rest runs on every rank, as without a mesh.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..ops import merkle
from ..ops.ntt import (cm31_mul_scalar, cm31_pow_scalar, coset_intt,
                       coset_ntt, intt, root_of_unity)
from ..ops.qm31 import qm31_add
from ..parallel.distributed import all_gather_rows, cols_to_rows
from .challenger import Challenger
from .constraints import N_CR_SUMS, NUM_AUX, NUM_LOOKUP, quotient_evals
from .fri import FriConfig, fri_prove
from .prover import (ConstraintViolation, _batch_powers,
                     _build_lookup_columns, _build_memory_table,
                     _channel_witnesses, _check_mesh, _combine_block,
                     _coset_shift, _gather_rows, _interleave_rows,
                     _mesh_device, _observe_crypto, _observe_io, _open_rows,
                     _pad_rows, _program_multiplicity, _query_indices,
                     _quotient_args, _quotient_chunks, _quotient_too_high,
                     _stage_logger, _sums_columns, _words, _zero_padded,
                     crypto_tape_demand,
                     extract_crypto_tape, extract_io, io_tape_demand,
                     memory_init_demand, preprocess_aux, preprocess_program)


def _coset_shifts(log_n: int, log_blowup: int, shift):
    """shift_c = shift w_N^c for each interleaved coset c of the LDE
    domain (N = 2^(log_n + log_blowup))."""
    w_big = root_of_unity(log_n + log_blowup)
    return [cm31_mul_scalar(shift, cm31_pow_scalar(w_big, c))
            for c in range(1 << log_blowup)]


def _eval_block(vr, vi, log_n: int, shift_c, out=None):
    """[B, n] CM31 values on the trace subgroup (``vi`` None: real) -> their
    evaluations on the coset ``shift_c <w_n>``: ``intt`` then
    ``coset_ntt``, two ``cm31_ntt`` launches on a GPU; into ``out`` (a
    pair of [B, n] tensors) where given."""
    cr, ci = intt(vr, vi, log_n)
    return coset_ntt(cr, ci, log_n, shift=shift_c, out=out)


def _eval_all(vals_r, vals_i, log_n: int, shift_c, block: int):
    """Every column's evaluations on one coset, block by block, each
    block's transform writing into its rows of one preallocated
    [n_cols, n] pair."""
    er = torch.empty((vals_r.shape[0], 1 << log_n), dtype=torch.int64,
                     device=vals_r.device)
    ei = torch.empty_like(er)
    for b0 in range(0, vals_r.shape[0], block):
        b1 = min(b0 + block, vals_r.shape[0])
        _eval_block(vals_r[b0:b1], None if vals_i is None else vals_i[b0:b1],
                    log_n, shift_c, out=(er[b0:b1], ei[b0:b1]))
    return er, ei


class _StreamedCommit:
    """Streamed commitment of a CM31 column matrix given by its values on
    the trace subgroup (``vals_r`` [C, n], ``vals_i`` or None for real
    columns): per coset, each column block's evaluations are absorbed into
    a ``RowSponge``; one Merkle tree over all cosets' digests; and the
    same evaluations made again, a block at a time, for the openings and
    the batch combination.

    With ``mesh`` (every rank holding all the values), the commit shards:
    each block is padded with zero columns to a multiple of D, each rank
    transforms its share, the shares are resharded from columns to rows,
    and each rank's sponge absorbs its n/D rows (a row's words are its
    own, so a row shard hashes exactly); the digests are gathered in rank
    order.  The openings and the combination make whole blocks on every
    rank."""

    def __init__(self, vals_r, vals_i, log_n: int, log_blowup: int, shift,
                 block: int, mesh=None):
        self.vals_r, self.vals_i = vals_r, vals_i
        self.log_n, self.log_blowup = log_n, log_blowup
        self.block = block
        self.mesh = mesh
        self.shifts = _coset_shifts(log_n, log_blowup, shift)
        self.n = 1 << log_n
        self.big = 1 << (log_n + log_blowup)
        self.n_cols = vals_r.shape[0]
        self.device = vals_r.device
        self.levels = None

    def _blocks(self):
        for b0 in range(0, self.n_cols, self.block):
            yield b0, min(b0 + self.block, self.n_cols)

    def coset_evals(self, c: int, b0: int, b1: int):
        """Columns [b0, b1) evaluated on coset c: an (re, im) pair of
        [b1 - b0, n] tensors."""
        return _eval_block(
            self.vals_r[b0:b1],
            None if self.vals_i is None else self.vals_i[b0:b1],
            self.log_n, self.shifts[c])

    def committed_rows(self, c: int, b0: int, b1: int):
        """This rank's interleaved rows of columns [b0, b1) on coset c: all
        n rows, or on a mesh its n/D rows, the block's pad columns
        dropped."""
        if self.mesh is None:
            return _interleave_rows(*self.coset_evals(c, b0, b1))
        d, r = self.mesh.size(), self.mesh.index
        w = -(-(b1 - b0) // d)
        lo, hi = min(b0 + r * w, b1), min(b0 + (r + 1) * w, b1)
        share = _eval_block(
            _zero_padded(self.vals_r, lo, hi, w),
            None if self.vals_i is None else _zero_padded(self.vals_i, lo,
                                                          hi, w),
            self.log_n, self.shifts[c])
        rows_r, rows_i = (cols_to_rows(x, self.mesh)[:, :b1 - b0]
                          for x in share)
        return _interleave_rows(rows_r.T, rows_i.T)

    def commit(self) -> np.ndarray:
        """The Merkle root of the interleaved rows over the whole domain;
        the tree's levels stay in ``self.levels`` (host)."""
        blowup = 1 << self.log_blowup
        leaves = torch.empty((self.big, merkle.DIGEST_WIDTH),
                             dtype=torch.int64, device=self.device)
        rows = self.n // (1 if self.mesh is None else self.mesh.size())
        for c in range(blowup):
            sponge = merkle.RowSponge(rows, device=self.device)
            for b0, b1 in self._blocks():
                sponge.absorb(self.committed_rows(c, b0, b1))
            digests = sponge.finalize()
            leaves[c::blowup] = (digests if self.mesh is None
                                 else all_gather_rows(digests, self.mesh))
        self.levels = merkle.to_host(merkle.build_tree_fused(leaves))
        return merkle.root(self.levels)

    def gather_rows(self, indices) -> Dict[int, np.ndarray]:
        """The committed rows at the given domain indices, made again (one
        block sweep a touched coset); only the gathered cells go to the
        host, in one copy a coset."""
        blowup = 1 << self.log_blowup
        by_coset: Dict[int, List[int]] = {}
        for j in sorted(set(int(j) for j in indices)):
            by_coset.setdefault(j % blowup, []).append(j // blowup)
        out: Dict[int, np.ndarray] = {}
        for c, ms in by_coset.items():
            midx = torch.tensor(ms, dtype=torch.int64, device=self.device)
            rows = torch.empty((len(ms), 2 * self.n_cols), dtype=torch.int64,
                               device=self.device)
            for b0, b1 in self._blocks():
                er, ei = self.coset_evals(c, b0, b1)
                rows[:, 2 * b0:2 * b1] = _interleave_rows(er[:, midx],
                                                          ei[:, midx])
            host = rows.cpu().numpy()
            for k, m in enumerate(ms):
                out[c + blowup * m] = host[k]
        return out

    def combine_into(self, pw):
        """sum_c pw_c col_c over the whole domain for QM31 weights ``pw``
        [C, 4] on the device: a QM31 4-tuple of [big] tensors, accumulated
        block by block."""
        blowup = 1 << self.log_blowup
        out = torch.empty((4, self.big), dtype=torch.int64,
                          device=self.device)
        for c in range(blowup):
            acc = None
            for b0, b1 in self._blocks():
                part = _combine_block(*self.coset_evals(c, b0, b1),
                                      pw[b0:b1])
                acc = part if acc is None else qm31_add(acc, part)
            for k in range(4):
                out[k, c::blowup] = acc[k]
        return tuple(out)


def prove_trace_streaming(matrix: np.ndarray,
                          fri_config: FriConfig = FriConfig(),
                          program=None, selfcheck: bool = True,
                          col_block: int = 64, mesh=None, *,
                          device) -> Dict[str, Any]:
    """Prove the trace matrix (host uint32 [rows, N_COLUMNS]) on ``device``
    (required) as ``prove_trace(matrix, fri_config, range_lookup=True,
    program=program)`` does, with the same proof, holding at most one
    column block's evaluations (``col_block`` columns on one coset) for
    the commits and one coset's evaluations of every column for the
    quotient.  Always the full constraint set (range lookups, the
    memory, I/O and crypto arguments, and program binding when
    ``program`` is given).  A violated constraint raises
    ``ConstraintViolation`` without a per-term diagnosis (``prove_trace``
    names the terms).  With ``mesh`` (every rank of a ``parallel`` mesh
    calls this with the same arguments, ``device`` naming its mesh device)
    the commits shard over the mesh (``_StreamedCommit``) and every rank
    gets the same proof."""
    if col_block < 1:
        raise ValueError(f"col_block must be >= 1, got {col_block}")
    if mesh is not None:
        device = _mesh_device(mesh, device)
    log = _stage_logger(device)
    matrix = np.asarray(matrix, dtype=np.uint32)
    n_real = matrix.shape[0]
    padded, log_n = _pad_rows(matrix, min_log=10)
    if mesh is not None:
        _check_mesh(mesh, 1 << log_n)
    if padded is matrix:
        padded = matrix.copy()          # the memory table is filled in place
    _build_memory_table(padded, n_real, program=program)
    aux_pre = preprocess_aux(log_n, fri_config.log_blowup, device=device)
    prog = None
    entry_point = 0
    if program is not None:
        code_words = list(program.code)
        entry_point = int(program.header.entry_point)
        prog = preprocess_program(code_words, log_n, fri_config,
                                  device=device)
    witnesses = _channel_witnesses(padded)
    extra = _build_lookup_columns(padded, witnesses)
    if prog is not None:
        m_prog = _program_multiplicity(padded, n_real, len(code_words))
        extra = np.concatenate([extra, m_prog[:, None]], axis=1)
    log("witness columns built")
    n_cols = padded.shape[1] + extra.shape[1]
    log_big = log_n + fri_config.log_blowup
    big = 1 << log_big
    blowup = 1 << fri_config.log_blowup
    shift = _coset_shift()
    n_sums = (NUM_LOOKUP + NUM_AUX + 4 + N_CR_SUMS
              + (1 if program is not None else 0))
    total_terms = n_cols + 2 * n_sums + 4
    if fri_config.security_bits(log_big, total_terms) \
            < fri_config.min_security:
        raise ValueError(
            f"end-to-end soundness below min_security for log_n={log_n}")

    # Phase 1: the streamed trace commitment.  The values stay on the
    # device for the whole prove; one block's evaluations at a time.
    vals = torch.cat([_words(padded, device).T,
                      _words(extra, device).T]).contiguous()
    tc = _StreamedCommit(vals, None, log_n, fri_config.log_blowup, shift,
                         col_block, mesh)
    root1 = tc.commit()
    log(f"trace committed (streamed, {n_cols} cols, 2^{log_n} rows)")

    challenger = Challenger(device=device)
    challenger.observe(log_n)
    challenger.observe(n_cols)
    challenger.observe_many(int(x) for x in root1)
    challenger.observe_many(int(x) for x in aux_pre["root"])
    if prog is not None:
        challenger.observe_many(int(x) for x in prog["root"])
        challenger.observe(entry_point)
        challenger.observe(len(code_words))
    io_inputs, io_outputs = extract_io(padded)
    _observe_io(challenger, io_inputs, io_outputs)
    crypto_tape = extract_crypto_tape(padded)
    _observe_crypto(challenger, crypto_tape)

    # Phase 1.5: the partial sums, built on the device, streamed commit.
    beta = challenger.sample_qm31()
    gamma = challenger.sample_qm31() if prog is not None else None
    delta = challenger.sample_qm31()
    eta = challenger.sample_qm31()
    s_r, s_i = _sums_columns(vals, _words(witnesses, device), aux_pre, prog,
                             beta, gamma, delta, eta)
    log(f"partial sums built ({n_sums} QM31 columns)")
    sc = _StreamedCommit(s_r, s_i, log_n, fri_config.log_blowup, shift,
                         col_block, mesh)
    root_s = sc.commit()
    log(f"partial sums committed (streamed, {n_sums} QM31 columns)")
    challenger.observe_many(int(x) for x in root_s)

    challenges = (beta, gamma, delta, eta, entry_point,
                  memory_init_demand(program, beta, delta, device=device),
                  io_tape_demand(io_inputs, io_outputs, beta, delta,
                                 device=device),
                  crypto_tape_demand(crypto_tape, beta, delta, device=device))
    alpha_c = challenger.sample_qm31()

    # Phase 2: the quotient, one coset at a time: every trace and sums
    # column's evaluations on the coset (the peak), the tables', and the
    # quotient at log_blowup = 0 (the next row one point on).  Each
    # coset's buffers are freed before the next coset's are made.
    n = 1 << log_n
    q_full = torch.empty((4, big), dtype=torch.int64, device=device)
    for c, shift_c in enumerate(tc.shifts):
        ext_r, ext_i = _eval_all(vals, None, log_n, shift_c, col_block)
        s_ext_r, s_ext_i = _eval_all(s_r, s_i, log_n, shift_c, col_block)
        aux_ext = _eval_block(aux_pre["cols_dev"], None, log_n, shift_c)
        prog_ext = (None if prog is None else
                    _eval_block(prog["cols_dev"], None, log_n, shift_c))
        q = quotient_evals(ext_r, ext_i, log_n, 0, shift_c, alpha_c,
                           **_quotient_args(s_ext_r, s_ext_i, aux_ext,
                                            prog_ext, challenges))
        for k in range(4):
            q_full[k, c::blowup] = q[k]
        del ext_r, ext_i, s_ext_r, s_ext_i, aux_ext, prog_ext, q
        log(f"quotient coset {c + 1}/{blowup} evaluated")

    # Chunk Q = Q0 + x^n Q1 (QM31 -> two CM31 coordinate polynomials each).
    q_coef = [coset_intt(q_full[0], q_full[1], log_big, shift=shift),
              coset_intt(q_full[2], q_full[3], log_big, shift=shift)]
    del q_full
    if selfcheck and _quotient_too_high(q_coef, n):
        raise ConstraintViolation(
            "trace violates the constraint system (streaming prover; "
            "run prove_trace on a prefix for a per-term diagnosis)")
    q_cm_cols = _quotient_chunks(q_coef, n, log_big, shift)
    del q_coef
    q_rows = torch.stack([cc for pair in q_cm_cols for cc in pair], dim=1)
    levels2 = merkle.to_host(merkle.build_tree_fused(
        merkle.hash_rows(q_rows)))
    root2 = merkle.root(levels2)
    challenger.observe_many(int(x) for x in root2)
    log("quotient committed (per-coset streamed)")
    alpha_b = challenger.sample_qm31()

    # The batch combination, accumulated block by block, then FRI.
    pw = _batch_powers(total_terms, alpha_b, device)
    batch = qm31_add(tc.combine_into(pw[:n_cols]),
                     sc.combine_into(pw[n_cols:n_cols + 2 * n_sums]))
    batch = qm31_add(batch, _combine_block(
        torch.stack([cc[0] for cc in q_cm_cols]),
        torch.stack([cc[1] for cc in q_cm_cols]), pw[n_cols + 2 * n_sums:]))
    del q_cm_cols, pw
    log("batch combination accumulated")
    fri_proof = fri_prove(batch, log_big, challenger, fri_config,
                          shift=shift)
    del batch
    log("fri done")

    # Openings: the queried rows of each streamed commitment made again (a
    # block sweep a touched coset); the others gathered where they lie.
    all_indices = sorted({
        j for steps in fri_proof["queries"]
        for j in _query_indices(steps[0]["leaf_idx"], big, blowup)})
    trees = [("trace", tc.gather_rows(all_indices), tc.levels),
             ("quotient", _gather_rows(q_rows, all_indices), levels2),
             ("sums", sc.gather_rows(all_indices), sc.levels),
             ("aux", _gather_rows(aux_pre["rows"], all_indices),
              aux_pre["levels"])]
    if prog is not None:
        trees.append(("prog", _gather_rows(prog["rows"], all_indices),
                      prog["levels"]))
    openings = []
    for steps in fri_proof["queries"]:
        indices = _query_indices(steps[0]["leaf_idx"], big, blowup)
        openings.append({name: _open_rows(rows, levels, indices)
                         for name, rows, levels in trees})
    log("openings gathered")

    out = {
        "log_n": log_n,
        "n_cols": n_cols,
        "range_lookup": True,
        "trace_root": [int(x) for x in root1],
        "quotient_root": [int(x) for x in root2],
        "fri": fri_proof,
        "openings": openings,
        "sums_root": [int(x) for x in root_s],
        "io": {"inputs": io_inputs, "outputs": io_outputs},
        "crypto": crypto_tape,
    }
    if prog is not None:
        out["program"] = {
            "root": prog["root"],
            "entry": entry_point,
            "n_code": len(code_words),
        }
    return out
