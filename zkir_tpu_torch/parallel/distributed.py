"""Distributed kernels: four-step NTT, sharded Merkle, sharded trace gen.

Counterpart of ``zkir_tpu/parallel/distributed.py``.  The reference writes
each function as one program over global arrays (``shard_map``), and XLA
moves the shards between devices.  Here every rank of the mesh runs the
function on its own shard (SPMD), and each transfer is an explicit
collective on the mesh's process group:

- NTT: the four-step factorization n = n1 x n2.  The length-n1 transforms
  of a rank's columns are local, the twiddle multiply is elementwise, and
  the transpose is one ``all_to_all_single`` per part (re, im), the only
  traffic; then the length-n2 transforms of the rank's rows.
- Reshards: ``cols_to_rows`` turns a rank's block of columns into its
  block of rows (the four-step's transpose, and the sharded prover's move
  from the column-sharded LDE to row-sharded hashing); ``all_gather_rows``
  stacks every rank's rows in rank order.
- Merkle: each rank hashes its row shard into a subtree, the sub-roots
  are ``all_gather``-ed in rank order, and every rank builds the same top
  of the tree.
- Trace generation: each rank runs its lanes (pure data parallelism);
  ``prove_step_sharded`` ``all_gather``s the registers where the
  reference's XLA reshards them by itself.

What a rank passes is what it holds at the call: ``dist_ntt`` and
``dist_lde`` the whole input (every rank the same words; each takes its
own block), ``dist_merkle_root`` its row shard (``dist_ntt``'s output
layout), ``sharded_interpreter_state`` the whole state.  A result is the
rank's shard, or the whole of it where the reference's is replicated
(``dist_ntt_natural``, ``dist_merkle_root``).

The kernels are the single-device port's, on the mesh's device: on a GPU
``cm31_ntt``, K1's ``cm31_binary``, K2's ``p2_sponge_rows`` and
``p2_merkle_tree`` and K3's ``interp_run``; on the CPU their plain
versions.  The collectives run for a mesh of one rank too.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..interp.columnar import MachineState
from ..ops import merkle
from ..ops.ntt import _twiddle_table, cm31_mul, cm31_ntt, lde
from ..spec.field import M31_PRIME
from .mesh import Mesh


def _place(mesh: Mesh, axis: str) -> Tuple[int, int]:
    """(mesh size, this rank's index on ``axis``)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, not {axis!r}")
    if mesh.index is None:
        raise ValueError("this rank is not in the mesh")
    return mesh.size(), mesh.index


def _on_mesh(mesh: Mesh, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != mesh.device:
            raise ValueError(f"a tensor on {t.device} for a mesh on "
                             f"{mesh.device}")


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) stacked along dim 0
    in rank order: one ``all_gather`` into views of one tensor."""
    x = x.contiguous()
    out = torch.empty((mesh.size() * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.chunk(mesh.size())), x, group=mesh.group)
    return out


# ============================================================================
# Four-step distributed NTT
# ============================================================================


def _four_step_twiddles(log_n1: int, log_n2: int, lo: int = 0,
                        hi: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Twiddle matrix T[k1, j2] = w_n^(k1 * j2) as uint32 pairs, columns
    ``lo`` .. ``hi`` (default all)."""
    log_n = log_n1 + log_n2
    n = 1 << log_n
    twr, twi = _twiddle_table(log_n, inverse=False)
    k1 = np.arange(1 << log_n1, dtype=np.int64)[:, None]
    j2 = np.arange(lo, (1 << log_n2) if hi is None else hi,
                   dtype=np.int64)[None, :]
    idx = (k1 * j2) % n
    return twr[idx], twi[idx]


@functools.lru_cache(maxsize=None)
def _twiddle_block(log_n1: int, log_n2: int, d: int, index: int, device):
    """Rank ``index``'s columns of T, transposed to the [n2/d, n1] layout
    of its column transforms, as int64 words on ``device``: uploaded once
    per rank."""
    w = (1 << log_n2) // d
    return tuple(torch.from_numpy(np.ascontiguousarray(a.T, dtype=np.int64))
                 .to(device)
                 for a in _four_step_twiddles(log_n1, log_n2, index * w,
                                              (index + 1) * w))


def _split(log_n: int, d: int) -> Tuple[int, int]:
    log_d = d.bit_length() - 1
    if 1 << log_d != d:
        raise ValueError(f"device count {d} is not a power of two")
    log_n1 = log_n // 2
    log_n2 = log_n - log_n1
    if log_n1 < log_d or log_n2 < log_d:
        raise ValueError(f"domain 2^{log_n} too small for a mesh of {d}")
    return log_n1, log_n2


def cols_to_rows(blk: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The column-to-row reshard of one part: ``blk`` is this rank's block
    of columns [C/D, M] (each row of ``blk`` a column), and the result is
    this rank's block of rows [M/D, C] of the whole [M, C] matrix, the
    columns of ranks 0 .. D-1 side by side in column order.  One
    ``all_to_all_single``: rank s gets rows s*M/D .. of every rank's
    columns (the reference's ``jax.device_put`` of the transpose onto a
    row sharding)."""
    d, w, m = mesh.size(), blk.shape[0], blk.shape[1]
    send = blk.T.contiguous()                 # [M, C/D], rows in order
    recv = torch.empty_like(send)             # [D, M/D, C/D] by source rank
    dist.all_to_all_single(recv, send, group=mesh.group)
    return recv.view(d, m // d, w).transpose(0, 1).reshape(m // d, d * w)


def dist_ntt(re, im, mesh: Mesh, log_n: int, axis: str = "d"):
    """Distributed forward NTT of a 2^log_n vector (int64 words, the whole
    vector on every rank).

    Input viewed as row-major [n1, n2] with j = j1*n2 + j2; this rank
    transforms its columns j2 in [r*n2/D, (r+1)*n2/D) and returns its rows
    [n1/D, n2] of Z, where X[k1 + n1*k2] = Z[k1, k2] (the rows of all
    ranks in rank order make Z; natural order: ``Z.T.ravel()``)."""
    d, r = _place(mesh, axis)
    _on_mesh(mesh, re, im)
    log_n1, log_n2 = _split(log_n, d)
    n1, n2 = 1 << log_n1, 1 << log_n2
    cols = slice(r * n2 // d, (r + 1) * n2 // d)
    # Step 1: length-n1 NTTs of the rank's columns, each a row of the
    # transposed block [n2/D, n1].
    zr, zi = cm31_ntt(re.reshape(n1, n2)[:, cols].T.contiguous(),
                      im.reshape(n1, n2)[:, cols].T.contiguous(), log_n1,
                      inverse=False)
    # Step 2: twiddle multiply by the rank's block of T (transposed).
    zr, zi = cm31_mul((zr, zi),
                      _twiddle_block(log_n1, log_n2, d, r, re.device))
    # Step 3: transpose reshard [n1, n2/D] -> [n1/D, n2].
    zr, zi = cols_to_rows(zr, mesh), cols_to_rows(zi, mesh)
    # Step 4: length-n2 NTTs of the rank's rows.
    return cm31_ntt(zr, zi, log_n2, inverse=False)


def dist_ntt_natural(re, im, mesh: Mesh, log_n: int, axis: str = "d"):
    """Distributed NTT returning the 1-D natural-order result on every
    rank (an ``all_gather`` of the rows; for tests)."""
    zr, zi = dist_ntt(re, im, mesh, log_n, axis)
    return (all_gather_rows(zr, mesh).T.reshape(-1),
            all_gather_rows(zi, mesh).T.reshape(-1))


def dist_lde(cols_r, cols_i, mesh: Mesh, log_n: int, log_blowup: int,
             shift=(1, 0), axis: str = "d"):
    """Column-sharded low-degree extension: each rank extends its block of
    the columns (``ops.ntt.lde``), with no communication, and returns it.

    cols_r/cols_i: int64 [n_cols, 2^log_n], every column on every rank
    (``cols_i`` may be ``None``); n_cols must divide evenly over the mesh
    (pad with zero columns if needed).  Rank r's result is rows
    [r*n_cols/D, (r+1)*n_cols/D) of the single-device ``lde``."""
    d, r = _place(mesh, axis)
    _on_mesh(mesh, cols_r, cols_i)
    n_cols = cols_r.shape[0]
    if n_cols % d:
        raise ValueError(f"{n_cols} columns do not divide over a mesh of "
                         f"{d}: pad with zero columns")
    rows = slice(r * n_cols // d, (r + 1) * n_cols // d)
    return lde(cols_r[rows], None if cols_i is None else cols_i[rows],
               log_n, log_blowup, shift=shift)


# ============================================================================
# Distributed Merkle
# ============================================================================


def dist_merkle_root(rows, mesh: Mesh, axis: str = "d"):
    """Merkle root [8] of a row-sharded matrix: ``rows`` is this rank's
    shard (int64 [n/D, w], rank r's rows r*n/D ..); a subtree over it,
    then an ``all_gather`` of the sub-roots and a top tree that every rank
    builds alike.

    Equals the single-device tree's root for power-of-two row counts."""
    _place(mesh, axis)
    _on_mesh(mesh, rows)
    sub_root = merkle.build_tree(merkle.hash_rows(rows))[-1]      # [1, 8]
    roots = all_gather_rows(sub_root, mesh)                       # [D, 8]
    return merkle.build_tree(roots)[-1][0]


# ============================================================================
# Sharded trace generation
# ============================================================================


def sharded_interpreter_state(state: MachineState, mesh: Mesh,
                              axis: str = "d") -> MachineState:
    """This rank's lanes [r*L/D, (r+1)*L/D) of every field of a
    ``MachineState`` of L lanes (memory images included), copied to the
    mesh's device.  The shard runs through the interpreter of its lane
    count, ``TpuInterpreter.with_lanes(L // D)``."""
    d, r = _place(mesh, axis)
    lanes = state.pc.shape[0]
    if lanes % d:
        raise ValueError(f"{lanes} lanes do not divide over a mesh of {d}")
    k = lanes // d
    return MachineState(*(t[r * k:(r + 1) * k].to(mesh.device, copy=True)
                          for t in state))


# ============================================================================
# One sharded prove step
# ============================================================================


def prove_step_sharded(interp, state: MachineState, mesh: Mesh,
                       log_n: int = 12, axis: str = "d"):
    """One end-to-end step over the mesh: a chunk of this rank's lanes
    (``state``, its shard of ``interp``'s lanes) through ``interp_run``, a
    distributed NTT of a column derived from every lane's registers, and
    a distributed Merkle root of the NTT's rows.  Returns (the rank's new
    state shard, the root [8], the same on every rank)."""
    d, _ = _place(mesh, axis)
    lanes = interp.config.lanes
    if lanes % d or state.pc.shape[0] != lanes // d:
        raise ValueError(f"a shard of {state.pc.shape[0]} lanes for "
                         f"{lanes} lanes over a mesh of {d}")
    new_state, _ = interp.with_lanes(lanes // d).chunk_fn(state)
    # The low 20 bits of every lane's registers in global lane order
    # (the reference's regs_lo are the low 32 bits of these words), tiled
    # to 2^log_n.
    col = all_gather_rows(new_state.regs, mesh).reshape(-1) & 0xFFFFF
    n = 1 << log_n
    col = col.repeat(n // col.shape[0] + 1)[:n] % M31_PRIME
    zr, zi = dist_ntt(col, torch.zeros_like(col), mesh, log_n, axis)
    rows = torch.stack([zr.reshape(-1), zi.reshape(-1)], dim=1)
    return new_state, dist_merkle_root(rows, mesh, axis)
