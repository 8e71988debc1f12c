"""Merkle trees over Poseidon2-M31 digests on torch tensors.

Counterpart of ``zkir_tpu/ops/merkle.py``.  Leaf digests are Poseidon2
sponge hashes of matrix rows, internal nodes the 2-to-1 compression;
digests are 8 canonical words (int64 ``[..., 8]`` on the device, numpy
``uint32`` on the host).  On a GPU, ``hash_rows`` is one launch of K2's
row sponge and ``build_tree`` one launch of its whole-tree kernel
(``p2_merkle_tree``), which writes every internal level into one
``[n - 1, 8]`` buffer; the levels are views of it, and ``to_host`` copies
it in one piece.  ``RowSponge`` hashes the rows of a matrix fed to it a
column block at a time (the streaming prover's commits): on a GPU one
``p2_sponge_absorb`` launch a block, which resumes the rows' sponge states
in device memory.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..spec.field import M31_PRIME
from .poseidon2 import (_check_words, _sponge_rows, compress_level_plain,
                        poseidon2_compress_batch, sponge_absorb)
from .poseidon2_ref import RATE, WIDTH

DIGEST_WIDTH = RATE  # 8 field elements


def hash_rows(matrix) -> torch.Tensor:
    """Hash each row of an int64 [n, w] matrix to a digest [n, 8].

    The sponge's 1||0* padding is always appended, even when w is a
    multiple of 8 (as poseidon2_ref.poseidon2_sponge)."""
    return _sponge_rows(matrix, pad=True)


class RowSponge:
    """Incremental row hashing: feed an [n, w] matrix column chunk by
    column chunk and get exactly ``hash_rows``'s digests of the whole.

    The streaming prover commits wide matrices one column block at a time
    (peak device memory O(block x domain), not O(all columns x domain)),
    with one Merkle tree and one opening path a query however many blocks
    streamed in.  The states [n, 16] live on ``device``; the words of a
    chunk that do not fill a rate block wait in ``pending`` for the next
    chunk, as in the reference."""

    def __init__(self, n: int, *, device):
        self.n = n
        self.states = torch.zeros((n, WIDTH), dtype=torch.int64,
                                  device=device)
        self.pending = torch.zeros((n, 0), dtype=torch.int64, device=device)

    def absorb(self, chunk) -> None:
        """Absorb the next columns, int64 [n, c]."""
        buf = (torch.cat([self.pending, chunk], dim=1)
               if self.pending.shape[1] else chunk)
        whole = buf.shape[1] // RATE * RATE
        if whole:
            sponge_absorb(self.states,
                          buf if whole == buf.shape[1] else buf[:, :whole],
                          pad=False)
        self.pending = buf[:, whole:].clone()

    def finalize(self) -> torch.Tensor:
        """Absorb the pending words with the 1||0* padding and return the
        digests [n, 8].  The sponge is spent after this."""
        sponge_absorb(self.states, self.pending, pad=True)
        return self.states[:, :RATE].contiguous()


def _level_views(nodes, n: int) -> List[torch.Tensor]:
    """Levels 1 .. log2 n as views of the [n - 1, 8] buffer ``nodes``:
    level j (n >> j rows) from row n - (n >> (j - 1)), the root last."""
    views, row, m = [], 0, n // 2
    while m:
        views.append(nodes[row:row + m])
        row, m = row + m, m // 2
    return views


def build_tree(leaves) -> List[torch.Tensor]:
    """Merkle tree levels from leaf digests [n, 8] (n a power of 2):
    levels[0] = leaves .. levels[-1] = the [1, 8] root.  Levels 1.. are
    views of one [n - 1, 8] buffer; on a GPU one ``p2_merkle_tree``
    launch fills it."""
    n = leaves.shape[0]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    if not leaves.is_cuda:
        return build_tree_plain(leaves)
    from .. import _kernels

    leaves = _check_words(leaves, DIGEST_WIDTH)
    nodes = torch.empty((max(n - 1, 0), DIGEST_WIDTH), dtype=torch.int64,
                        device=leaves.device)
    if n > 1:
        _kernels.launch("p2_merkle_tree", leaves.data_ptr(), nodes.data_ptr(),
                        n)
    return [leaves] + _level_views(nodes, n)


def build_tree_plain(leaves) -> List[torch.Tensor]:
    """``build_tree`` in plain torch: ``compress_level_plain`` level by
    level into the same single buffer, returned through the same views."""
    n = leaves.shape[0]
    nodes = torch.empty((max(n - 1, 0), DIGEST_WIDTH), dtype=torch.int64,
                        device=leaves.device)
    views = _level_views(nodes, n)
    cur = leaves
    for view in views:
        view.copy_(compress_level_plain(cur))
        cur = view
    return [leaves] + views


def build_tree_fused(leaves) -> List[torch.Tensor]:
    """The same levels as ``build_tree``, which already builds a tree in
    one launch (the reference's ``build_tree_fused`` fuses its per-level
    dispatches into one XLA program)."""
    return build_tree(leaves)


def to_host(levels) -> List[np.ndarray]:
    """Tree levels as host uint32 arrays (path opening is host-side
    random access): the leaves in one copy, the internal levels, views of
    one buffer as ``build_tree`` returns them, in one more."""
    out = [levels[0].cpu().numpy().astype(np.uint32)]
    if len(levels) == 1:
        return out
    first = levels[1]
    storage = first.untyped_storage().data_ptr()
    row = 0
    for level in levels[1:]:
        at = first.data_ptr() + level.element_size() * DIGEST_WIDTH * row
        if level.untyped_storage().data_ptr() != storage \
                or level.data_ptr() != at or not level.is_contiguous():
            raise ValueError("tree levels are not views of one buffer, as "
                             "build_tree returns them")
        row += level.shape[0]
    nodes = first.as_strided((row, DIGEST_WIDTH), (DIGEST_WIDTH, 1))
    host = nodes.cpu().numpy().astype(np.uint32)
    row = 0
    for level in levels[1:]:
        out.append(host[row:row + level.shape[0]])
        row += level.shape[0]
    return out


def root(levels) -> np.ndarray:
    r = levels[-1][0]
    if isinstance(r, torch.Tensor):
        r = r.cpu().numpy()
    return np.asarray(r, dtype=np.uint32)


def open_path(levels, index: int) -> List[np.ndarray]:
    """Sibling digests from leaf to root for one leaf index."""
    path = []
    for level in levels[:-1]:
        sib = level[index ^ 1]
        if isinstance(sib, torch.Tensor):
            sib = sib.cpu().numpy()
        path.append(np.asarray(sib, dtype=np.uint32))
        index >>= 1
    return path


def hash_row_host(row) -> List[int]:
    """Host-scalar digest of one row, identical to ``hash_rows`` on a
    [1, w] matrix (1||0* rate padding + sponge) — used by verifiers,
    where one row per query beats a device round-trip."""
    from .poseidon2_ref import poseidon2_sponge

    return poseidon2_sponge([int(x) for x in row])


def verify_path(root_digest, index: int, leaf_digest,
                path: List[np.ndarray]) -> bool:
    """Recompute the root from a leaf and its sibling path.

    Host-scalar: a verifier touches one leaf per level — a Python
    permutation per step beats a device dispatch round-trip."""
    from .poseidon2_ref import poseidon2_compress

    cur = [int(x) for x in np.asarray(leaf_digest)]
    for sibling in path:
        sib = [int(x) for x in np.asarray(sibling)]
        cur = (poseidon2_compress(sib, cur) if index & 1
               else poseidon2_compress(cur, sib))
        index >>= 1
    return cur == [int(x) for x in np.asarray(root_digest)]



def verify_rows(root_digest, indices, rows, paths,
                depth: int) -> List[bool]:
    """For each opened row of one tree of ``depth`` levels: whether its
    digest (as ``hash_rows`` hashes it) leads along its sibling path to
    ``root_digest``.

    ``hash_row_host`` and ``verify_path`` for every row at once: all rows
    go through one sponge batch and each level of all paths is one
    compression batch (on the CPU, the plain torch permutation), where
    the scalar versions run one Python permutation per step.  Rows must
    share one width.  Words enter reduced mod p, as the scalar sponge
    and compression reduce them.  A path that is not ``depth`` digests of
    8 words is rejected (the scalar version would need a Poseidon2
    preimage to accept it)."""
    if not rows:
        return []
    ok = [len(p) == depth and all(len(s) == DIGEST_WIDTH for s in p)
          for p in paths]
    blank = [[0] * DIGEST_WIDTH] * depth
    sib = torch.tensor(
        [[[int(x) % M31_PRIME for x in s] for s in p] if good else blank
         for p, good in zip(paths, ok)],
        dtype=torch.int64).reshape(len(paths), depth, DIGEST_WIDTH)
    cur = hash_rows(torch.tensor([[int(x) % M31_PRIME for x in r]
                                  for r in rows], dtype=torch.int64))
    idx = torch.tensor(list(indices), dtype=torch.int64)
    for level in range(depth):
        is_right = ((idx >> level) & 1).bool()[:, None]
        s = sib[:, level]
        cur = poseidon2_compress_batch(torch.where(is_right, s, cur),
                                       torch.where(is_right, cur, s))
    want = torch.as_tensor(np.asarray(root_digest, dtype=np.int64))
    if want.shape != (DIGEST_WIDTH,):
        return [False] * len(rows)
    match = (cur == want).all(dim=1).tolist()
    return [good and m for good, m in zip(ok, match)]
