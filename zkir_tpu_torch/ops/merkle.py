"""Merkle trees over Poseidon2-M31 digests on torch tensors.

Counterpart of ``zkir_tpu/ops/merkle.py``.  Leaf digests are Poseidon2
sponge hashes of matrix rows, internal nodes the 2-to-1 compression;
digests are 8 canonical words (int64 ``[..., 8]`` on the device, numpy
``uint32`` on the host).  On a GPU, ``hash_rows`` is one launch of K2's
row sponge and each tree level one launch of its level compression.

``RowSponge`` (column-streamed leaf hashing) is not ported yet: it
serves the streaming prover only.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..spec.field import M31_PRIME
from .poseidon2 import (_sponge_rows, poseidon2_compress_batch,
                        poseidon2_compress_level)
from .poseidon2_ref import RATE

DIGEST_WIDTH = RATE  # 8 field elements


def hash_rows(matrix) -> torch.Tensor:
    """Hash each row of an int64 [n, w] matrix to a digest [n, 8].

    The sponge's 1||0* padding is always appended, even when w is a
    multiple of 8 (as poseidon2_ref.poseidon2_sponge)."""
    return _sponge_rows(matrix, pad=True)


def build_tree(leaves) -> List[torch.Tensor]:
    """Merkle tree levels from leaf digests [n, 8] (n a power of 2):
    levels[0] = leaves .. levels[-1] = the [1, 8] root."""
    n = leaves.shape[0]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = poseidon2_compress_level(cur)
        levels.append(cur)
    return levels


def build_tree_fused(leaves) -> List[torch.Tensor]:
    """The same levels as ``build_tree`` (the reference fuses the levels
    into one XLA program; here each level is already one launch)."""
    return build_tree(leaves)


def to_host(levels) -> List[np.ndarray]:
    """Tree levels as host uint32 arrays (path opening is host-side
    random access)."""
    return [lv.cpu().numpy().astype(np.uint32) for lv in levels]


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
