"""Batched Poseidon2 permutation over Mersenne-31 on torch tensors.

Counterpart of ``zkir_tpu/ops/poseidon2.py``.  States are int64
``[N, 16]`` tensors of canonical words.  On a GPU every entry point
launches kernel K2 (``csrc/poseidon2.cu``):

- ``poseidon2_permute_batch``: ``p2_permute``, one thread per state;
- ``poseidon2_sponge_batch`` / ``merkle.hash_rows``: ``p2_sponge_rows``,
  one thread absorbing a whole row;
- ``poseidon2_compress_level`` (and ``merkle.build_tree``):
  ``p2_compress_level``, one tree level per launch.

On the CPU they run the plain versions below, which follow the
reference's ``[16, N]`` layout (``_permute_t``): the batch on the minor
axis, the 16 state words on the major one.  They are plain torch
integer arithmetic (exact int64 sums and products, reduced mod p with
``%``), so comparing K2 with them launches no kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .field_ops import P, add_plain
from .poseidon2_ref import RATE, ROUNDS_F, ROUNDS_P, WIDTH, poseidon2_params


@functools.lru_cache(maxsize=None)
def _params_np():
    external, internal, diag = poseidon2_params()
    p = (1 << 31) - 1
    dm1 = [(d - 1) % p for d in diag]
    return (
        np.asarray(external, dtype=np.uint32),     # [ROUNDS_F, 16]
        np.asarray(internal, dtype=np.uint32),     # [ROUNDS_P]
        np.asarray(dm1, dtype=np.uint32),          # [16] = diag - 1 mod p
    )


@functools.lru_cache(maxsize=None)
def params(device) -> tuple:
    """The plain version's round constants as int64 tensors on ``device``:
    (external [8, 16], internal [14], diag - 1 [16])."""
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in _params_np())


# ============================================================================
# Plain torch version ([16, N] layout)
# ============================================================================


def _sbox(x):
    """x^5 of canonical words."""
    x2 = x * x % P
    x4 = x2 * x2 % P
    return x4 * x % P


def _ext_matrix_t(x):
    """M_E = circ(2*M4, M4, M4, M4) on [16, N]: per-block M4 plus the
    cross-block sums, in exact int64 sums (< 2^39) reduced once."""
    b = x.reshape(4, 4, -1)
    x0, x1, x2, x3 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]  # each [4, N]
    t0 = x0 + x1
    t1 = x2 + x3
    t2 = 2 * x1 + t1
    t3 = 2 * x3 + t0
    t4 = 4 * t1 + t3
    t5 = 4 * t0 + t2
    y = torch.stack([t3 + t5, t5, t2 + t4, t4], dim=1)  # [4, 4, N]
    return ((y + y.sum(dim=0, keepdim=True)) % P).reshape(16, -1)


def _int_matrix_t(x, dm1):
    """(M_I x)_i = sum(x) + (diag_i - 1) * x_i on [16, N] (< 2^63)."""
    return (x.sum(dim=0, keepdim=True) + dm1[:, None] * x) % P


def _permute_t(x, external, internal, dm1):
    """Permutation on [16, N]."""
    x = _ext_matrix_t(x)
    half = ROUNDS_F // 2
    for r in range(half):
        x = _ext_matrix_t(_sbox((x + external[r][:, None]) % P))
    for r in range(ROUNDS_P):
        x0 = _sbox((x[0:1] + internal[r]) % P)
        x = _int_matrix_t(torch.cat([x0, x[1:]], dim=0), dm1)
    for r in range(half, ROUNDS_F):
        x = _ext_matrix_t(_sbox((x + external[r][:, None]) % P))
    return x


def permute_plain(states):
    """[N, 16] -> [N, 16] in plain torch."""
    return _permute_t(states.T, *params(states.device)).T.contiguous()


def sponge_rows_plain(matrix, pad: bool = True):
    """Digest [n, 8] of each row of [n, w] in plain torch: rate-8 blocks,
    then (``pad``) the 1||0* padding, always appended."""
    n, w = matrix.shape
    if pad:
        padded_w = ((w + 1 + RATE - 1) // RATE) * RATE
        tail = torch.zeros((n, padded_w - w), dtype=torch.int64,
                           device=matrix.device)
        tail[:, 0] = 1
        matrix = torch.cat([matrix, tail], dim=1)
    cols = matrix.T                                          # [w', n]
    prm = params(matrix.device)
    state = torch.zeros((WIDTH, n), dtype=torch.int64, device=matrix.device)
    for off in range(0, cols.shape[0], RATE):
        state = torch.cat([add_plain(state[:RATE], cols[off:off + RATE]),
                           state[RATE:]], dim=0)
        state = _permute_t(state, *prm)
    return state[:RATE].T.contiguous()


def compress_level_plain(level):
    """One Merkle level [2m, 8] -> [m, 8] in plain torch."""
    left = level[0::2]
    out = permute_plain(level.reshape(-1, 2 * RATE))
    return add_plain(out[:, :RATE], left)


# ============================================================================
# Dispatching entry points
# ============================================================================


def _check_words(t, width=None):
    if t.dtype != torch.int64:
        raise TypeError(f"M31 words must be int64, got {t.dtype}")
    if t.dim() != 2 or (width is not None and t.shape[1] != width):
        raise ValueError(f"expected [N, {width or 'w'}], got {tuple(t.shape)}")
    return t.contiguous()


def poseidon2_permute_batch(states):
    """Permute a batch of states: int64 [N, 16] -> [N, 16]."""
    if not states.is_cuda:
        return permute_plain(states)
    from .. import _kernels

    states = _check_words(states, WIDTH)
    out = torch.empty_like(states)
    if states.shape[0]:
        _kernels.launch("p2_permute", states.data_ptr(), out.data_ptr(),
                        states.shape[0])
    return out


def _sponge_rows(matrix, pad: bool):
    if not matrix.is_cuda:
        return sponge_rows_plain(matrix, pad)
    from .. import _kernels

    matrix = _check_words(matrix)
    n, w = matrix.shape
    out = torch.empty((n, RATE), dtype=torch.int64, device=matrix.device)
    if n:
        _kernels.launch("p2_sponge_rows", matrix.data_ptr(), out.data_ptr(),
                        n, w, int(pad))
    return out


def poseidon2_sponge_batch(blocks):
    """Batched sponge over pre-padded rate blocks [N, n_blocks, 8] ->
    [N, 8]."""
    return _sponge_rows(blocks.reshape(blocks.shape[0], -1), pad=False)


def poseidon2_compress_level(level):
    """One Merkle level: [2m, 8] -> [m, 8], node i compressing rows 2i
    and 2i + 1."""
    if not level.is_cuda:
        return compress_level_plain(level)
    from .. import _kernels

    level = _check_words(level, RATE)
    m = level.shape[0] // 2
    out = torch.empty((m, RATE), dtype=torch.int64, device=level.device)
    if m:
        _kernels.launch("p2_compress_level", level.data_ptr(), out.data_ptr(),
                        m)
    return out


def poseidon2_compress_batch(left, right):
    """Batched 2-to-1 Merkle compression: [N, 8] x [N, 8] -> [N, 8],
    permute(left || right)[:8] + left."""
    return poseidon2_compress_level(
        torch.stack([left, right], dim=1).reshape(-1, RATE))
