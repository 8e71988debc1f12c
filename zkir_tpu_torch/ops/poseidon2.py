"""Batched Poseidon2 permutation over Mersenne-31 on torch tensors.

Counterpart of ``zkir_tpu/ops/poseidon2.py``.  States are int64
``[N, 16]`` tensors of canonical words.  On a GPU every entry point
launches kernel K2 (``csrc/poseidon2.cu``):

- ``poseidon2_permute_batch``: ``p2_permute``, one thread per state;
- ``poseidon2_sponge_batch`` / ``merkle.hash_rows``: ``p2_sponge_rows``,
  one thread absorbing a whole row;
- ``sponge_absorb`` (``merkle.RowSponge``, the streaming prover's row
  hashing): ``p2_sponge_absorb``, the same thread a row, resumed from and
  stored to states in device memory;
- ``poseidon2_compress_level`` / ``poseidon2_compress_batch``:
  ``p2_compress_level``, one tree level per launch (``merkle.build_tree``
  builds a whole tree in one launch of ``p2_merkle_tree``);
- ``sponge_hash_rows`` / ``sponge_hash_bytes_batch`` (the interpreter's
  Poseidon2 syscalls, all paused lanes at once): ``p2_sponge_bytes``, the
  rows' bytes read where they lie, 4 lanes a row, the whole batch in one
  launch;
- ``grind``: ``p2_grind``, the transcript's proof-of-work search in one
  host call (the 16 words go up as a launch parameter, the nonce comes
  back through a pinned word).

On the CPU they run the plain versions below, which follow the
reference's ``[16, N]`` layout (``_permute_t``): the batch on the minor
axis, the 16 state words on the major one.  They are plain torch
integer arithmetic (exact int64 sums and products, reduced mod p with
``%``), so comparing K2 with them launches no kernel.
"""

from __future__ import annotations

import ctypes
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


def sponge_absorb_plain(states, matrix, pad: bool):
    """The row sponges' states [n, 16] after absorbing each row of [n, w]
    in plain torch: rate-8 blocks, then (``pad``) the 1||0* padding,
    always appended.  Returns new states; ``states`` is not changed."""
    n, w = matrix.shape
    if pad:
        padded_w = ((w + 1 + RATE - 1) // RATE) * RATE
        tail = torch.zeros((n, padded_w - w), dtype=torch.int64,
                           device=matrix.device)
        tail[:, 0] = 1
        matrix = torch.cat([matrix, tail], dim=1)
    elif w % RATE:
        raise ValueError(f"unpadded sponge input of {w} words is not whole "
                         f"rate-{RATE} blocks")
    cols = matrix.T                                          # [w', n]
    prm = params(matrix.device)
    state = states.T
    for off in range(0, cols.shape[0], RATE):
        state = torch.cat([add_plain(state[:RATE], cols[off:off + RATE]),
                           state[RATE:]], dim=0)
        state = _permute_t(state, *prm)
    return state.T.contiguous()


def sponge_rows_plain(matrix, pad: bool = True):
    """Digest [n, 8] of each row of [n, w] in plain torch: the sponge from
    the zero state (``sponge_absorb_plain``), its first 8 words."""
    zero = torch.zeros((matrix.shape[0], WIDTH), dtype=torch.int64,
                       device=matrix.device)
    return sponge_absorb_plain(zero, matrix, pad)[:, :RATE].contiguous()


def compress_level_plain(level):
    """One Merkle level [2m, 8] -> [m, 8] in plain torch."""
    left = level[0::2]
    out = permute_plain(level.reshape(-1, 2 * RATE))
    return add_plain(out[:, :RATE], left)


# Nonces are searched below this (the search is unbounded in expectation).
GRIND_LIMIT = 1 << 34


def grind_plain(state, bits: int, device="cpu") -> int:
    """The lowest nonce whose trial state (``state``, 16 canonical words,
    with word 0 replaced by ``(state[0] + nonce) mod p``) permutes to a
    word ``RATE - 1`` with its low ``bits`` bits clear, in plain torch:
    batches of candidate rows through ``permute_plain``.  The lowest hit
    wins, so the batch size never changes the result."""
    base = np.asarray(state, dtype=np.uint32)
    mask = (1 << bits) - 1
    batch = min(1 << (bits + 2), 1 << 16)
    for start in range(0, GRIND_LIMIT, batch):
        nonces = np.arange(start, start + batch, dtype=np.uint64)
        states = np.broadcast_to(base, (batch, WIDTH)).copy()
        states[:, 0] = ((base[0] + nonces) % P).astype(np.uint32)
        out = permute_plain(
            torch.from_numpy(states.astype(np.int64)).to(device))
        hits = ((out[:, RATE - 1] & mask) == 0).nonzero()
        if hits.numel():
            return int(nonces[int(hits[0, 0])])
    raise RuntimeError("grinding search exhausted")  # pragma: no cover


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


def sponge_hash_bytes_batch(messages, device):
    """Sponge digests (int64 ``[n, 8]`` on ``device``) of ``n`` byte
    strings of any lengths, as ``poseidon2_ref.poseidon2_sponge_hash_bytes``
    gives them one by one (``sponge_hash_rows``)."""
    from . import byte_rows

    return sponge_hash_rows(*byte_rows.pack(messages, device))


def sponge_hash_rows(data, offsets, lengths):
    """Sponge digests (int64 ``[k, 8]``) of rows of bytes (``byte_rows``):
    4-byte little-endian words mod p (a short last word zero-extended),
    1||0* padding, rate-8 blocks.  On a GPU one launch of
    ``p2_sponge_bytes``, which reads each row where it lies; the rows go
    in descending count of blocks (a warp's rows end together).  On the
    CPU ``sponge_hash_rows_plain``."""
    from . import byte_rows

    if not data.is_cuda:
        return sponge_hash_rows_plain(data, offsets, lengths)
    from .. import _kernels

    offsets, lengths = byte_rows.check(data, offsets, lengths)
    k = len(lengths)
    out = torch.empty((k, RATE), dtype=torch.int64, device=data.device)
    if k:
        blocks = -(-lengths // 4) // RATE + 1
        # int16 keys (rows beyond 2^15 blocks tie): numpy's stable sort is
        # then a radix sort.
        order = np.argsort(-np.minimum(blocks, (1 << 15) - 1).astype(
            np.int16), kind="stable")
        rows = byte_rows.upload(data.device, offsets[order], lengths[order],
                                order)
        _kernels.launch("p2_sponge_bytes", data.data_ptr(),
                        *(r.data_ptr() for r in rows), out.data_ptr(), k)
    return out


def sponge_hash_rows_plain(data, offsets, lengths):
    """``sponge_hash_rows`` in plain torch on any device: the words made on
    ``data``'s device, then block position j absorbed and permuted
    (``permute_plain``) in one batch over the rows that have more than j
    blocks, which the rows sorted by their count of blocks make a
    prefix."""
    from . import byte_rows

    offsets, lengths = byte_rows.check(data, offsets, lengths)
    k, dev = len(lengths), data.device
    if not k:
        return torch.empty((0, RATE), dtype=torch.int64, device=dev)
    n_words = -(-lengths // 4)
    n_blocks = n_words // RATE + 1              # the 1 always fits
    order = np.argsort(-n_blocks, kind="stable")
    width = int(n_blocks.max(initial=0)) * RATE
    blocks = byte_rows.words(byte_rows.gather(
        data, offsets[order], lengths[order], 4 * width)) % P
    blocks[torch.arange(k, device=dev),
           torch.from_numpy(n_words[order]).to(dev)] = 1
    blocks = blocks.reshape(k, -1, RATE)
    state = torch.zeros((k, WIDTH), dtype=torch.int64, device=dev)
    for j in range(blocks.shape[1]):
        live = int(np.count_nonzero(n_blocks > j))
        state[:live, :RATE] = add_plain(state[:live, :RATE],
                                        blocks[:live, j])
        state[:live] = permute_plain(state[:live])
    out = torch.empty((k, RATE), dtype=torch.int64, device=dev)
    out[torch.from_numpy(order).to(dev)] = state[:, :RATE]
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


def sponge_absorb(states, matrix, pad: bool) -> None:
    """Advance row-sponge states int64 [n, 16] IN PLACE over the words of
    each row of ``matrix`` [n, w]: its rate-8 blocks in order, then, with
    ``pad``, the 1||0* padding block (without ``pad``, w is a multiple of
    8).  The counterpart of the reference's ``_absorb_blocks`` scan and of
    ``RowSponge.finalize``'s padded last block.  On a GPU one launch of
    ``p2_sponge_absorb``; on the CPU ``sponge_absorb_plain``."""
    if states.dtype != torch.int64 or states.dim() != 2 \
            or states.shape[1] != WIDTH or not states.is_contiguous():
        raise ValueError(f"sponge states must be contiguous int64 [n, "
                         f"{WIDTH}]; got {states.dtype} "
                         f"{tuple(states.shape)}")
    if matrix.dim() != 2 or matrix.shape[0] != states.shape[0] \
            or matrix.device != states.device:
        raise ValueError(f"sponge input {tuple(matrix.shape)} on "
                         f"{matrix.device} for {states.shape[0]} states on "
                         f"{states.device}")
    if not states.is_cuda:
        states.copy_(sponge_absorb_plain(states, matrix, pad))
        return
    from .. import _kernels

    matrix = _check_words(matrix)
    n, w = matrix.shape
    if not pad and w % RATE:   # the kernel would refuse it too
        raise ValueError(f"unpadded sponge input of {w} words is not whole "
                         f"rate-{RATE} blocks")
    if n and (w or pad):
        _kernels.launch("p2_sponge_absorb", states.data_ptr(),
                        matrix.data_ptr(), n, w, int(pad))


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


def grind(state, bits: int, device) -> int:
    """The proof-of-work nonce for the sponge state ``state`` (16
    canonical words) and ``bits`` in 1..31 (see ``grind_plain``).  On a
    CUDA device one call of ``p2_grind`` searches, each thread forming its
    candidates in registers, and returns the nonce; on the CPU the plain
    version does."""
    words = [int(w) for w in state]
    if len(words) != WIDTH or not 1 <= bits <= 31 \
            or not all(0 <= w < P for w in words):
        raise ValueError(f"grind takes {WIDTH} canonical words and 1..31 "
                         "bits")
    if torch.device(device).type != "cuda":
        return grind_plain(words, bits, device)
    from .. import _kernels

    nonce = ctypes.c_longlong(-1)
    _kernels.launch("p2_grind", (ctypes.c_uint32 * WIDTH)(*words), bits, 0,
                    GRIND_LIMIT, ctypes.byref(nonce))
    if nonce.value < 0:
        raise RuntimeError("grinding search exhausted")  # pragma: no cover
    return nonce.value
