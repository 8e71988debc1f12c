"""Batched Keccak-256 on torch tensors.

Counterpart of ``zkir_tpu/ops/keccak.py``.  A state is int64 ``[N, 25]``
(64-bit lanes as bit patterns, lane (x, y) at index x + 5y).  On a GPU
every function launches ``keccak_absorb`` (``csrc/crypto.cu``) once: a
thread a message XORs each of its 136-byte blocks into the rate and
permutes, padding the message itself (the original Keccak padding 0x01 ...
0x80, not SHA-3's 0x06); ``keccak_f1600_batch`` is the absorption of one
zero block.  On the CPU the plain version below runs instead, vectorized
over the 25 lanes; its right shifts are masked to logical ones, since
int64 shifts arithmetically.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import byte_rows
from ..runtime.crypto import _KECCAK_RC, _KECCAK_ROT

RATE = 136
_LANES = RATE // 8
M63 = (1 << 63) - 1
_RC = np.asarray(_KECCAK_RC, dtype=np.uint64).view(np.int64)
# Rotation of lane x + 5y, and the lane rho-and-pi moves to each index.
_ROT = [_KECCAK_ROT[i % 5][i // 5] for i in range(25)]
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y


# ============================================================================
# The kernel's function: rows of bytes -> states
# ============================================================================


def keccak_rows(data, offsets, lengths, state=None, *, pad: bool = True):
    """The Keccak state (int64 ``[k, 25]``) after absorbing each row of
    bytes (``byte_rows``) from ``state`` (int64 ``[k, 25]`` on ``data``'s
    device) or zero.  With ``pad`` each row is a whole message; without,
    each row's length is a multiple of 136."""
    offsets, lengths = byte_rows.check(data, offsets, lengths)
    k = len(lengths)
    if not pad and np.any(lengths % RATE):
        raise ValueError("unpadded Keccak rows must be whole 136-byte blocks")
    if state is not None and (state.dtype != torch.int64
                              or tuple(state.shape) != (k, 25)
                              or state.device != data.device
                              or not state.is_contiguous()):
        raise ValueError(f"Keccak states must be contiguous int64 [{k}, 25] "
                         f"on {data.device}")
    if not data.is_cuda:
        return keccak_rows_plain(data, offsets, lengths, state, pad)
    from .. import _kernels

    offs, lens = byte_rows.upload(data.device, offsets, lengths)
    out = torch.empty((k, 25), dtype=torch.int64, device=data.device)
    _kernels.launch("keccak_absorb", data.data_ptr(), offs.data_ptr(),
                    lens.data_ptr(), 0 if state is None else state.data_ptr(),
                    out.data_ptr(), k, int(pad))
    return out


def _rotl(x, n):
    """x <<< n for int64 lanes and int64 amounts in [0, 63]: the right
    shift by 64 - n as a logical shift by 1, then by 63 - n."""
    return (x << n) | (((x >> 1) & M63) >> (63 - n))


def keccak_f_plain(s):
    """keccak-f[1600] of states int64 ``[m, 25]`` in plain torch."""
    dev, m = s.device, s.shape[0]
    rot = torch.tensor(_ROT, dtype=torch.int64, device=dev)
    pi = torch.tensor(_PI_SRC, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    for rc in _RC:
        g = s.reshape(m, 5, 5)                          # [m, y, x]
        c = g[:, 0] ^ g[:, 1] ^ g[:, 2] ^ g[:, 3] ^ g[:, 4]
        d = torch.roll(c, 1, 1) ^ _rotl(torch.roll(c, -1, 1), one)
        b = _rotl((g ^ d[:, None, :]).reshape(m, 25), rot)[:, pi]
        b = b.reshape(m, 5, 5)
        s = (b ^ (~torch.roll(b, -1, 2) & torch.roll(b, -2, 2))).reshape(m, 25)
        s[:, 0] ^= int(rc)
    return s


def keccak_rows_plain(data, offsets, lengths, state=None, pad: bool = True):
    """``keccak_rows`` in plain torch."""
    k, dev = len(lengths), data.device
    if not k:
        return torch.empty((0, 25), dtype=torch.int64, device=dev)
    blocks = lengths // RATE + 1 if pad else lengths // RATE
    width = int(blocks.max(initial=0)) * RATE
    raw = byte_rows.gather(data, offsets, lengths, width)
    if pad and k:
        rows = torch.arange(k, device=dev)
        raw[rows, torch.from_numpy(lengths).to(dev)] = 0x01
        end = torch.from_numpy(blocks * RATE - 1).to(dev)
        raw[rows, end] = raw[rows, end] | 0x80
    lanes = byte_rows.words(raw, 8).reshape(k, -1, _LANES)
    s = (torch.zeros((k, 25), dtype=torch.int64, device=dev)
         if state is None else state.clone())
    for j in range(width // RATE):
        live = torch.from_numpy(np.nonzero(blocks > j)[0]).to(dev)
        sub = s[live]
        sub[:, :_LANES] ^= lanes[live, j]
        s[live] = keccak_f_plain(sub)
    return s


# ============================================================================
# The reference's functions
# ============================================================================


def keccak_f1600_batch(state):
    """keccak-f[1600] of states int64 ``[N, 25]`` (lane (x, y) at x + 5y)."""
    n = state.shape[0]
    zero = torch.zeros(RATE, dtype=torch.uint8, device=state.device)
    return keccak_rows(zero, np.zeros(n), np.full(n, RATE),
                       state.contiguous(), pad=False)


def keccak256_words(data, offsets, lengths):
    """Keccak-256 digests of rows of bytes as int64 ``[k, 8]`` 32-bit
    words, little-endian: the 32 bytes are their little-endian bytes."""
    lanes = keccak_rows(data, offsets, lengths)[:, :4]
    return torch.stack([lanes & 0xFFFFFFFF, (lanes >> 32) & 0xFFFFFFFF],
                       2).reshape(-1, 8)


def keccak256_many(messages: List[bytes], device) -> List[bytes]:
    """Keccak-256 of a batch of byte strings, hashed on ``device``."""
    words = keccak256_words(*byte_rows.pack(messages, device)).cpu().numpy()
    return [row.astype("<u4").tobytes() for row in words]
