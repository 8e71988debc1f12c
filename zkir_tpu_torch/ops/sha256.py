"""Batched SHA-256 on torch tensors.

Counterpart of ``zkir_tpu/ops/sha256.py``: the crypto syscall's hot path,
thousands of independent messages hashed at once.  Words are int64
tensors of 32-bit values; ``sha256_many`` returns uint32 numpy digests, as
the reference does.  On a GPU every function launches ``sha256_blocks``
(``csrc/crypto.cu``) once: a thread a message runs all of its blocks from
the bytes where they lie, padding them itself.  On the CPU the plain
version below runs instead (int64 arithmetic masked to 32 bits, a block
position at a time over the rows that have it).  The constants and the
padding rule are the port's own ``runtime/crypto.py``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import byte_rows
from ..runtime.crypto import SHA256_H0, SHA256_K

M32 = 0xFFFFFFFF
BLOCK = 64


# ============================================================================
# The kernel's function: rows of bytes -> states
# ============================================================================


def sha256_rows(data, offsets, lengths, states=None, *, pad: bool = True):
    """The SHA-256 state words (int64 ``[k, 8]``) after the blocks of each
    row of bytes (``byte_rows``), from ``states`` (int64 ``[k, 8]`` on
    ``data``'s device) or the initial H0.  With ``pad`` each row is a whole
    message and its state is its digest (big-endian words); without, each
    row's length is a multiple of 64."""
    return _sha256(data, offsets, lengths, states, pad, False)[0]


def _sha256(data, offsets, lengths, states, pad: bool, witness: bool):
    """(states, witness or None): with ``witness``, each row is one whole
    block and its 64 round states come back too, int64 ``[k, 64, 8]``."""
    offsets, lengths = byte_rows.check(data, offsets, lengths)
    k = len(lengths)
    if not pad and np.any(lengths % BLOCK):
        raise ValueError("unpadded SHA-256 rows must be whole 64-byte blocks")
    if witness and (pad or np.any(lengths != BLOCK)):
        raise ValueError("round states come from rows of one block")
    if states is not None and (states.dtype != torch.int64
                               or tuple(states.shape) != (k, 8)
                               or states.device != data.device
                               or not states.is_contiguous()):
        raise ValueError(f"SHA-256 states must be contiguous int64 [{k}, 8] "
                         f"on {data.device}")
    if not data.is_cuda:
        return sha256_rows_plain(data, offsets, lengths, states, pad,
                                 witness)
    from .. import _kernels

    offs, lens = byte_rows.upload(data.device, offsets, lengths)
    out = torch.empty((k, 8), dtype=torch.int64, device=data.device)
    rounds = (torch.empty((k, 64, 8), dtype=torch.int64, device=data.device)
              if witness else None)
    _kernels.launch("sha256_blocks", data.data_ptr(), offs.data_ptr(),
                    lens.data_ptr(),
                    0 if states is None else states.data_ptr(),
                    out.data_ptr(), 0 if rounds is None else rounds.data_ptr(),
                    k, int(pad))
    return out, rounds


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _compress_plain(h, w, k_words, witness=None):
    """One compression of blocks ``w`` (int64 ``[m, 16]``) into states
    ``h`` (``[m, 8]``); returns the new states, and writes the state after
    each round into ``witness`` (``[m, 64, 8]``) where given."""
    w = list(w.unbind(1))
    a, b, c, d, e, f, g, hh = h.unbind(1)
    for r in range(64):
        if r >= 16:
            w1, w14 = w[(r + 1) % 16], w[(r + 14) % 16]
            s0 = _rotr(w1, 7) ^ _rotr(w1, 18) ^ (w1 >> 3)
            s1 = _rotr(w14, 17) ^ _rotr(w14, 19) ^ (w14 >> 10)
            w[r % 16] = (w[r % 16] + s0 + w[(r + 9) % 16] + s1) & M32
        t1 = (hh + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25))
              + ((e & f) ^ (~e & g & M32)) + k_words[r] + w[r % 16]) & M32
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22))
              + ((a & b) ^ (a & c) ^ (b & c))) & M32
        hh, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + t2) & M32
        if witness is not None:
            witness[:, r] = torch.stack([a, b, c, d, e, f, g, hh], 1)
    return (h + torch.stack([a, b, c, d, e, f, g, hh], 1)) & M32


def sha256_rows_plain(data, offsets, lengths, states=None, pad: bool = True,
                      witness: bool = False):
    """``_sha256`` in plain torch: (states, witness or None)."""
    k, dev = len(lengths), data.device
    rounds = (torch.zeros((k, 64, 8), dtype=torch.int64, device=dev)
              if witness else None)
    if not k:
        return torch.empty((0, 8), dtype=torch.int64, device=dev), rounds
    blocks = (lengths + 9 + BLOCK - 1) // BLOCK if pad else lengths // BLOCK
    width = int(blocks.max(initial=0)) * BLOCK
    raw = byte_rows.gather(data, offsets, lengths, width)
    if pad and k:
        rows = torch.arange(k, device=dev)
        raw[rows, torch.from_numpy(lengths).to(dev)] = 0x80
        bits = torch.from_numpy(lengths * 8).to(dev)
        end = torch.from_numpy(blocks * BLOCK).to(dev)
        for t in range(8):                  # the bit length, big-endian
            raw[rows, end - 1 - t] = (bits >> (8 * t)) & 0xFF
    words = byte_rows.words(raw, big_endian=True).reshape(k, -1, 16)
    h = (torch.tensor(SHA256_H0, dtype=torch.int64, device=dev).repeat(k, 1)
         if states is None else states.clone())
    k_words = torch.tensor(SHA256_K, dtype=torch.int64, device=dev)
    for j in range(width // BLOCK):
        live = torch.from_numpy(np.nonzero(blocks > j)[0]).to(dev)
        h[live] = _compress_plain(h[live], words[live, j], k_words,
                                  rounds if j == 0 else None)
    return h, rounds


# ============================================================================
# The reference's functions
# ============================================================================


def _block_bytes(blocks):
    """int64 ``[N, 16]`` big-endian words -> their 64 N bytes."""
    shifts = torch.tensor([24, 16, 8, 0], device=blocks.device)
    return ((blocks[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)


def _one_block(blocks, states, witness: bool):
    n = blocks.shape[0]
    if blocks.dtype != torch.int64 or tuple(blocks.shape) != (n, 16):
        raise ValueError(f"SHA-256 blocks must be int64 [N, 16]; got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    return _sha256(_block_bytes(blocks), np.arange(n) * BLOCK,
                   np.full(n, BLOCK), states.contiguous(), False, witness)


def sha256_compress_batch(blocks, states):
    """One compression: blocks int64 ``[N, 16]``, states ``[N, 8]`` ->
    ``[N, 8]``."""
    return _one_block(blocks, states, False)[0]


def sha256_compress_batch_with_witness(blocks, states):
    """The compression and its 64 round states ``[N, 64, 8]`` (the AIR
    crypto table's round-state columns)."""
    return _one_block(blocks, states, True)


def sha256_many(messages: List[bytes], device) -> np.ndarray:
    """Digests of a batch of byte strings on ``device``: uint32 ``[N, 8]``."""
    data, offsets, lengths = byte_rows.pack(messages, device)
    return sha256_rows(data, offsets, lengths).cpu().numpy().astype(
        np.uint32)


def digests_to_bytes(digests: np.ndarray) -> List[bytes]:
    return [b"".join(int(w).to_bytes(4, "big") for w in row)
            for row in digests]


class Sha256Stream:
    """Batched streaming SHA-256 (init/update/finalize) over ``n`` streams
    that advance together, their states on ``device``."""

    def __init__(self, n: int, device):
        self.n = n
        self.device = torch.device(device)
        self.states = torch.tensor(SHA256_H0, dtype=torch.int64,
                                   device=self.device).repeat(n, 1)
        self.buffers: List[bytearray] = [bytearray() for _ in range(n)]
        self.lengths = [0] * n

    def update(self, chunks: List[bytes]) -> None:
        assert len(chunks) == self.n
        for i, chunk in enumerate(chunks):
            self.buffers[i] += chunk
            self.lengths[i] += len(chunk)
        # Every stream compresses the blocks that all of them have whole,
        # in one call; the rest stays buffered.
        take = min(len(b) for b in self.buffers) // BLOCK * BLOCK
        if take:
            data, offsets, lengths = byte_rows.pack(
                [bytes(b[:take]) for b in self.buffers], self.device)
            self.states = sha256_rows(data, offsets, lengths, self.states,
                                      pad=False)
            for buf in self.buffers:
                del buf[:take]

    def finalize(self) -> List[bytes]:
        tails = []
        for buf, length in zip(self.buffers, self.lengths):
            tail = bytearray(buf)
            tail.append(0x80)
            while len(tail) % BLOCK != BLOCK - 8:
                tail.append(0)
            tail += (length * 8).to_bytes(8, "big")
            tails.append(bytes(tail))
        data, offsets, lengths = byte_rows.pack(tails, self.device)
        final = sha256_rows(data, offsets, lengths, self.states, pad=False)
        return digests_to_bytes(final.cpu().numpy())
