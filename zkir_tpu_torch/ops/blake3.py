"""Batched BLAKE3 on torch tensors.

Counterpart of ``zkir_tpu/ops/blake3.py``.  Words are int64 tensors of
32-bit values.  On a GPU ``blake3_rows`` (the interpreter's syscalls, and
``blake3_many``) is one launch of ``b3_rows`` (``csrc/crypto.cu``): a lane
hashes a 1,024-byte chunk, and the lanes of one message, inside one warp,
merge its tree there.  The host only orders the messages by the size of
their group of lanes and gives each its first lane.  The reference merges
each message's tree in a host loop of one-row compressions; the words are
the same.  ``b3_compress_batch`` is one launch of ``b3_compress``.  On the
CPU the plain versions below run instead.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import byte_rows
from ..runtime.crypto import (
    _B3_BLOCK_LEN,
    _B3_CHUNK_END,
    _B3_CHUNK_LEN,
    _B3_CHUNK_START,
    _B3_IV,
    _B3_MSG_PERM,
    _B3_PARENT,
    _B3_ROOT,
)

M32 = 0xFFFFFFFF


# ============================================================================
# The compression function
# ============================================================================


def _check_words(name, t, shape):
    if t.dtype != torch.int64 or tuple(t.shape) != shape:
        raise ValueError(f"BLAKE3 {name} must be int64 {list(shape)}; got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def b3_compress_batch(cv, block_words, counter_lo, counter_hi, block_len,
                      flags):
    """Batched compression: ``cv`` int64 ``[N, 8]`` (or None: the IV),
    ``block_words`` ``[N, 16]``, the rest ``[N]``, all on one device.
    Returns the output chaining values ``[N, 8]``."""
    n = block_words.shape[0]
    args = [None if cv is None else _check_words("cv", cv, (n, 8)),
            _check_words("block words", block_words, (n, 16))] + [
        _check_words(name, t, (n,)) for name, t in (
            ("counter_lo", counter_lo), ("counter_hi", counter_hi),
            ("block_len", block_len), ("flags", flags))]
    dev = block_words.device
    if any(t is not None and t.device != dev for t in args):
        raise ValueError("BLAKE3 compression operands on different devices")
    if not block_words.is_cuda:
        return b3_compress_plain(*args)
    from .. import _kernels

    out = torch.empty((n, 8), dtype=torch.int64, device=dev)
    _kernels.launch("b3_compress", 0 if cv is None else args[0].data_ptr(),
                    *(t.data_ptr() for t in args[1:]), out.data_ptr(), n)
    return out


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _g(a, b, c, d, mx, my):
    """The G function on four columns (or diagonals) at once: ``[n, 4]``."""
    a = (a + b + mx) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def b3_compress_plain(cv, words, counter_lo, counter_hi, block_len, flags):
    """``b3_compress_batch`` in plain torch."""
    n, dev = words.shape[0], words.device
    iv = torch.tensor(_B3_IV, dtype=torch.int64, device=dev)
    if cv is None:
        cv = iv.repeat(n, 1)
    a, b = cv[:, :4], cv[:, 4:]
    c = iv[:4].repeat(n, 1)
    d = torch.stack([counter_lo, counter_hi, block_len, flags], 1)
    perm = torch.tensor(_B3_MSG_PERM, device=dev)
    m = words
    for r in range(7):
        a, b, c, d = _g(a, b, c, d, m[:, 0:8:2], m[:, 1:8:2])
        # The diagonals: rotate rows b, c, d left by 1, 2, 3 and back.
        b, c, d = (torch.roll(b, -1, 1), torch.roll(c, -2, 1),
                   torch.roll(d, -3, 1))
        a, b, c, d = _g(a, b, c, d, m[:, 8:16:2], m[:, 9:16:2])
        b, c, d = (torch.roll(b, 1, 1), torch.roll(c, 2, 1),
                   torch.roll(d, 3, 1))
        if r < 6:
            m = m[:, perm]
    return torch.cat([a ^ c, b ^ d], 1)


# ============================================================================
# Whole messages
# ============================================================================

# A message's group of lanes by its count of chunks (capped at 32; an empty
# message is one chunk): the next power of two, so groups ordered largest
# first lie aligned in warps.
_GROUP = np.array([1] + [1 << (c - 1).bit_length() for c in range(1, 33)],
                  dtype=np.int64)


def blake3_rows(data, offsets, lengths):
    """BLAKE3-256 digests of rows of bytes (``byte_rows``) as int64
    ``[k, 8]`` 32-bit words, little-endian: the 32 bytes are their
    little-endian bytes.  On a GPU one launch of ``b3_rows``; on the CPU
    ``blake3_rows_plain``."""
    if not data.is_cuda:
        return blake3_rows_plain(data, offsets, lengths)
    from .. import _kernels

    offsets, lengths = byte_rows.check(data, offsets, lengths)
    k, dev = len(lengths), data.device
    out = torch.empty((k, 8), dtype=torch.int64, device=dev)
    if not k:
        return out
    group = _GROUP[np.minimum(-(-lengths // _B3_CHUNK_LEN), 32)]
    # Largest groups first, and one-chunk messages by their blocks, most
    # first, so that the messages of a warp end together (a lane of a
    # longer message runs whole chunks of 16 blocks).  int16 keys: numpy's
    # stable sort is then a radix sort.
    blocks = np.clip(-(-lengths // _B3_BLOCK_LEN), 1, 16)
    order = np.argsort(-(17 * group + blocks).astype(np.int16),
                       kind="stable")
    lanes = np.zeros(k, dtype=np.int64)
    np.cumsum(group[order][:-1], out=lanes[1:])
    rows = byte_rows.upload(dev, offsets[order], lengths[order], lanes,
                            order)
    _kernels.launch("b3_rows", data.data_ptr(),
                    *(r.data_ptr() for r in rows), out.data_ptr(), k,
                    int(lanes[-1] + group[order[-1]]))
    return out


def _chunks_plain(data, offsets, lengths, counters, last_flags):
    """Each chunk's chaining value (int64 ``[t, 8]``) in plain torch: chunk
    i is the bytes ``data[offsets[i] : offsets[i] + lengths[i]]`` (at most
    1,024), its blocks chained from the IV with ``counters[i]``,
    CHUNK_START on the first block and CHUNK_END | ``last_flags[i]`` on
    the last; a block position at a time over the chunks that have it."""
    t, dev = len(lengths), data.device
    if not t:
        return torch.empty((0, 8), dtype=torch.int64, device=dev)
    blocks = np.maximum(1, -(-lengths // _B3_BLOCK_LEN))
    raw = byte_rows.gather(data, offsets, lengths,
                           int(blocks.max(initial=0)) * _B3_BLOCK_LEN)
    words = byte_rows.words(raw).reshape(t, -1, 16)
    cv = torch.tensor(_B3_IV, dtype=torch.int64, device=dev).repeat(t, 1)
    for j in range(int(blocks.max(initial=0))):
        at = np.nonzero(blocks > j)[0]
        rest = lengths[at] - j * _B3_BLOCK_LEN
        flags = np.where(blocks[at] == j + 1,
                         _B3_CHUNK_END | last_flags[at], 0)
        if j == 0:
            flags |= _B3_CHUNK_START
        ctr, blen, flags = byte_rows.upload(
            dev, counters[at], np.clip(rest, 0, _B3_BLOCK_LEN), flags)
        live = torch.from_numpy(at).to(dev)
        cv[live] = b3_compress_plain(cv[live], words[live, j],
                                     ctr & M32, ctr >> 32, blen, flags)
    return cv


def blake3_rows_plain(data, offsets, lengths):
    """``blake3_rows`` in plain torch on any device: every chunk's chaining
    value (ROOT where the chunk is the whole message), then the trees a
    level at a time."""
    offsets, lengths = byte_rows.check(data, offsets, lengths)
    k, dev = len(lengths), data.device
    chunks = np.maximum(1, -(-lengths // _B3_CHUNK_LEN))
    start = np.concatenate([[0], np.cumsum(chunks)[:-1]]).astype(np.int64)
    owner = np.repeat(np.arange(k), chunks)
    index = np.arange(int(chunks.sum())) - start[owner]
    cvs = _chunks_plain(
        data, offsets[owner] + index * _B3_CHUNK_LEN,
        np.clip(lengths[owner] - index * _B3_CHUNK_LEN, 0, _B3_CHUNK_LEN),
        index, np.where(chunks[owner] == 1, _B3_ROOT, 0))
    out = torch.empty((k, 8), dtype=torch.int64, device=dev)
    whole = np.nonzero(chunks == 1)[0]
    out[torch.from_numpy(whole).to(dev)] = cvs[
        torch.from_numpy(start[whole]).to(dev)]
    # The trees: at each level a message's nodes pair up left to right into
    # parents (ROOT where the parent is the last node left), an odd last
    # node moving up as it is.  Every message's parents are one batch.
    msgs = np.nonzero(chunks > 1)[0]
    count, start = chunks[msgs], start[msgs]
    while msgs.size:
        pairs, odd = count // 2, count % 2
        up = pairs + odd
        new_start = np.concatenate([[0], np.cumsum(up)[:-1]]).astype(
            np.int64)
        group = np.repeat(np.arange(msgs.size), pairs)
        j = np.arange(int(pairs.sum())) - np.repeat(
            np.concatenate([[0], np.cumsum(pairs)[:-1]]), pairs)
        left = torch.from_numpy(start[group] + 2 * j).to(dev)
        flags = np.where(up[group] == 1, _B3_PARENT | _B3_ROOT, _B3_PARENT)
        zero, blen, flags = byte_rows.upload(
            dev, np.zeros_like(flags), np.full_like(flags, _B3_BLOCK_LEN),
            flags)
        parents = b3_compress_plain(
            None, torch.cat([cvs[left], cvs[left + 1]], 1), zero, zero,
            blen, flags)
        nodes = torch.empty((int(up.sum()), 8), dtype=torch.int64,
                            device=dev)
        nodes[torch.from_numpy(new_start[group] + j).to(dev)] = parents
        carry = np.nonzero(odd)[0]
        nodes[torch.from_numpy(new_start[carry] + pairs[carry]).to(dev)] = \
            cvs[torch.from_numpy(start[carry] + count[carry] - 1).to(dev)]
        done = up == 1
        out[torch.from_numpy(msgs[done]).to(dev)] = nodes[
            torch.from_numpy(new_start[done]).to(dev)]
        keep = ~done
        msgs, count, start = msgs[keep], up[keep], new_start[keep]
        cvs = nodes
    return out


def blake3_many(messages: List[bytes], device) -> List[bytes]:
    """BLAKE3-256 of a batch of byte strings, hashed on ``device``."""
    words = blake3_rows(*byte_rows.pack(messages, device)).cpu().numpy()
    return [row.astype("<u4").tobytes() for row in words]
