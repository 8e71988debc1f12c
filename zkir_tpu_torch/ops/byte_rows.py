"""Byte strings as rows of one flat device buffer: the layout the hash
kernels (``csrc/crypto.cu``) read.

A batch of ``k`` messages is a 1-D uint8 tensor ``data`` and two host
int64 arrays: message ``i`` is ``data[offsets[i] : offsets[i] +
lengths[i]]``.  The rows may lie anywhere in ``data`` and overlap: the
interpreter passes its lanes' memory images as ``data`` and each paused
lane's input span as a row, so nothing is copied before a hash.  Offsets
and lengths stay on the host, where the callers build them and where
``check`` holds every row inside ``data``; they go to the device in one
copy (``upload``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def pack(messages: List[bytes], device) -> Tuple[torch.Tensor, np.ndarray,
                                                 np.ndarray]:
    """(data, offsets, lengths) of ``messages`` laid end to end."""
    lengths = np.array([len(m) for m in messages], dtype=np.int64)
    offsets = np.zeros(len(messages), dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    blob = np.frombuffer(b"".join(messages), dtype=np.uint8)
    return torch.from_numpy(blob.copy()).to(device), offsets, lengths


def check(data: torch.Tensor, offsets, lengths) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """``offsets`` and ``lengths`` as int64 host arrays, once ``data`` is a
    contiguous 1-D uint8 tensor and every non-empty row lies inside it
    (an empty row may point anywhere: nothing of it is read)."""
    if data.dtype != torch.uint8 or data.dim() != 1 \
            or not data.is_contiguous():
        raise ValueError(f"message bytes must be a contiguous 1-D uint8 "
                         f"tensor; got {data.dtype} {tuple(data.shape)}")
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if offsets.ndim != 1 or offsets.shape != lengths.shape:
        raise ValueError(f"offsets {offsets.shape} and lengths "
                         f"{lengths.shape} must be two vectors of one length")
    if np.any((lengths < 0) | ((lengths > 0) & (
            (offsets < 0) | (offsets > data.numel() - lengths)))):
        raise ValueError(f"a message lies outside its {data.numel()} bytes")
    return offsets, lengths


def upload(device, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """Host int64 vectors of one length as device tensors, in one copy."""
    stacked = torch.from_numpy(np.stack(arrays)).to(device)
    return tuple(stacked)


def gather(data: torch.Tensor, offsets: np.ndarray, lengths: np.ndarray,
           width: int) -> torch.Tensor:
    """int64 ``[k, width]``: row i holds message i's bytes, then zeros.
    The plain versions' way in: one index per row into a windowed view of
    ``data``, so no ``[k, width]`` index tensor is made."""
    k, dev = len(lengths), data.device
    out = torch.zeros((k, width), dtype=torch.int64, device=dev)
    if not k or not width:
        return out
    n = data.numel()
    if n < width:
        data = torch.cat([data, data.new_zeros(width - n)])
        n = width
    start = np.minimum(np.where(lengths > 0, offsets, 0), n - width)
    shift = np.where(lengths > 0, offsets, 0) - start
    windows = torch.as_strided(data, (n - width + 1, width), (1, 1))
    rows = windows[torch.from_numpy(start).to(dev)].to(torch.int64)
    # A row that starts within ``width`` of the end: move its bytes left.
    late = np.nonzero(shift)[0]
    if late.size:
        cols = torch.arange(width, device=dev)
        at = torch.from_numpy(late).to(dev)
        idx = (torch.from_numpy(shift[late]).to(dev)[:, None] + cols).clamp(
            max=width - 1)
        rows[at] = rows[at].gather(1, idx)
    inside = torch.arange(width, device=dev)[None, :] < torch.from_numpy(
        lengths).to(dev)[:, None]
    return torch.where(inside, rows, out)


def words(raw: torch.Tensor, size: int = 4,
          big_endian: bool = False) -> torch.Tensor:
    """int64 ``[..., n]`` bytes (as ``gather`` gives them) -> ``[...,
    n / size]`` words of ``size`` bytes (a word of 8 as its bit pattern)."""
    b = raw.reshape(*raw.shape[:-1], -1, size)
    order = range(size - 1, -1, -1) if big_endian else range(size)
    out = b[..., order[0]]
    for t, k in enumerate(order[1:], 1):
        out = out | (b[..., k] << (8 * t))
    return out
