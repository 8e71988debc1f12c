"""Deferred range checking with chunk decomposition.

Parity target: reference ``zkir-runtime/src/range_check.rs`` — lookup table
of 2^chunk_bits valid chunks, defer/should_checkpoint/checkpoint flow with
the same thresholds (>= 16 pending, or any bound >= data_bits + 4;
range_check.rs:122-135), and the limb -> lo/hi chunk decomposition
(range_check.rs:175-192).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..spec.bounds import ValueBound
from ..spec.config import Config
from .errors import RuntimeError_


class RangeLookupTable:
    def __init__(self, config: Config):
        self.chunk_bits = config.limb_bits // 2
        self.size = 1 << self.chunk_bits

    def is_valid_chunk(self, chunk: int) -> bool:
        return 0 <= chunk < self.size

    @property
    def chunks_per_limb(self) -> int:
        return 2


@dataclass(frozen=True)
class PendingCheck:
    value: int  # packed limb value (masked per-limb)
    bound: ValueBound
    pc: int


class RangeCheckWitness:
    """Chunk decompositions verified at a checkpoint
    (reference range_check.rs:209-238)."""

    def __init__(self):
        self.checks: List[Tuple[int, List[int], int]] = []  # (value, chunks, pc)

    def add_check(self, value: int, chunks: List[int], pc: int) -> None:
        self.checks.append((value, chunks, pc))

    def __len__(self) -> int:
        return len(self.checks)

    @property
    def is_empty(self) -> bool:
        return not self.checks


class RangeCheckTracker:
    def __init__(self, config: Config):
        self.config = config
        self.table = RangeLookupTable(config)
        self.pending: List[PendingCheck] = []
        self.checkpoint_count = 0
        self._limb_mask = config.limb_mask
        self._limb_bits = config.limb_bits
        self._data_limbs = config.data_limbs

    def needs_check(self, bound: ValueBound) -> bool:
        return bound.max_bits > self.config.data_bits

    def defer(self, value: int, bound: ValueBound, pc: int) -> None:
        if self.needs_check(bound):
            self.pending.append(PendingCheck(value, bound, pc))

    def should_checkpoint(self) -> bool:
        if not self.pending:
            return False
        if len(self.pending) >= 16:
            return True
        threshold = self.config.data_bits + 4
        return any(p.bound.max_bits >= threshold for p in self.pending)

    def checkpoint(self) -> RangeCheckWitness:
        witness = RangeCheckWitness()
        pending, self.pending = self.pending, []
        for check in pending:
            chunks = self.decompose_value(check.value)
            for chunk in chunks:
                if not self.table.is_valid_chunk(chunk):
                    raise RuntimeError_(
                        f"Range check failed at PC {check.pc:#x}: chunk {chunk} "
                        f"out of range (max {(1 << self.table.chunk_bits) - 1})"
                    )
            witness.add_check(check.value, chunks, check.pc)
        self.checkpoint_count += 1
        return witness

    def decompose_value(self, value: int) -> List[int]:
        """Per-limb lo/hi chunk split (reference range_check.rs:175-192).

        The value is interpreted as packed ``data_limbs`` x ``limb_bits``
        limbs (Value40-style), each split into two chunk_bits halves.
        """
        chunk_bits = self.table.chunk_bits
        chunk_mask = (1 << chunk_bits) - 1
        chunks = []
        for i in range(self._data_limbs):
            limb = (value >> (i * self._limb_bits)) & self._limb_mask
            chunks.append(limb & chunk_mask)
            chunks.append((limb >> chunk_bits) & chunk_mask)
        return chunks

    @property
    def pending_count(self) -> int:
        return len(self.pending)
