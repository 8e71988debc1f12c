"""Sparse paged memory with access-op tracing.

Parity target: reference ``zkir-runtime/src/memory.rs`` — 4KB page map,
region model with write protection (memory.rs:49-184), byte-granular
little-endian multi-byte access with alignment checks and sub-op trace
suppression (memory.rs:297-487), code/data loaders (memory.rs:259-294).

Host copy of ``zkir_tpu/runtime/memory.py``.  The batched interpreter
replaces this with flat segment arrays; this class is the oracle it is held to.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List

from ..spec.bounds import ValueBound
from ..spec.memlayout import (
    CODE_BASE,
    DATA_BASE,
    DEFAULT_STACK_SIZE,
    HEAP_BASE,
    RESERVED_SIZE,
    STACK_TOP,
)
from .errors import InvalidMemoryAccess, MisalignedAccess

PAGE_SIZE = 4096

_U64 = (1 << 64) - 1


class MemOpType(enum.IntEnum):
    READ = 0
    WRITE = 1


@dataclass(frozen=True)
class MemoryOp:
    """One traced memory access (reference zkir-spec/src/trace.rs:149-229)."""

    address: int
    value: int
    timestamp: int
    op_type: MemOpType
    bound: ValueBound
    width: int  # bytes: 1, 2, 4, 8

    @property
    def is_read(self) -> bool:
        return self.op_type == MemOpType.READ

    @property
    def is_write(self) -> bool:
        return self.op_type == MemOpType.WRITE

    def sort_key(self):
        """Ordering: (timestamp, address, reads-before-writes)
        (reference trace.rs:210-223)."""
        return (self.timestamp, self.address, int(self.op_type))


class MemoryRegion(enum.Enum):
    RESERVED = "reserved"
    CODE = "code"
    DATA = "data"
    HEAP = "heap"
    STACK = "stack"

    @staticmethod
    def from_address(addr: int, heap_break: int, stack_top: int) -> "MemoryRegion":
        # reference memory.rs:49-64
        if addr < RESERVED_SIZE:
            return MemoryRegion.RESERVED
        if CODE_BASE <= addr < DATA_BASE:
            return MemoryRegion.CODE
        if DATA_BASE <= addr < HEAP_BASE:
            return MemoryRegion.DATA
        if HEAP_BASE <= addr < heap_break:
            return MemoryRegion.HEAP
        if addr > stack_top - DEFAULT_STACK_SIZE:
            return MemoryRegion.STACK
        return MemoryRegion.HEAP  # unmapped treated as heap

    @property
    def is_writable(self) -> bool:
        return self not in (MemoryRegion.RESERVED, MemoryRegion.CODE)


class Memory:
    def __init__(self, trace_enabled: bool = False):
        self.pages: Dict[int, bytearray] = {}
        self.stack_top = STACK_TOP
        self._heap_break = HEAP_BASE
        self.trace: List[MemoryOp] = []
        self.trace_enabled = trace_enabled
        self.timestamp = 0
        self.strict_protection = True
        self.code_loaded = False

    # ---- region / protection (memory.rs:141-194) ----

    def get_region(self, addr: int) -> MemoryRegion:
        return MemoryRegion.from_address(addr, self._heap_break, self.stack_top)

    def _validate_write(self, addr: int, size: int) -> None:
        if not self.strict_protection:
            return
        region = self.get_region(addr)
        if region == MemoryRegion.RESERVED:
            raise InvalidMemoryAccess(addr, "write to reserved memory region")
        if self.code_loaded and region == MemoryRegion.CODE:
            raise InvalidMemoryAccess(addr, "write to read-only code section")
        end_addr = min(addr + size - 1, _U64)
        end_region = self.get_region(end_addr)
        if region != end_region and MemoryRegion.CODE in (region, end_region):
            raise InvalidMemoryAccess(addr, "write spans code section boundary")

    def set_strict_protection(self, enabled: bool) -> None:
        self.strict_protection = enabled

    # ---- trace (memory.rs:197-253) ----

    def set_trace_enabled(self, enabled: bool) -> None:
        self.trace_enabled = enabled
        if not enabled:
            self.trace.clear()

    def set_timestamp(self, timestamp: int) -> None:
        self.timestamp = timestamp

    def get_trace(self) -> List[MemoryOp]:
        return self.trace

    def get_sorted_trace(self) -> List[MemoryOp]:
        return sorted(self.trace, key=MemoryOp.sort_key)

    def clear_trace(self) -> None:
        self.trace.clear()
        self.timestamp = 0

    def _record_op(self, address: int, value: int, is_write: bool, width: int) -> None:
        if self.trace_enabled:
            bound = ValueBound.from_type_width(width * 8)
            self.trace.append(MemoryOp(
                address=address, value=value, timestamp=self.timestamp,
                op_type=MemOpType.WRITE if is_write else MemOpType.READ,
                bound=bound, width=width,
            ))

    # ---- loaders (memory.rs:259-294) ----

    def load_code(self, code: List[int], base: int) -> None:
        was = self.strict_protection
        self.strict_protection = False
        for i, word in enumerate(code):
            self.write_u32(base + i * 4, word & 0xFFFFFFFF)
        self.strict_protection = was
        self.code_loaded = True

    def load_data(self, data: bytes, base: int) -> None:
        was = self.strict_protection
        self.strict_protection = False
        for i, byte in enumerate(data):
            self.write_u8(base + i, byte)
        self.strict_protection = was

    # ---- raw byte access (no trace, no protection): internal helpers ----

    def _peek(self, addr: int) -> int:
        page = self.pages.get(addr // PAGE_SIZE)
        return page[addr % PAGE_SIZE] if page is not None else 0

    def _poke(self, addr: int, value: int) -> None:
        page_num = addr // PAGE_SIZE
        page = self.pages.get(page_num)
        if page is None:
            page = bytearray(PAGE_SIZE)
            self.pages[page_num] = page
        page[addr % PAGE_SIZE] = value & 0xFF

    # ---- typed access (memory.rs:297-487) ----

    def read_u8(self, addr: int) -> int:
        value = self._peek(addr)
        self._record_op(addr, value, False, 1)
        return value

    def write_u8(self, addr: int, value: int) -> None:
        self._validate_write(addr, 1)
        self._poke(addr, value)
        self._record_op(addr, value & 0xFF, True, 1)

    def read_u16(self, addr: int) -> int:
        if addr % 2 != 0:
            raise MisalignedAccess(addr, 2)
        value = self._peek(addr) | (self._peek(addr + 1) << 8)
        self._record_op(addr, value, False, 2)
        return value

    def write_u16(self, addr: int, value: int) -> None:
        if addr % 2 != 0:
            raise MisalignedAccess(addr, 2)
        self._validate_write(addr, 2)
        self._poke(addr, value)
        self._poke(addr + 1, value >> 8)
        self._record_op(addr, value & 0xFFFF, True, 2)

    def read_u32(self, addr: int) -> int:
        if addr % 4 != 0:
            raise MisalignedAccess(addr, 4)
        value = (
            self._peek(addr)
            | (self._peek(addr + 1) << 8)
            | (self._peek(addr + 2) << 16)
            | (self._peek(addr + 3) << 24)
        )
        self._record_op(addr, value, False, 4)
        return value

    def write_u32(self, addr: int, value: int) -> None:
        if addr % 4 != 0:
            raise MisalignedAccess(addr, 4)
        self._validate_write(addr, 4)
        for i in range(4):
            self._poke(addr + i, (value >> (8 * i)) & 0xFF)
        self._record_op(addr, value & 0xFFFFFFFF, True, 4)

    def read_u64(self, addr: int) -> int:
        if addr % 8 != 0:
            raise MisalignedAccess(addr, 8)
        value = 0
        for i in range(8):
            value |= self._peek(addr + i) << (8 * i)
        self._record_op(addr, value, False, 8)
        return value

    def write_u64(self, addr: int, value: int) -> None:
        if addr % 8 != 0:
            raise MisalignedAccess(addr, 8)
        self._validate_write(addr, 8)
        for i in range(8):
            self._poke(addr + i, (value >> (8 * i)) & 0xFF)
        self._record_op(addr, value & _U64, True, 8)

    # ---- heap (memory.rs:491-504) ----

    @property
    def heap_break(self) -> int:
        return self._heap_break

    def set_heap_break(self, addr: int) -> None:
        self._heap_break = addr
