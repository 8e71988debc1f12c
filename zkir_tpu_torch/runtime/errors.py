"""Runtime error types (parity: reference zkir-runtime/src/error.rs)."""

from __future__ import annotations


class RuntimeError_(Exception):
    """Base runtime error."""


class DivisionByZero(RuntimeError_):
    def __init__(self, pc: int):
        super().__init__(f"division by zero at pc {pc:#x}")
        self.pc = pc


class MisalignedAccess(RuntimeError_):
    def __init__(self, address: int, alignment: int):
        super().__init__(f"misaligned access at {address:#x} (alignment {alignment})")
        self.address = address
        self.alignment = alignment


class InvalidMemoryAccess(RuntimeError_):
    def __init__(self, address: int, reason: str):
        super().__init__(f"invalid memory access at {address:#x}: {reason}")
        self.address = address
        self.reason = reason


class InvalidSyscall(RuntimeError_):
    def __init__(self, syscall: int):
        super().__init__(f"invalid syscall: {syscall}")
        self.syscall = syscall
