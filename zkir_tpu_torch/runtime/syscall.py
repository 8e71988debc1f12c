"""Syscall dispatch and I/O tapes.

Parity target: reference ``zkir-runtime/src/syscall.rs`` — syscall numbers
0-6 (syscall.rs:18-24), register convention R10=number, R11/R12/R13=args,
result in R10 (syscall.rs:80-97); SHA-256 additionally writes its output
bound to R14 (syscall.rs:131-136).
"""

from __future__ import annotations

from typing import List

from . import crypto
from .errors import InvalidSyscall
from .memory import Memory
from .state import HaltReason, VMState

SYSCALL_EXIT = 0
SYSCALL_READ = 1
SYSCALL_WRITE = 2
SYSCALL_SHA256 = 3
SYSCALL_POSEIDON2 = 4
SYSCALL_KECCAK256 = 5
SYSCALL_BLAKE3 = 6


class IOHandler:
    """Sequential input/output tapes (reference syscall.rs:26-78)."""

    def __init__(self, inputs: List[int]):
        self.inputs = list(inputs)
        self.input_pos = 0
        self.outputs: List[int] = []

    def read(self) -> int:
        if self.input_pos < len(self.inputs):
            value = self.inputs[self.input_pos]
            self.input_pos += 1
            return value
        return 0  # exhausted tape reads as 0 (syscall.rs:54-62)

    def write(self, value: int) -> None:
        self.outputs.append(value)

    @property
    def inputs_exhausted(self) -> bool:
        return self.input_pos >= len(self.inputs)


def handle_syscall(state: VMState, memory: Memory, io: IOHandler,
                   witness_sink=None, cycle: int = 0) -> None:
    """Dispatch one ECALL (reference syscall.rs:94-177).

    With ``witness_sink`` (a list), crypto syscalls append a
    ``crypto.CryptoWitness`` stamped with ``cycle`` — the tagged-union
    collection the reference shapes in trace.rs:330-359.  SHA-256 round
    witnesses follow the reference's single-block limit
    (crypto.rs:237-243): messages >= 56 bytes record no round states."""
    num = state.read_reg(10)

    if num == SYSCALL_EXIT:
        state.halt(HaltReason.EXIT, state.read_reg(11))
    elif num == SYSCALL_READ:
        state.write_reg(10, io.read())
    elif num == SYSCALL_WRITE:
        io.write(state.read_reg(11))
    elif num == SYSCALL_SHA256:
        w = None
        if witness_sink is not None and state.read_reg(12) < 56:
            w = crypto.Sha256Witness(cycle)
        bound = crypto.sha256_hash(
            memory, state.read_reg(11), state.read_reg(12),
            state.read_reg(13), witness=w,
        )
        if w is not None:
            witness_sink.append(crypto.CryptoWitness(w))
        state.write_reg(10, 0)
        state.write_bound(14, bound)
    elif num == SYSCALL_POSEIDON2:
        w = crypto.Poseidon2Witness(cycle) if witness_sink is not None \
            else None
        crypto.poseidon2_hash(
            memory, state.read_reg(11), state.read_reg(12),
            state.read_reg(13), witness=w,
        )
        if w is not None:
            witness_sink.append(crypto.CryptoWitness(w))
        state.write_reg(10, 0)
    elif num == SYSCALL_KECCAK256:
        w = crypto.Keccak256Witness(cycle) if witness_sink is not None \
            else None
        crypto.keccak256_hash(
            memory, state.read_reg(11), state.read_reg(12),
            state.read_reg(13), witness=w,
        )
        if w is not None:
            witness_sink.append(crypto.CryptoWitness(w))
        state.write_reg(10, 0)
    elif num == SYSCALL_BLAKE3:
        crypto.blake3_hash(
            memory, state.read_reg(11), state.read_reg(12), state.read_reg(13)
        )
        state.write_reg(10, 0)
    else:
        raise InvalidSyscall(num)
