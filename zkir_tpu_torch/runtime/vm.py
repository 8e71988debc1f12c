"""The VM loop: fetch -> decode -> execute -> witness collection.

Parity target: reference ``zkir-runtime/src/vm.rs`` — the exact per-cycle
order of operations (vm.rs:208-348): cycle-limit check, memory timestamp
sync, fetch+decode, PRE-state capture, execute (plain or deferred), syscall
dispatch, trace-row assembly (filtering out the instruction fetch), range-
check checkpoint on stores/branches/jumps/division, cycle increment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..spec.bounds import ValueBound
from ..spec.isa import Instruction
from ..spec.memlayout import CODE_BASE
from ..spec.opcodes import Op, is_branch, is_jump, is_store
from ..spec.program import Program
from .deferred import DeferredConfig
from .errors import RuntimeError_
from .execute import execute, execute_with_deferred
from .memory import Memory, MemoryOp
from .range_check import RangeCheckTracker, RangeCheckWitness
from .state import Halt, HaltReason, RegState, VMState
from .syscall import IOHandler, handle_syscall
from .witness import NormalizationEvent


@dataclass
class VMConfig:
    """Feature toggles (reference vm.rs:15-50; all-off defaults)."""

    max_cycles: int = 1_000_000
    trace: bool = False  # debug print of each instruction
    enable_range_checking: bool = False
    enable_execution_trace: bool = False
    enable_deferred_model: bool = False


@dataclass
class TraceRow:
    """One execution-trace row with PRE-instruction state
    (reference zkir-spec/src/trace.rs:24-50, captured at vm.rs:245-312)."""

    cycle: int
    pc: int
    instruction: int
    registers: List[int]  # 16 values BEFORE execution
    bounds: List[ValueBound]
    register_states: List[RegState]
    memory_ops: List[MemoryOp]


@dataclass
class ExecutionResult:
    """(reference vm.rs:53-103)"""

    cycles: int
    outputs: List[int]
    halt_reason: Halt
    range_check_witnesses: List[RangeCheckWitness] = field(default_factory=list)
    execution_trace: List[TraceRow] = field(default_factory=list)
    normalization_witnesses: List[NormalizationEvent] = field(default_factory=list)
    crypto_witnesses: list = field(default_factory=list)  # CryptoWitness

    def get_memory_trace(self) -> List[MemoryOp]:
        ops = [op for row in self.execution_trace for op in row.memory_ops]
        ops.sort(key=MemoryOp.sort_key)
        return ops

    def memory_op_count(self) -> int:
        return sum(len(row.memory_ops) for row in self.execution_trace)


# Checkpoint-forcing opcodes (vm.rs:316-336).
def _needs_checkpoint(op: Op) -> bool:
    return (
        is_store(op) or is_branch(op) or is_jump(op)
        or op in (Op.DIV, Op.DIVU, Op.REM, Op.REMU)
    )


class VM:
    def __init__(self, program: Program, inputs: List[int],
                 config: Optional[VMConfig] = None):
        config = config or VMConfig()
        if program.header.entry_point < 0x1000:
            raise RuntimeError_(
                f"Program appears to be in debug format "
                f"(entry_point={program.header.entry_point:#x}). "
                f"Use release format for execution."
            )

        self.state = VMState(program.header.entry_point,
                             data_bits=program.config().data_bits)
        self.memory = Memory()
        if program.code:
            self.memory.load_code(program.code, CODE_BASE)
        if program.data:
            data_base = CODE_BASE + len(program.code) * 4
            self.memory.load_data(program.data, data_base)
        # Match the reference: strict protection disabled for execution
        # (vm.rs:172-175); SP not initialized (vm.rs:177-181).
        self.memory.set_strict_protection(False)

        self.io = IOHandler(inputs)
        self.config = config
        self.range_checker = (
            RangeCheckTracker(program.config())
            if config.enable_range_checking else None
        )
        if config.enable_execution_trace:
            self.memory.set_trace_enabled(True)

        self.range_check_witnesses: List[RangeCheckWitness] = []
        self.execution_trace: List[TraceRow] = []
        self.normalization_witnesses: List[NormalizationEvent] = []
        self.crypto_witnesses: list = []

    def run(self) -> ExecutionResult:
        state = self.state
        while not state.is_halted:
            if state.cycles >= self.config.max_cycles:
                state.halt(HaltReason.CYCLE_LIMIT)
                break

            if self.config.enable_execution_trace:
                self.memory.set_timestamp(state.cycles)

            fetch_pc = state.pc
            inst, encoded = self._fetch_and_decode()

            if self.config.trace:
                print(f"[{state.cycles:6}] PC={state.pc:#010x} {inst}")

            pre_state: Optional[Tuple] = None
            if self.config.enable_execution_trace:
                pre_state = (
                    list(state.regs),
                    list(state.bounds),
                    list(state.reg_states),
                )

            current_cycle = state.cycles
            if self.config.enable_deferred_model:
                events = execute_with_deferred(
                    inst, state, self.memory, self.range_checker,
                    DeferredConfig(), current_cycle, fetch_pc,
                )
                self.normalization_witnesses.extend(events)
            else:
                execute(inst, state, self.memory, self.range_checker)

            if inst.op == Op.ECALL:
                handle_syscall(
                    state, self.memory, self.io,
                    witness_sink=(self.crypto_witnesses
                                  if self.config.enable_execution_trace
                                  else None),
                    cycle=current_cycle,
                )

            if pre_state is not None:
                regs, bounds, reg_states = pre_state
                # Data ops from this cycle, excluding the instruction fetch
                # at the (pre-execution) PC (vm.rs:287-298).
                memory_ops = [
                    op for op in self.memory.get_trace()
                    if op.timestamp == state.cycles and op.address != fetch_pc
                ]
                self.execution_trace.append(TraceRow(
                    cycle=state.cycles,
                    pc=fetch_pc,
                    instruction=encoded,
                    registers=regs,
                    bounds=bounds,
                    register_states=reg_states,
                    memory_ops=memory_ops,
                ))

            if self.range_checker is not None:
                if _needs_checkpoint(inst.op) or self.range_checker.should_checkpoint():
                    witness = self.range_checker.checkpoint()
                    if not witness.is_empty:
                        self.range_check_witnesses.append(witness)

            state.inc_cycles()

        return ExecutionResult(
            cycles=state.cycles,
            outputs=list(self.io.outputs),
            halt_reason=state.halt_reason or Halt(HaltReason.EBREAK),
            range_check_witnesses=self.range_check_witnesses,
            execution_trace=self.execution_trace,
            normalization_witnesses=self.normalization_witnesses,
            crypto_witnesses=self.crypto_witnesses,
        )

    def _fetch_and_decode(self) -> Tuple[Instruction, int]:
        if self.state.pc % 4 != 0:
            raise RuntimeError_(f"Misaligned PC: {self.state.pc:#x}")
        word = self.memory.read_u32(self.state.pc)
        return Instruction.decode(word), word


def run(program: Program, inputs: List[int],
        config: Optional[VMConfig] = None) -> ExecutionResult:
    """Convenience entry (reference zkir-runtime/src/lib.rs:59-62)."""
    return VM(program, inputs, config).run()
