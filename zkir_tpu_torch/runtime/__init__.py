"""Host runtime: the scalar oracle VM with full witness generation (host
copies of ``zkir_tpu/runtime``), the crypto syscalls' digests (the
interpreter and the prover use them) and the native engine
(``native_vm``, ``run --engine native``; imported where it is used).

The oracle VM is the specification the batched interpreter
(``zkir_tpu_torch.interp``) is held to, the deferred-carry model
included: register/PC evolution, cycle counts, trace rows, range-check
witnesses, normalization witnesses, syscalls and crypto digests.
"""

from .errors import (RuntimeError_, DivisionByZero, InvalidSyscall,
                     MisalignedAccess)
from .memory import Memory, MemoryOp, MemOpType, MemoryRegion
from .state import VMState, HaltReason, RegState
from .deferred import DeferredConfig
from .range_check import RangeCheckTracker, RangeCheckWitness, RangeLookupTable
from .syscall import (
    IOHandler,
    SYSCALL_EXIT,
    SYSCALL_READ,
    SYSCALL_WRITE,
    SYSCALL_SHA256,
    SYSCALL_POSEIDON2,
    SYSCALL_KECCAK256,
    SYSCALL_BLAKE3,
)
from .vm import VM, VMConfig, ExecutionResult, TraceRow, run
from .normalize import NormalizationResult
from .witness import (NormalizationWitness, NormalizationEvent,
                      NormalizationCause)
