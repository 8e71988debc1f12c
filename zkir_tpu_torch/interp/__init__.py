"""Batched interpreter: kernel K3 (``csrc/interp.cu``) runs a chunk of
cycles of every lane in one launch, one thread per lane; the plain torch
version of the same step serves CPU tensors and the tests."""

from .columnar import (
    InterpConfig,
    MachineState,
    TpuInterpreter,
    HALT_NONE,
    HALT_EBREAK,
    HALT_EXIT,
    HALT_CYCLE_LIMIT,
    HALT_ERROR,
    PAUSE_CRYPTO,
    interp_chunk,
    interp_chunk_plain,
    program_features,
)
