"""Batched interpreter: kernel K3 (``csrc/interp.cu``) runs every lane of a
run to its halt or pause in one launch (``interp_run``; ``interp_chunk``
is one chunk of it), a thread or a warp per lane; the plain torch
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
    decode_table,
    interp_chunk,
    interp_chunk_plain,
    interp_run,
    interp_run_plain,
    program_features,
)
