"""zkir_tpu_torch: zkir-tpu ported to PyTorch and CUDA (Hopper), from
program to verified proof.

A second package beside ``zkir_tpu`` (the JAX reference, which stays as it
is).  It imports ``torch`` and numpy, never ``jax`` and never ``zkir_tpu``,
and mirrors the reference's layout so that each module's counterpart is
easy to find:

- ``zkir_tpu_torch.cli``     — ``python -m zkir_tpu_torch asm | disasm |
  run | prove | verify`` (``--device cuda`` unless asked for ``cpu``).
- ``zkir_tpu_torch.spec``    — host copies: the ISA (opcodes, registers,
  encoding, instructions), the M31 scalar field, memory layout constants,
  the program binary format.
- ``zkir_tpu_torch.asm``     — host copies of the assembler and
  disassembler.
- ``zkir_tpu_torch.interp``  — the batched interpreter (CUDA kernel K3, one
  thread per lane) and its checkpoints.
- ``zkir_tpu_torch.ops``     — field layer (CUDA kernel K1), Poseidon2
  (CUDA kernel K2), NTT, QM31, Merkle trees, on int64 tensors.
- ``zkir_tpu_torch.prover``  — trace matrix, constraints, the LogUp
  partial sums, the preprocessed aux and program tables, FRI, and
  ``prove_trace``/``verify_trace`` (with and without ``range_lookup``
  and program binding, with stage checkpoints).
- ``zkir_tpu_torch.convert`` — carries state over from the JAX package
  (trace dicts, machine states, program-bound fixtures, Poseidon2
  constants, proof JSON).

CUDA sources live in ``csrc/``; ``_kernels`` builds them with ``nvcc`` at
first use on a GPU.
"""

__version__ = "0.1.0"
