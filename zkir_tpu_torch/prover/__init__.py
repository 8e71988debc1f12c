"""Trace matrix -> STARK proof, on torch tensors.

- ``challenger`` — Poseidon2-sponge Fiat-Shamir transcript (host).
- ``trace``      — execution-trace columns -> M31 AIR trace matrix (host).
- ``fri``        — FRI low-degree commitment over the CM31 NTT domain.
- ``prover``     — end-to-end trace commitment + FRI proof + verification.
"""

from .challenger import Challenger
from .fri import FriConfig, fri_prove, fri_verify
from .prover import prove_trace, verify_trace
from .trace import trace_to_matrix
