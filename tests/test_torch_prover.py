"""The port's prover end to end against the JAX package, tolerance 0.

The reference proofs are golden files (``tests/fixtures/torch_port``,
made by ``make_fixtures.py`` there): a reference prove costs minutes on
the CPU, so tier-1 runs only the port's prover, a dict compare and one
reference verification.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu.prover import verify_trace as ref_verify_trace
from zkir_tpu.prover.fri import FriConfig as RefFriConfig
from zkir_tpu.prover.trace import trace_to_matrix as ref_trace_to_matrix
from zkir_tpu_torch.convert import proof_to_json, trace_from_reference
from zkir_tpu_torch.prover import (FriConfig, prove_trace, trace_to_matrix,
                                   verify_trace)
from zkir_tpu_torch.prover.prover import ConstraintViolation

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
P = (1 << 31) - 1


def _golden(name):
    want = json.loads((FIXTURES / f"golden_{name}.proof.json").read_text())
    with np.load(FIXTURES / f"golden_{name}.matrix.npz") as z:
        return z["matrix"], want


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_proofs():
    """Port proofs (on the CPU) of the golden matrices, by name."""
    out = {}
    for name in ("a", "b"):
        matrix, want = _golden(name)
        out[name] = prove_trace(matrix, FriConfig(**want["fri"]["config"]),
                                device="cpu")
    return out


@pytest.mark.parametrize("name", ["a", "b"])
def test_golden_proof_equal(port_proofs, name):
    """A: the CLI's production proof of examples/fibonacci.zkasm (16-bit
    grinding, radix-2 NTT path).  B: exact_trace_program(8) with a small
    config (LDE domain 2^10, the reference NTT's four-step path)."""
    _, want = _golden(name)
    assert json.loads(proof_to_json(port_proofs[name])) == want


def test_reference_verifier_accepts_port_proof(port_proofs):
    proof = json.loads(proof_to_json(port_proofs["b"]))
    proof["fri"]["config"] = RefFriConfig(**proof["fri"]["config"])
    assert ref_verify_trace(proof)


def _stored_proof(name):
    _, proof = _golden(name)
    proof["fri"]["config"] = FriConfig(**proof["fri"]["config"])
    return proof


def test_port_verifier_accepts_golden_a():
    assert verify_trace(_stored_proof("a"), device="cpu")


def _trace_entry(proof):
    return next(iter(proof["openings"][0]["trace"].values()))


@pytest.mark.parametrize("where", [
    lambda p: (_trace_entry(p)["row"], 5),              # opened trace row
    lambda p: (_trace_entry(p)["path"][3], 1),          # its Merkle sibling
    lambda p: (p["fri"]["queries"][3][1]["lo"], 2),     # FRI layer-1 value
    lambda p: (p["fri"]["queries"][7][1]["path"][1], 0),  # FRI sibling
], ids=["trace_row", "trace_path", "fri_value", "fri_path"])
def test_port_verifier_rejects_changed_opening(where):
    proof = _stored_proof("a")
    words_, k = where(proof)
    words_[k] = (words_[k] + 1) % P
    assert not verify_trace(proof, device="cpu")


def test_trace_to_matrix_matches_reference():
    """The 2^16-row benchmark trace (the card's input) converts to the
    same 65536 x 493 matrix."""
    trace = trace_from_reference(FIXTURES / "trace_exact_2e16.npz")
    got = trace_to_matrix(trace)
    assert got.shape == (1 << 16, 493)
    np.testing.assert_array_equal(got, ref_trace_to_matrix(trace))


def test_violating_trace_is_refused():
    """A trace that breaks the AIR fails at prove time with the violated
    terms named (the first 4 rows of golden A, cut short with a halt)."""
    matrix, want = _golden("a")
    matrix = matrix[:4].copy()
    matrix[3, 2] = 0x51              # EBREAK opcode, selectors left as ADDI
    with pytest.raises(ConstraintViolation, match="violated at rows"):
        prove_trace(matrix, FriConfig(**want["fri"]["config"]),
                    device="cpu")


def test_refused_arguments():
    matrix, _ = _golden("b")
    # A program needs range_lookup.
    with pytest.raises(ValueError, match="requires range_lookup"):
        prove_trace(matrix, device="cpu", program=object())
    with pytest.raises(TypeError, match="device"):
        verify_trace(_stored_proof("b"))
    assert dataclasses.asdict(FriConfig()) == dataclasses.asdict(
        RefFriConfig())
