"""The port's full-constraint prover (``range_lookup=True``, program
binding) end to end against the JAX package, tolerance 0.

The reference proofs are golden files (``tests/fixtures/torch_port``, made
by ``make_fixtures.py`` there): a reference ``range_lookup`` prove compiles
several jitted kernels, so tier-1 runs only the port's prover on the CPU, a
dict compare and one reference verification.

- C: ``exact_trace_matrix(10)``, the full constraint set, no program;
- D: the CLI's ``prove examples/fibonacci.zkasm --input 10 --bind``
  (production ``FriConfig()``, an I/O tape, program-bound);
- E: stores, a load and a SHA-256 syscall, program-bound.
"""

import copy
import json
import pathlib

import pytest
import torch

from zkir_tpu.prover import prover as ref_prover
from zkir_tpu.prover import verify_trace as ref_verify_trace
from zkir_tpu.prover.fri import FriConfig as RefFriConfig
from zkir_tpu.spec import Program as RefProgram
from zkir_tpu_torch.convert import (fixture_from_reference,
                                    preprocessed_from_reference,
                                    proof_from_json, proof_to_json)
from zkir_tpu_torch.prover import prove_trace, verify_trace

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
P = (1 << 31) - 1


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixtures():
    return {name: fixture_from_reference(FIXTURES, f"golden_{name}")
            for name in "cde"}


@pytest.fixture(scope="module")
def port_proofs(fixtures):
    """Port proofs (on the CPU) of the golden matrices, by name, made at
    first use."""
    made = {}

    def get(name):
        if name not in made:
            fx = fixtures[name]
            made[name] = prove_trace(fx["matrix"], fx["config"],
                                     range_lookup=True,
                                     program=fx["program"], device="cpu")
        return made[name]
    return get


@pytest.mark.parametrize("name", ["c", "d", "e"])
def test_bound_proof_equal(fixtures, port_proofs, name):
    want = fixtures[name]["want"]
    assert want["range_lookup"] and ("program" in want) == (name != "c")
    assert json.loads(proof_to_json(port_proofs(name))) == want


@pytest.mark.parametrize("name", ["c", "d", "e"])
def test_port_verifier_accepts_bound_proof(fixtures, port_proofs, name):
    assert verify_trace(port_proofs(name), fixtures[name]["program"],
                        device="cpu")


def test_reference_verifier_accepts_bound_port_proof(fixtures, port_proofs,
                                                    monkeypatch):
    """Through the CLI's JSON, with the public program: the memory
    argument, crypto tape and program binding of E (4 queries; D's 32
    would take the reference's scalar verifier most of a minute).  The
    reference verifier recomputes the roots of both preprocessed tables on
    every call (some 40 s on the CPU); it reads them here from the
    reference's stored tables (``make_fixtures.py pre``)."""
    stored = FIXTURES / "preprocessed_e.npz"
    code = list(fixtures["e"]["program"].code)

    def aux(log_n, log_blowup):
        assert (log_n, log_blowup) == (10, 2)
        return preprocessed_from_reference(stored, "aux")

    def program_table(code_words, log_n, fri_config):
        assert (list(code_words), log_n, fri_config.log_blowup) == (
            code, 10, 2)
        return preprocessed_from_reference(stored, "program")

    monkeypatch.setattr(ref_prover, "preprocess_aux", aux)
    monkeypatch.setattr(ref_prover, "preprocess_program", program_table)
    proof = json.loads(proof_to_json(port_proofs("e")))
    proof["fri"]["config"] = RefFriConfig(**proof["fri"]["config"])
    program = RefProgram.from_bytes(fixtures["e"]["program"].to_bytes())
    assert ref_verify_trace(proof, program=program)


def _stored(fixtures, name):
    """The reference's stored proof as the port's verifier takes it."""
    return proof_from_json(json.dumps(fixtures[name]["want"]))


def _opened(proof, tree):
    return next(iter(proof["openings"][0][tree].values()))


def _bump(words, k):
    words[k] = (words[k] + 1) % P


def _claim_output(proof):
    proof["io"]["outputs"][0] += 1


def _claim_message_byte(proof):
    proof["crypto"][0]["msg"][1] ^= 1


@pytest.mark.parametrize("name, tamper", [
    ("c", lambda p: _bump(_opened(p, "sums")["row"], 7)),
    ("c", lambda p: _bump(_opened(p, "aux")["path"][2], 0)),
    ("d", _claim_output),
    ("e", _claim_message_byte),
    ("e", lambda p: _bump(_opened(p, "prog")["row"], 4)),
    ("d", lambda p: p.pop("sums_root")),
], ids=["sums_word", "aux_sibling", "claimed_output", "crypto_tape_byte",
        "program_row", "no_sums_root"])
def test_port_verifier_rejects_tampered_bound_proof(fixtures, name, tamper):
    proof = _stored(fixtures, name)
    program = fixtures[name]["program"]
    untouched = copy.deepcopy(proof)
    tamper(proof)
    assert proof != untouched
    try:
        assert not verify_trace(proof, program, device="cpu")
    except KeyError:
        pass        # a proof without a required field is no proof


def test_port_verifier_binds_the_program(fixtures):
    """E's stored proof verifies with E's program, not with D's, and a
    program cannot be bound to a proof that carries none."""
    proof = _stored(fixtures, "e")
    assert verify_trace(proof, fixtures["e"]["program"], device="cpu")
    assert not verify_trace(proof, fixtures["d"]["program"], device="cpu")
    assert not verify_trace(_stored(fixtures, "c"), fixtures["e"]["program"],
                            device="cpu")


def test_program_needs_range_lookup(fixtures):
    fx = fixtures["e"]
    with pytest.raises(ValueError, match="range_lookup"):
        prove_trace(fx["matrix"], fx["config"], program=fx["program"],
                    device="cpu")


def test_fixture_carries_program_and_inputs(fixtures):
    assert fixtures["d"]["inputs"] == [10]
    assert fixtures["c"]["program"] is None
    assert fixtures["e"]["program"].to_bytes() == \
        (FIXTURES / "golden_e.program.zkir").read_bytes()
    assert fixtures["d"]["program"].header.entry_point == 0x1000
