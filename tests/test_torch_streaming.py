"""The port's column-streaming prover against the JAX package, tolerance 0.

``merkle.RowSponge`` (fed a column block at a time) against the port's
``hash_rows`` and the reference's ``RowSponge`` (its digests of the seeded
rows stored in ``tests/fixtures/torch_port/row_sponge_reference.npz`` by
``make_fixtures.py sponge``, which runs ``reference_row_sponge`` here);
the plain version of ``p2_sponge_absorb`` from a non-zero state against
the scalar ``poseidon2_ref`` sponge; ``prove_trace_streaming`` on the CPU
against the stored reference proofs of goldens C and E (the reference's
one-shot proofs: its own tests show its streaming proof is the same),
with two block sizes, accepted by the port's verifier; a tampered trace
refused;
``prove --streaming --checkpoint-dir`` refused (``mesh=``:
``tests/test_torch_sharded_prover.py``).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu_torch.cli import main
from zkir_tpu_torch.convert import fixture_from_reference, proof_to_json
from zkir_tpu_torch.ops import merkle
from zkir_tpu_torch.ops.poseidon2 import sponge_absorb, sponge_absorb_plain
from zkir_tpu_torch.ops.poseidon2_ref import RATE, WIDTH, poseidon2_permute
from zkir_tpu_torch.prover import verify_trace
from zkir_tpu_torch.prover.prover import ConstraintViolation
from zkir_tpu_torch.prover.streaming import prove_trace_streaming

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
SPONGE_REFERENCE = FIXTURES / "row_sponge_reference.npz"
P = (1 << 31) - 1


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.int64)


@pytest.mark.parametrize("splits", [
    (1, 7, 8, 37),           # pending words carried over several chunks
    (16, 64, 1000),          # whole rate blocks: nothing ever pending
    (3,),                    # one short chunk, then the rest
    (1192,),                 # the whole row in one chunk
])
def test_row_sponge_equals_hash_rows(splits):
    matrix = torch.from_numpy(_words((64, 1192), 7))
    sponge = merkle.RowSponge(64, device="cpu")
    at = 0
    for width in splits + (1192 - sum(splits),):
        if width:
            sponge.absorb(matrix[:, at:at + width])
            at += width
    assert at == 1192
    assert torch.equal(sponge.finalize(), merkle.hash_rows(matrix))


def reference_row_sponge():
    """The reference's ``RowSponge`` digests of the seeded [8, 45] rows fed
    in blocks of 13 and 32 columns (what ``make_fixtures.py sponge``
    stores)."""
    import jax.numpy as jnp

    from zkir_tpu.ops.merkle import RowSponge as RefRowSponge

    matrix = _words((8, 45), 11)
    ref = RefRowSponge(8)
    ref.absorb(jnp.asarray(matrix[:, :13].astype(np.uint32)))
    ref.absorb(jnp.asarray(matrix[:, 13:].astype(np.uint32)))
    return np.asarray(ref.finalize())


def test_row_sponge_matches_reference():
    matrix = _words((8, 45), 11)
    port = merkle.RowSponge(8, device="cpu")
    port.absorb(torch.from_numpy(matrix[:, :13]))
    port.absorb(torch.from_numpy(matrix[:, 13:]))
    with np.load(SPONGE_REFERENCE) as stored:
        np.testing.assert_array_equal(port.finalize().numpy(),
                                      stored["digests"])


@pytest.mark.parametrize("width, pad", [(16, False), (13, True), (0, True)])
def test_sponge_absorb_plain_from_a_state(width, pad):
    """From non-zero states, in place, against the scalar sponge: rate
    blocks added to words 0..7 and permuted, then the 1||0* block."""
    states = torch.from_numpy(_words((3, WIDTH), 5))
    rows = _words((3, width), 6)
    want = []
    for state, row in zip(states.tolist(), rows.tolist()):
        words = row + ([1] + [0] * (-(width + 1) % RATE) if pad else [])
        for off in range(0, len(words), RATE):
            state = [(s + w) % P for s, w in
                     zip(state, words[off:off + RATE])] + state[RATE:]
            state = poseidon2_permute(state)
        want.append(state)
    got = sponge_absorb_plain(states, torch.from_numpy(rows), pad)
    assert got.tolist() == want
    sponge_absorb(states, torch.from_numpy(rows), pad)
    assert states.tolist() == want


@pytest.mark.parametrize("block", [3, 7, 64])
def test_coset_evaluations_are_the_lde_interleaved(block):
    """Coset c of the blowup-4 LDE domain is every 4th point from c: the
    blocks' evaluations, written into rows of one buffer, equal the
    one-shot LDE's columns at c::4 (real and CM31 columns)."""
    from zkir_tpu_torch.ops.ntt import lde
    from zkir_tpu_torch.prover.prover import _coset_shift
    from zkir_tpu_torch.prover.streaming import _coset_shifts, _eval_all

    vr = torch.from_numpy(_words((7, 64), 3))
    vi = torch.from_numpy(_words((7, 64), 4))
    for im in (None, vi):
        er, ei = lde(vr, im, 6, 2, shift=_coset_shift())
        for c, shift_c in enumerate(_coset_shifts(6, 2, _coset_shift())):
            got = _eval_all(vr, im, 6, shift_c, block)
            assert torch.equal(got[0], er[:, c::4])
            assert torch.equal(got[1], ei[:, c::4])


@pytest.fixture(scope="module")
def fixtures():
    return {name: fixture_from_reference(FIXTURES, f"golden_{name}")
            for name in "ce"}


@pytest.mark.parametrize("name, col_block", [("c", 37), ("e", 512)])
def test_streaming_proof_equals_golden(fixtures, name, col_block):
    """C: the full constraint set, no program, blocks of 37 columns (the
    trace's last block and the sums' blocks leave words pending in the
    sponge); E: program-bound with a SHA-256 syscall, blocks of 512."""
    fx = fixtures[name]
    proof = prove_trace_streaming(fx["matrix"], fx["config"],
                                  program=fx["program"], col_block=col_block,
                                  device="cpu")
    assert json.loads(proof_to_json(proof)) == fx["want"]
    assert verify_trace(proof, fx["program"], device="cpu")


def test_streaming_refuses_a_tampered_trace(fixtures):
    fx = fixtures["c"]
    bad = fx["matrix"].copy()
    bad[2, 8 + 3] ^= 1          # a register value
    with pytest.raises(ConstraintViolation, match="streaming prover"):
        prove_trace_streaming(bad, fx["config"], col_block=1024,
                              device="cpu")


def test_cli_streaming_refuses_checkpoints(tmp_path):
    with pytest.raises(SystemExit) as exc:
        main(["--device", "cpu", "prove", str(ROOT / "examples" /
                                              "fibonacci.zkasm"),
              "--input", "10", "--streaming", "--checkpoint-dir",
              str(tmp_path / "ck")])
    assert "writes no stage checkpoints" in str(exc.value)
    assert not (tmp_path / "ck").exists()
