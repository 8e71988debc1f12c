"""The port's batched hashes (``zkir_tpu_torch.ops.sha256``, ``keccak``,
``blake3``, and ``poseidon2.sponge_hash_rows``, the Poseidon2 syscalls')
against the JAX package's on the CPU, word for word.

On the CPU each port function runs the plain torch version of its kernel
(``csrc/crypto.cu``, ``csrc/poseidon2.cu``); the reference runs its
jitted batch functions, and its scalar ``poseidon2_sponge_hash_bytes``.  The
inputs are the reference tests' vectors (``tests/test_sha256_kernel.py``,
``tests/test_crypto_kernels_batch.py``) and messages, blocks and states
made with ``numpy.random.default_rng``.  The reference's results on these
inputs are stored in ``tests/fixtures/torch_port/crypto_reference.npz``
by ``make_fixtures.py crypto``, which runs ``reference_words`` here (each
JAX function once); the cases compare slices of them.
"""

import functools
import hashlib
import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu.ops.poseidon2_ref import poseidon2_sponge_hash_bytes
from zkir_tpu_torch.ops import blake3, byte_rows, keccak, sha256
from zkir_tpu_torch.ops import poseidon2 as p2

SEED = 20261018
REFERENCE = pathlib.Path(__file__).resolve().parent / "fixtures" / \
    "torch_port" / "crypto_reference.npz"


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """Several pytest workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pat(n):
    return bytes(i % 251 for i in range(n))


def _seeded(seed, count, most):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, size=int(n), dtype=np.uint8))
            for n in rng.integers(0, most + 1, size=count)]


SHA_VECTORS = [b"", b"abc", b"hello", b"a" * 55, b"a" * 56, b"a" * 64,
               b"a" * 200, bytes(range(256)) * 5]
KECCAK_VECTORS = [b"", b"abc", b"hello", b"x" * 135, b"x" * 136, b"x" * 137,
                  b"y" * 300]
BLAKE3_VECTORS = [b"", b"abc", _pat(63), _pat(64), _pat(65), _pat(1023),
                  _pat(1024), _pat(1025), _pat(3000), _pat(33 * 1024)]
MESSAGES = {
    "sha256": {"vectors": SHA_VECTORS, "seeded": _seeded(SEED, 32, 300)},
    "keccak": {"vectors": KECCAK_VECTORS, "seeded": _seeded(SEED + 1, 16, 300)},
    "blake3": {"vectors": BLAKE3_VECTORS,
               "seeded": _seeded(SEED + 2, 16, 3000)},
}


def _u64(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint64).view(np.int64))


# ============================================================================
# Whole messages
# ============================================================================


def _messages(name):
    return [m for group in MESSAGES[name].values() for m in group]


STREAM_PARTS = [[b"hello ", b"world", b"!" * 100], [b"", b"abc", b""],
                [b"x" * 64, b"y" * 64, b"z" * 7]]


def _sha_blocks():
    rng = np.random.default_rng(SEED + 3)
    blocks = rng.integers(0, 1 << 32, size=(8, 16), dtype=np.uint64)
    states = rng.integers(0, 1 << 32, size=(8, 8), dtype=np.uint64)
    return blocks, states


def _keccak_states():
    rng = np.random.default_rng(SEED + 4)
    states = rng.integers(0, 1 << 64, size=(8, 25), dtype=np.uint64)
    states[:, ::2] |= np.uint64(1 << 63)
    return states


def _b3_args():
    rng = np.random.default_rng(SEED + 5)
    cv = rng.integers(0, 1 << 32, size=(8, 8), dtype=np.uint64)
    words = rng.integers(0, 1 << 32, size=(8, 16), dtype=np.uint64)
    lo, hi = (rng.integers(0, 1 << 32, size=8, dtype=np.uint64)
              for _ in range(2))
    hi |= np.uint64(1)
    block_len = rng.integers(0, 65, size=8, dtype=np.uint64)
    flags = rng.integers(0, 16, size=8, dtype=np.uint64)
    return cv, words, lo, hi, block_len, flags


def _digest_rows(digests):
    return np.stack([np.frombuffer(d, dtype=np.uint8) for d in digests])


def reference_words():
    """The reference's results for this file's inputs, by name (what
    ``make_fixtures.py crypto`` stores)."""
    import jax.numpy as jnp

    from zkir_tpu.ops import blake3 as ref_b3
    from zkir_tpu.ops import keccak as ref_keccak
    from zkir_tpu.ops import sha256 as ref_sha

    out = {
        "many_sha256": _digest_rows(ref_sha.digests_to_bytes(
            ref_sha.sha256_many(_messages("sha256")))),
        "many_keccak": _digest_rows(
            ref_keccak.keccak256_many(_messages("keccak"))),
        "many_blake3": _digest_rows(
            ref_b3.blake3_many(_messages("blake3")))}
    stream = ref_sha.Sha256Stream(3)
    for i in range(3):
        stream.update([part[i] for part in STREAM_PARTS])
    out["sha256_stream"] = _digest_rows(stream.finalize())
    final, witness = ref_sha.sha256_compress_batch_with_witness(
        *(jnp.asarray(a.astype(np.uint32)) for a in _sha_blocks()))
    out["sha256_final"], out["sha256_witness"] = (np.asarray(final),
                                                  np.asarray(witness))
    out["keccak_f1600"] = np.asarray(ref_keccak.keccak_f1600_batch(
        jnp.asarray(_keccak_states())))
    out["b3_compress"] = np.asarray(ref_b3.b3_compress_batch(
        *(jnp.asarray(a.astype(np.uint32)) for a in _b3_args())))
    return out


@functools.lru_cache(maxsize=None)
def stored():
    with np.load(REFERENCE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def many():
    """Each hash of every message list, by the reference (stored) and by
    the port, as lists of 32-byte digests."""
    out = {}
    for name in MESSAGES:
        messages = _messages(name)
        ref = [row.tobytes() for row in stored()[f"many_{name}"]]
        if name == "sha256":
            port_words = sha256.sha256_many(messages, "cpu")
            assert port_words.dtype == np.uint32 and port_words.shape == (
                len(messages), 8)
            port = sha256.digests_to_bytes(port_words)
        elif name == "keccak":
            port = keccak.keccak256_many(messages, "cpu")
        else:
            port = blake3.blake3_many(messages, "cpu")
        out[name] = messages, ref, port
    return out


@pytest.mark.parametrize("name,group", [(name, group) for name in MESSAGES
                                        for group in MESSAGES[name]])
def test_many_equals_the_reference(many, name, group):
    messages, ref, port = many[name]
    first = sum(len(g) for g in list(MESSAGES[name].values())[
        :list(MESSAGES[name]).index(group)])
    span = slice(first, first + len(MESSAGES[name][group]))
    assert port[span] == ref[span]
    if name == "sha256":
        assert port[span] == [hashlib.sha256(m).digest()
                              for m in messages[span]]


def test_keccak_known_answer(many):
    messages, _, port = many["keccak"]
    assert port[messages.index(b"abc")].hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")


def test_sha256_stream_equals_the_reference():
    """The reference test's parts through both streams."""
    port = sha256.Sha256Stream(3, "cpu")
    for i in range(3):
        port.update([part[i] for part in STREAM_PARTS])
    assert port.finalize() == [row.tobytes()
                               for row in stored()["sha256_stream"]]


# ============================================================================
# Single compressions and permutations
# ============================================================================


@pytest.fixture(scope="module")
def sha_blocks():
    blocks, states = _sha_blocks()
    final, witness = stored()["sha256_final"], stored()["sha256_witness"]
    port = sha256.sha256_compress_batch_with_witness(
        torch.from_numpy(blocks.astype(np.int64)),
        torch.from_numpy(states.astype(np.int64)))
    plain = sha256.sha256_compress_batch(
        torch.from_numpy(blocks.astype(np.int64)),
        torch.from_numpy(states.astype(np.int64)))
    return (np.asarray(final), np.asarray(witness)), port, plain


@pytest.mark.parametrize("part", ["final", "rounds"])
def test_sha256_compress_with_witness_equals_the_reference(sha_blocks, part):
    (final, witness), (port_final, port_witness), plain = sha_blocks
    if part == "final":
        np.testing.assert_array_equal(port_final.numpy(), final)
        np.testing.assert_array_equal(plain.numpy(), final)
    else:
        assert tuple(port_witness.shape) == (8, 64, 8)
        np.testing.assert_array_equal(port_witness.numpy(), witness)


def test_keccak_f1600_equals_the_reference():
    """Eight seeded states, half their lanes with the top bit set: the
    plain version's right shifts must be logical."""
    port = keccak.keccak_f1600_batch(_u64(_keccak_states()))
    np.testing.assert_array_equal(port.numpy().view(np.uint64),
                                  stored()["keccak_f1600"])


def test_b3_compress_equals_the_reference():
    """Eight seeded rows, their counters above 2^32."""
    port = blake3.b3_compress_batch(*(torch.from_numpy(a.astype(np.int64))
                                      for a in _b3_args()))
    np.testing.assert_array_equal(port.numpy(), stored()["b3_compress"])


# ============================================================================
# Rows where they lie: what the interpreter's syscalls pass
# ============================================================================


def test_rows_read_in_place_from_one_buffer():
    """Rows at any offset of one buffer, overlapping, empty ones pointing
    past its end, and rows that end at its last byte: each digest equals
    the hash of the bytes sliced out, for all three hashes."""
    rng = np.random.default_rng(SEED + 6)
    buf = rng.integers(0, 256, size=4096, dtype=np.uint8)
    offsets = np.array([0, 1, 3, 4000, 4095, 96, 17, 5000, 1024, 2049])
    lengths = np.array([0, 55, 137, 96, 1, 1025, 3000, 0, 64, 2047])
    data = torch.from_numpy(buf)
    messages = [buf[o:o + n].tobytes() for o, n in zip(offsets, lengths)]
    got = sha256.sha256_rows(data, offsets, lengths).numpy()
    assert sha256.digests_to_bytes(got) == [hashlib.sha256(m).digest()
                                            for m in messages]
    assert [row.astype("<u4").tobytes() for row in keccak.keccak256_words(
        data, offsets, lengths).numpy()] == keccak.keccak256_many(
            messages, "cpu")
    assert [row.astype("<u4").tobytes() for row in blake3.blake3_rows(
        data, offsets, lengths).numpy()] == blake3.blake3_many(
            messages, "cpu")


def test_rows_outside_the_buffer_are_refused():
    data = torch.zeros(100, dtype=torch.uint8)
    for offsets, lengths in (([90], [11]), ([-1], [1]), ([0], [-1])):
        with pytest.raises(ValueError, match="outside|lie"):
            byte_rows.check(data, offsets, lengths)
    with pytest.raises(ValueError, match="uint8"):
        byte_rows.check(data.to(torch.int64), [0], [1])


# ============================================================================
# The Poseidon2 syscall sponge: rows of bytes against the scalar reference
# ============================================================================


def _p2_groups():
    """Each group's (data, offsets, lengths): seeded messages of the
    lengths around a word and a rate block; words at and above p (p
    itself, 2^31, 2^32 - 2 = 2p, 2^32 - 1, and a short last word of ones);
    rows of one buffer at odd offsets, overlapping; seeded messages."""
    rng = np.random.default_rng(SEED + 7)
    lengths = [bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
               for n in (0, 1, 3, 4, 31, 32, 33, 64, 3000)]
    top = [bytes.fromhex(h) for h in (
        "ffffff7f", "00000080", "feffffff", "ffffffff", "ffffffffff",
        "ffffff7f" * 9 + "00000080" * 7 + "ffffffff")]
    buf = rng.integers(0, 256, size=4096, dtype=np.uint8)
    offsets = np.array([1, 3, 5, 7, 1001, 1001, 4095, 2047, 9])
    spans = np.array([33, 64, 3000, 31, 100, 1, 1, 2049, 0])
    return {
        "lengths": byte_rows.pack(lengths, "cpu"),
        "words at and above p": byte_rows.pack(top, "cpu"),
        "odd offsets, overlapping": (torch.from_numpy(buf), offsets, spans),
        "seeded": byte_rows.pack(_seeded(SEED + 8, 16, 3000), "cpu"),
    }


@pytest.fixture(scope="module")
def p2_rows():
    """Each group's digests by the port and by the reference."""
    out = {}
    for group, (data, offsets, lengths) in _p2_groups().items():
        blob = data.numpy().tobytes()
        ref = [poseidon2_sponge_hash_bytes(blob[o:o + n])
               for o, n in zip(offsets, lengths)]
        port = p2.sponge_hash_rows(data, offsets, lengths)
        assert port.dtype == torch.int64 and tuple(port.shape) == (
            len(ref), 8)
        out[group] = port.tolist(), ref
    return out


@pytest.mark.parametrize("group", ["lengths", "words at and above p",
                                   "odd offsets, overlapping", "seeded"])
def test_poseidon2_syscall_digests_equal_the_reference(p2_rows, group):
    port, ref = p2_rows[group]
    assert port == ref
