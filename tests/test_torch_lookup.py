"""The LogUp machinery of ``range_lookup=True`` proofs against the JAX
package, tolerance 0: the host witness functions, the seven partial-sum
functions, the three public demands and the preprocessed tables.

Inputs are the golden D (I/O tape) and E (stores, a load, a SHA-256
syscall) matrices of ``tests/fixtures/torch_port`` padded to 1,024 rows,
and QM31 challenges from a numpy seed.  The reference functions run on
the CPU as the JAX package's own tests run them.
"""

import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu.prover import prover as ref
from zkir_tpu.spec import Program as RefProgram
from zkir_tpu_torch.convert import (fixture_from_reference,
                                    preprocessed_from_reference)
from zkir_tpu_torch.prover import prover as port
from zkir_tpu_torch.prover.aux_table import aux_table_columns
from zkir_tpu_torch.prover.fri import FriConfig

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
P = (1 << 31) - 1
SEED = 20261016


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _challenges():
    rng = np.random.default_rng(SEED)
    return {name: tuple(int(x) for x in rng.integers(1, P, 4))
            for name in ("beta", "gamma", "delta", "eta")}


def _witness(mod, name):
    """Golden ``name`` through one package's host functions: the matrix
    padded to 2^10 rows with the memory table filled, then with the
    lookup and program-multiplicity columns appended."""
    fx = fixture_from_reference(FIXTURES, f"golden_{name}")
    program = fx["program"]
    if mod is ref:
        program = RefProgram.from_bytes(program.to_bytes())
    matrix = fx["matrix"]
    padded, log_n = mod._pad_rows(matrix, min_log=10)
    padded = padded.copy()
    mod._build_memory_table(padded, matrix.shape[0], program=program)
    with_table = padded.copy()
    if mod is ref:
        padded = ref._build_lookup_columns(padded)
    else:       # the port keeps the appended columns a block of their own
        padded = np.concatenate([padded, port._build_lookup_columns(
            padded, port._channel_witnesses(padded))], axis=1)
    m_prog = mod._program_multiplicity(padded, matrix.shape[0],
                                       len(program.code))
    full = np.concatenate([padded, m_prog[:, None]], axis=1)
    out = {"program": program, "log_n": log_n, "memory_table": with_table,
           "lookup_columns": padded, "program_multiplicity": m_prog,
           "padded": full, "io": mod.extract_io(full),
           "crypto_tape": mod.extract_crypto_tape(full)}
    if mod is port:     # its functions read the matrix as device columns
        out["cols"] = port._words(full, "cpu").T.contiguous()
        out["witnesses"] = port._words(port._channel_witnesses(full), "cpu")
    return out


@pytest.fixture(scope="module")
def witnesses():
    return {(side, name): _witness(mod, name)
            for side, mod in (("ref", ref), ("port", port))
            for name in ("d", "e")}


@pytest.mark.parametrize("name", ["d", "e"])
@pytest.mark.parametrize("what", ["memory_table", "lookup_columns",
                                  "program_multiplicity", "io",
                                  "crypto_tape"])
def test_host_function_matches_reference(witnesses, what, name):
    """_build_memory_table, _build_lookup_columns, _program_multiplicity,
    extract_io and extract_crypto_tape."""
    got, want = witnesses["port", name][what], witnesses["ref", name][what]
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    if (what, name) == ("io", "d"):
        assert got == ([10], [55])
    if (what, name) == ("crypto_tape", "e"):
        assert [e["num"] for e in got] == [3] and got[0]["len"] == 3
    if (what, name) == ("memory_table", "e"):
        assert not np.array_equal(
            got, port._pad_rows(fixture_from_reference(
                FIXTURES, "golden_e")["matrix"], min_log=10)[0])


def _np4(q4):
    """A QM31 4-tuple of jax arrays or torch tensors as one int64 array."""
    return np.stack([np.asarray(c).astype(np.int64) for c in q4])


def _flat(out):
    """(S, F) pairs and single QM31 4-tuples alike, as a list of arrays."""
    if isinstance(out[0], tuple):
        return [_np4(part) for part in out]
    return [_np4(out)]


# function -> (golden, the reference's call on (witness, challenges), the
# port's).  The reference's functions read the host matrix; the port's read
# the same matrix as columns on the device.
_SUMS = {
    "_build_partial_sums": (
        "e",
        lambda w, c: ref._build_partial_sums(w["padded"], c["beta"]),
        lambda w, c: port._build_partial_sums(w["cols"], w["witnesses"],
                                              c["beta"])),
    "_build_aux_partial_sums": (
        "e",
        lambda w, c: ref._build_aux_partial_sums(
            w["padded"], aux_table_columns(w["log_n"]), c["beta"], c["eta"]),
        lambda w, c: port._build_aux_partial_sums(
            w["cols"], port._words(aux_table_columns(w["log_n"]), "cpu"),
            c["beta"], c["eta"])),
    "_crypto_slot_inverses": (
        "e",
        lambda w, c: ref._crypto_slot_inverses(w["padded"], c["beta"],
                                               c["delta"]),
        lambda w, c: port._crypto_slot_inverses(w["cols"], c["beta"],
                                                c["delta"])),
    "_memory_partial_sum": (
        "e",
        lambda w, c: ref._memory_partial_sum(w["padded"], c["beta"],
                                             c["delta"]),
        lambda w, c: port._memory_partial_sum(w["cols"], c["beta"],
                                              c["delta"])),
    "_io_partial_sum": (
        "d",
        lambda w, c: ref._io_partial_sum(w["padded"], c["beta"], c["delta"]),
        lambda w, c: port._io_partial_sum(w["cols"], c["beta"], c["delta"])),
    "_crypto_tape_partial_sum": (
        "e",
        lambda w, c: ref._crypto_tape_partial_sum(w["padded"], c["beta"],
                                                  c["delta"]),
        lambda w, c: port._crypto_tape_partial_sum(w["cols"], c["beta"],
                                                   c["delta"])),
    "_program_partial_sum": (
        "e",
        lambda w, c: ref._program_partial_sum(
            w["padded"], ref._program_table(list(w["program"].code),
                                            w["log_n"]),
            c["beta"], c["gamma"]),
        lambda w, c: port._program_partial_sum(
            w["cols"], port._words(port._program_table(
                list(w["program"].code), w["log_n"]), "cpu"),
            c["beta"], c["gamma"])),
}
_DEMANDS = {
    "memory_init_demand": ("e", lambda m, w, c, dev: m.memory_init_demand(
        w["program"], c["beta"], c["delta"], **dev)),
    "io_tape_demand": ("d", lambda m, w, c, dev: m.io_tape_demand(
        *w["io"], c["beta"], c["delta"], **dev)),
    "crypto_tape_demand": ("e", lambda m, w, c, dev: m.crypto_tape_demand(
        w["crypto_tape"], c["beta"], c["delta"], **dev)),
}


@pytest.mark.parametrize("function", list(_SUMS) + list(_DEMANDS))
def test_partial_sums_and_demands_match_reference(witnesses, function):
    """Same padded matrix, same seeded challenges: the reference's jitted
    compress -> batch-invert -> prefix-sum functions against the port's
    (whose compression runs on the device, and whose inversion is
    elementwise Fermat where the reference runs a Montgomery chain)."""
    c = _challenges()
    if function in _SUMS:
        name, ref_call, port_call = _SUMS[function]
        want = _flat(ref_call(witnesses["ref", name], c))
        got = _flat(port_call(witnesses["port", name], c))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
            assert w.any()          # the channel is exercised by the trace
    else:
        name, call = _DEMANDS[function]
        want = call(ref, witnesses["ref", name], c, {})
        got = call(port, witnesses["port", name], c, {"device": "cpu"})
        assert got == want and any(want)


def test_crypto_tape_demand_rejects_malformed_tape(witnesses):
    c = _challenges()
    tape = [dict(e) for e in witnesses["port", "e"]["crypto_tape"]]
    tape[0]["more"] = 1                      # a chain that never ends
    assert port.crypto_tape_demand(tape, c["beta"], c["delta"],
                                   device="cpu") is None
    assert port.crypto_tape_demand([], c["beta"], c["delta"],
                                   device="cpu") == (0, 0, 0, 0)


def test_device_compression_equals_host_compression():
    """_beta_minus_compress (stacked, one product and one sum per
    coordinate) gives the words of _beta_minus_compress_np (one
    multiply-accumulate per component), also on [slots, n] components."""
    rng = np.random.default_rng(SEED)
    c = _challenges()
    for shape in ((257,), (3, 129)):
        comps = [rng.integers(0, P, shape).astype(np.uint32)
                 for _ in range(19)]
        comps[0][...] = P - 1
        comps[1][...] = P           # not canonical: both reduce it
        want = port._beta_minus_compress_np(comps, c["beta"], c["delta"])
        got = port._beta_minus_compress(
            [port._words(x, "cpu") for x in comps], c["beta"], c["delta"])
        np.testing.assert_array_equal(_np4(got), want.astype(np.int64))


def test_preprocessed_table_roots_match_reference(witnesses):
    """preprocess_aux(10, 2) and preprocess_program of golden E's program:
    roots, committed rows and tree levels, against the reference's (made
    by ``make_fixtures.py pre``; the reference takes some 40 s for them
    on the CPU, the port a fraction of a second)."""
    config = FriConfig(log_blowup=2, log_final=3, num_queries=4,
                       grinding_bits=2, min_security=0)
    code = list(witnesses["port", "e"]["program"].code)
    stored = FIXTURES / "preprocessed_e.npz"
    assert code == list(RefProgram.from_bytes(
        (FIXTURES / "golden_e.program.zkir").read_bytes()).code)
    for got, want in (
            (port.preprocess_aux(10, 2, device="cpu"),
             preprocessed_from_reference(stored, "aux")),
            (port.preprocess_program(code, 10, config, device="cpu"),
             preprocessed_from_reference(stored, "program"))):
        assert got["root"] == want["root"]
        np.testing.assert_array_equal(got["cols"], want["cols"])
        np.testing.assert_array_equal(got["rows"].numpy(),
                                      np.asarray(want["rows"]))
        for g, w in zip(got["levels"], want["levels"], strict=True):
            np.testing.assert_array_equal(g, w)
    assert port.preprocess_aux(10, 2, device="cpu") is \
        port.preprocess_aux(10, 2, device="cpu")       # cached per device


def test_quotient_term_counts():
    """The constraint terms the quotient evaluates (one alpha power each):
    721 without ``range_lookup``, 887 with every lookup argument and the
    program bound.  The golden proofs pin their order and values; this pins
    the counts that size the quotient's work."""
    from zkir_tpu_torch.prover import constraints as cs

    n_trace = fixture_from_reference(FIXTURES, "golden_e")["matrix"].shape[1]
    n_pts = 16
    z = torch.zeros((n_trace + 1 + cs.NUM_LOOKUP + cs.NUM_AUX + 1, n_pts),
                    dtype=torch.int64)

    def q4(k=None):
        shape = (n_pts,) if k is None else (k, n_pts)
        return tuple(torch.zeros(shape, dtype=torch.int64) for _ in range(4))

    ch = (1, 2, 3, 4)
    _, plain = cs._vec_terms(z[:n_trace], z[:n_trace], 2, None, None, None,
                             None, None, None)
    _, full = cs._vec_terms(
        z, z, 2, lookup=(q4(cs.NUM_LOOKUP), ch),
        aux=((z[:12], z[:12]), q4(cs.NUM_AUX), ch),
        program=((z[:4], z[:4]), q4(), ch, 0x1000),
        memory=((q4(), q4()), ch, ch), io=((q4(), q4()), ch, ch),
        crypto=((q4(cs.N_SLOTS), q4(), q4()), ch, ch))
    assert (len(plain), len(full)) == (721, 887)
