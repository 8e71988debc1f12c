"""The port's CM31 NTT family against the JAX package, tolerance 0.

Sizes 2^4 and 2^8 take the reference's radix-2 path, 2^10 and 2^11 its
four-step path; the port has one radix-2 network for all and must give
the same evaluations in the same order.  The reference's evaluations of
these seeded inputs are stored in ``tests/fixtures/torch_port/
ntt_reference.npz`` by ``make_fixtures.py ntt``, which runs
``reference_words`` here (each reference call is an XLA compile).
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu.ops import ntt as rn
from zkir_tpu_torch.ops import ntt as pn

P = (1 << 31) - 1
SHIFT = rn._find_generator()
REFERENCE = pathlib.Path(__file__).resolve().parent / "fixtures" / \
    "torch_port" / "ntt_reference.npz"
NTT_SIZES = (4, 8, 10, 11)
LDE_SIZES = (4, 10)


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host(pair):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                       dtype=np.uint32) for x in pair]


def _words(log_n):
    rng = np.random.default_rng(log_n)
    re = rng.integers(0, P, (3, 1 << log_n), dtype=np.uint32)
    im = rng.integers(0, P, (3, 1 << log_n), dtype=np.uint32)
    return re, im


def _cases(log_n):
    return tuple(torch.from_numpy(a.astype(np.int64))
                 for a in _words(log_n))


def reference_words():
    """The reference's transforms of this file's inputs, by name (what
    ``make_fixtures.py ntt`` stores)."""
    import jax.numpy as jnp

    out = {}

    def put(name, pair):
        out[f"{name}_re"], out[f"{name}_im"] = (np.asarray(x) for x in pair)

    for log_n in NTT_SIZES:
        jr, ji = (jnp.asarray(a) for a in _words(log_n))
        put(f"ntt_{log_n}", rn.ntt(jr, ji, log_n))
        put(f"intt_{log_n}", rn.intt(jr, ji, log_n))
        if log_n in LDE_SIZES:
            put(f"lde_{log_n}", rn.lde(jr, ji, log_n, 1, shift=SHIFT))
            put(f"coset_ntt_{log_n}", rn.coset_ntt(jr, ji, log_n,
                                                   shift=SHIFT))
            put(f"coset_intt_{log_n}", rn.coset_intt(jr, ji, log_n,
                                                     shift=SHIFT))
    return out


@functools.lru_cache(maxsize=None)
def _stored():
    with np.load(REFERENCE) as f:
        return {k: f[k] for k in f.files}


def stored(name):
    return _stored()[f"{name}_re"], _stored()[f"{name}_im"]


def _check(got, want):
    for g, w in zip(host(got), host(want), strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("log_n", NTT_SIZES)
def test_ntt_intt(log_n):
    tr, ti = _cases(log_n)
    _check(pn.ntt(tr, ti, log_n), stored(f"ntt_{log_n}"))
    _check(pn.intt(tr, ti, log_n), stored(f"intt_{log_n}"))


@pytest.mark.parametrize("log_n", LDE_SIZES)
def test_lde_and_cosets(log_n):
    """One size per reference path (the goldens cover 2^6 -> 2^8 and
    2^8 -> 2^10 LDEs too)."""
    tr, ti = _cases(log_n)
    _check(pn.lde(tr, ti, log_n, 1, shift=SHIFT), stored(f"lde_{log_n}"))
    _check(pn.coset_ntt(tr, ti, log_n, shift=SHIFT),
           stored(f"coset_ntt_{log_n}"))
    _check(pn.coset_intt(tr, ti, log_n, shift=SHIFT),
           stored(f"coset_intt_{log_n}"))


def test_host_tables_match():
    assert pn._find_generator() == SHIFT
    for log_n in (3, 9):
        assert pn.root_of_unity(log_n) == rn.root_of_unity(log_n)
        for a, b in zip(pn._twiddle_table(log_n, True),
                        rn._twiddle_table(log_n, True)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(pn._shift_powers(SHIFT, log_n),
                        rn._shift_powers(SHIFT, log_n)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pn._bitrev(log_n), rn._bitrev(log_n))
