"""The port's CM31 NTT family against the JAX package, tolerance 0.

Sizes 2^4 and 2^8 take the reference's radix-2 path, 2^10 and 2^11 its
four-step path; the port has one radix-2 network for all and must give
the same evaluations in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkir_tpu.ops import ntt as rn
from zkir_tpu_torch.ops import ntt as pn

P = (1 << 31) - 1
SHIFT = rn._find_generator()


def host(pair):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                       dtype=np.uint32) for x in pair]


def _cases(log_n):
    rng = np.random.default_rng(log_n)
    re = rng.integers(0, P, (3, 1 << log_n), dtype=np.uint32)
    im = rng.integers(0, P, (3, 1 << log_n), dtype=np.uint32)
    return ((jnp.asarray(re), jnp.asarray(im)),
            tuple(torch.from_numpy(a.astype(np.int64)) for a in (re, im)))


def _check(got, want):
    for g, w in zip(host(got), host(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("log_n", [4, 8, 10, 11])
def test_ntt_intt(log_n):
    (jr, ji), (tr, ti) = _cases(log_n)
    _check(pn.ntt(tr, ti, log_n), rn.ntt(jr, ji, log_n))
    _check(pn.intt(tr, ti, log_n), rn.intt(jr, ji, log_n))


@pytest.mark.parametrize("log_n", [4, 10])
def test_lde_and_cosets(log_n):
    """One size per reference path (each reference call is one XLA
    compile; the goldens cover 2^6 -> 2^8 and 2^8 -> 2^10 LDEs too)."""
    (jr, ji), (tr, ti) = _cases(log_n)
    _check(pn.lde(tr, ti, log_n, 1, shift=SHIFT),
           rn.lde(jr, ji, log_n, 1, shift=SHIFT))
    _check(pn.coset_ntt(tr, ti, log_n, shift=SHIFT),
           rn.coset_ntt(jr, ji, log_n, shift=SHIFT))
    _check(pn.coset_intt(tr, ti, log_n, shift=SHIFT),
           rn.coset_intt(jr, ji, log_n, shift=SHIFT))


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
