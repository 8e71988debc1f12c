"""The LogUp partial sums' two device functions against the JAX package.

``qm31_inv_scaled`` (a (.) x^-1 + b (.) y^-1 over QM31) and
``exclusive_cumsum4`` take their plain versions on CPU tensors; each of the
reference's compositions over ``qm31_batch_inv`` and ``_exclusive_cumsum4``
(``_masked_inv_kernel``, ``_memory_partial_sum_kernel``,
``_two_sided_sum_kernel``, ``_channel_sum_kernel``, ``_aux_sum_kernel``,
``_qm31_inv_sum_kernel``, ``_exclusive_cumsum4_jit``), run by JAX on the
CPU, is held to the port's on the same seeded words, tolerance 0.  The
words include the edges: QM31 zero (which maps to zero), 0, 1 and p - 1 in
each coordinate, and rows of all p - 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkir_tpu.prover import prover as ref
from zkir_tpu_torch.ops import qm31
from zkir_tpu_torch.prover import prover as port

P = (1 << 31) - 1
SEED = 20261018
N = 96                         # columns (rows of the trace)
EDGE = (0, 1, P - 1)


def _q4(rng, shape):
    """A QM31 4-tuple of int64 words of ``shape``: seeded words, the last
    axis opening with QM31 zero, then each coordinate running through the
    edge words 0, 1, p - 1 while the others hold seeded words."""
    q = [rng.integers(0, P, shape, dtype=np.int64) for _ in range(4)]
    for c in q:
        c[..., 0] = 0
    at = 1
    for k in range(4):
        for e in EDGE:
            q[k][..., at] = e
            at += 1
    return tuple(q)


def _scale(rng, shape):
    s = rng.integers(0, P, shape, dtype=np.int64)
    s[..., :3] = EDGE
    return s


def _ref(arrays):
    """numpy int64 words as the reference's uint32 jax arrays."""
    return tuple(jnp.asarray(a.astype(np.uint32)) for a in arrays)


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _np(out):
    """(S, F) pairs, 4-tuples and host ints alike, as int64 arrays."""
    if isinstance(out[0], tuple):
        return [a for part in out for a in _np(part)]
    return [np.asarray(c).astype(np.int64) for c in out]


def _cases():
    rng = np.random.default_rng(SEED)
    w4, t4 = _q4(rng, (N,)), _q4(rng, (N,))
    v, real = _scale(rng, (N,)), _scale(rng, (N,))
    rows = 5
    bw4, bt4 = _q4(rng, (rows, N)), _q4(rng, (rows, N))
    m = _scale(rng, (rows, N))
    witnesses = rng.integers(0, P, (rows, N), dtype=np.int64)
    witnesses[:, :3] = EDGE
    table = rng.integers(0, P, N, dtype=np.int64)
    beta = tuple(int(x) for x in rng.integers(1, P, 4))
    # beta with coordinates 1-3 zero, and a witness and a table word equal
    # to its coordinate 0: QM31 zero, which maps to zero.
    beta0 = (int(witnesses[1, 5]), 0, 0, 0)
    table0 = table.copy()
    table0[7] = beta0[0]
    return {
        "_masked_inv_kernel": (
            lambda: ref._masked_inv_kernel(_ref(bw4), jnp.asarray(
                m.astype(np.uint32))),
            lambda: port._masked_inv_kernel(_t(bw4), torch.from_numpy(m))),
        "_memory_partial_sum_kernel": (
            lambda: ref._memory_partial_sum_kernel(
                _ref(w4), _ref(t4), *_ref((v, real))),
            lambda: port._memory_partial_sum_kernel(
                _t(w4), _t(t4), *_t((v, real)))),
        "_two_sided_sum_kernel": (
            lambda: ref._two_sided_sum_kernel(
                _ref(w4), _ref(t4), *_ref((v, real))),
            lambda: port._two_sided_sum_kernel(
                _t(w4), _t(t4), *_t((v, real)))),
        "_channel_sum_kernel": (
            lambda: ref._channel_sum_kernel(
                *_ref((witnesses, table, m)),
                tuple(jnp.uint32(b) for b in beta)),
            lambda: port._channel_sum_kernel(
                *_t((witnesses, table, m)), beta)),
        "_channel_sum_kernel, QM31 zero": (
            lambda: ref._channel_sum_kernel(
                *_ref((witnesses, table0, m)),
                tuple(jnp.uint32(b) for b in beta0)),
            lambda: port._channel_sum_kernel(
                *_t((witnesses, table0, m)), beta0)),
        "_aux_sum_kernel": (
            lambda: ref._aux_sum_kernel(_ref(bw4), _ref(bt4),
                                        jnp.asarray(m.astype(np.uint32))),
            lambda: port._aux_sum_kernel(_t(bw4), _t(bt4),
                                         torch.from_numpy(m))),
        "_qm31_inv_sum_kernel": (
            lambda: ref._qm31_inv_sum_kernel(_ref(w4)),
            lambda: port._qm31_inv_sum_kernel(_t(w4))),
    }


@pytest.mark.parametrize("composition", list(_cases()))
def test_scaled_inversion_matches_the_reference_composition(composition):
    want_fn, got_fn = _cases()[composition]
    want, got = _np(want_fn()), _np(got_fn())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_batch_inverse_maps_zero_to_zero_and_inverts_the_rest():
    """``qm31_batch_inv`` on the edge words: x * x^-1 = 1 where x is not
    zero, zero where it is."""
    x = _t(_q4(np.random.default_rng(SEED + 1), (N,)))
    inv = qm31.qm31_batch_inv(x)
    prod = qm31.qm31_mul(x, inv)
    nonzero = torch.stack(x).ne(0).any(dim=0)
    assert not nonzero[0] and nonzero[1:].all()
    for k, want in enumerate((1, 0, 0, 0)):
        assert (prod[k][1:] == want).all()
        assert inv[k][0] == 0


@pytest.mark.parametrize("shape", [(N,), (6, N), (1, 1)],
                         ids=["1-D", "2-D", "one word"])
def test_exclusive_cumsum4_matches_the_reference(shape):
    """``exclusive_cumsum4_plain`` (what ``exclusive_cumsum4`` runs on CPU
    tensors) against ``_exclusive_cumsum4_jit``: seeded words with a row
    (or a run) of p - 1."""
    rng = np.random.default_rng(SEED + len(shape))
    term = [rng.integers(0, P, shape, dtype=np.int64) for _ in range(4)]
    term[1][...] = P - 1
    flat = term[2].reshape(-1)
    flat[:3] = EDGE[:flat.size]
    want = _np(ref._exclusive_cumsum4_jit(_ref(term)))
    got = _np(qm31.exclusive_cumsum4(_t(term)))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert all((g[..., 0] == 0).all() for g in got)
