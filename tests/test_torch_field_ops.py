"""The port's field layer (M31, CM31, QM31) against the JAX package.

Inputs are seeded numpy words (with the edge words 0, 1 and p - 1) fed to
both sides; the tolerance is 0 — every value is a field element.  The
Pallas kernel behind K1 runs in interpret mode, as the JAX package's own
tests run it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkir_tpu.ops import field_ops as rf
from zkir_tpu.ops import ntt as rntt
from zkir_tpu.ops import qm31 as rq
from zkir_tpu_torch.ops import field_ops as pf
from zkir_tpu_torch.ops import ntt as pntt
from zkir_tpu_torch.ops import qm31 as pq

P = (1 << 31) - 1
EDGE = np.asarray([0, 1, P - 1], dtype=np.uint32)


def words(seed, n, zeros=False):
    """n seeded canonical words; the first 9 pair every edge word with
    every other when two such arrays are zipped."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, P, n, dtype=np.uint32)
    w[:9] = np.repeat(EDGE, 3) if seed % 2 else np.tile(EDGE, 3)
    if zeros:
        w[rng.integers(0, n, 16)] = 0
    return w


def t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      dtype=np.uint32)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_m31_binary_matches_jnp_and_pallas(op):
    a, b = words(1, 4096), words(2, 4096)
    got = host(getattr(pf, f"m31_{op}")(t(a), t(b)))
    want = host(getattr(rf, f"m31_{op}")(jnp.asarray(a), jnp.asarray(b)))
    pallas = host(getattr(rf, f"m31_{op}_pallas")(
        jnp.asarray(a.reshape(32, 128)), jnp.asarray(b.reshape(32, 128)),
        interpret=True)).ravel()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_m31_broadcast_and_python_constants():
    a = words(3, 64).reshape(8, 8)
    col = words(4, 16)[8:]
    got = host(pf.m31_mul(t(a), t(col)[:, None]))
    want = host(rf.m31_mul(jnp.asarray(a), jnp.asarray(col)[:, None]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        host(pf.m31_mul(t(a), 12345)),
        host(rf.m31_mul(jnp.asarray(a), jnp.uint32(12345))))
    np.testing.assert_array_equal(
        host(pf.m31_sub(7, t(a))),
        host(rf.m31_sub(jnp.full_like(jnp.asarray(a), 7), jnp.asarray(a))))


def test_m31_neg_pow_inv():
    a = words(5, 1024, zeros=True)
    ja, ta = jnp.asarray(a), t(a)
    np.testing.assert_array_equal(host(pf.m31_neg(ta)), host(rf.m31_neg(ja)))
    np.testing.assert_array_equal(host(pf.m31_pow(ta, 5)),
                                  host(rf.m31_pow(ja, 5)))
    np.testing.assert_array_equal(host(pf.m31_pow2(ta, 3)),
                                  host(rf.m31_pow2(ja, 3)))
    np.testing.assert_array_equal(host(pf.m31_inv(ta)), host(rf.m31_inv(ja)))


@pytest.mark.parametrize("shape", [(5000,), (64, 4)])
def test_m31_batch_inv(shape):
    """Zero -> zero, and a long 1-D input (the reference's [steps, 2048]
    schedule) as well as a batch over the leading axis."""
    a = words(6, int(np.prod(shape)), zeros=True).reshape(shape)
    got = host(pf.m31_batch_inv(t(a)))
    np.testing.assert_array_equal(got, host(rf.m31_batch_inv(jnp.asarray(a))))
    assert np.all(got[a == 0] == 0)


def test_cm31_ops():
    a = (words(7, 512), words(8, 512))
    b = (words(9, 512), words(10, 512))
    for name in ("cm31_mul", "cm31_add", "cm31_sub"):
        got = getattr(pntt, name)(tuple(map(t, a)), tuple(map(t, b)))
        want = getattr(rntt, name)(tuple(map(jnp.asarray, a)),
                                   tuple(map(jnp.asarray, b)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(host(g), host(w))


def test_qm31_vector_ops():
    x = tuple(words(11 + k, 512, zeros=True) for k in range(4))
    y = tuple(words(21 + k, 512) for k in range(4))
    c = (words(31, 512), words(32, 512))
    tx, ty, tc = (tuple(map(t, v)) for v in (x, y, c))
    jx, jy, jc = (tuple(map(jnp.asarray, v)) for v in (x, y, c))
    cases = [(pq.qm31_add(tx, ty), rq.qm31_add(jx, jy)),
             (pq.qm31_sub(tx, ty), rq.qm31_sub(jx, jy)),
             (pq.qm31_mul(tx, ty), rq.qm31_mul(jx, jy)),
             (pq.qm31_mul_cm31(tx, tc), rq.qm31_mul_cm31(jx, jc)),
             (pq.qm31_batch_inv(tx), rq.qm31_batch_inv(jx))]
    for got, want in cases:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(host(g), host(w))


def test_qm31_scalar_helpers():
    rng = np.random.default_rng(40)
    for _ in range(20):
        x = tuple(int(v) for v in rng.integers(0, P, 4))
        y = tuple(int(v) for v in rng.integers(0, P, 4))
        c = (int(rng.integers(0, P)), int(rng.integers(0, P)))
        assert pq.qm31_mul_scalar(x, y) == rq.qm31_mul_scalar(x, y)
        assert pq.qm31_inv_scalar(x) == rq.qm31_inv_scalar(x)
        assert pq.qm31_pow_scalar(x, 77) == rq.qm31_pow_scalar(x, 77)
        assert pq.qm31_mul_cm31_scalar(x, c) == rq.qm31_mul_cm31_scalar(x, c)
        assert pntt.cm31_inv_scalar(c) == rntt.cm31_inv_scalar(c)
