"""The port's field layer (M31, CM31, QM31) against the JAX package.

Inputs are seeded numpy words (with the edge words 0, 1 and p - 1) fed to
both sides; the tolerance is 0 — every value is a field element.  The
Pallas kernel behind K1 ran in interpret mode, as the JAX package's own
tests run it on the CPU: the reference's words on these inputs are
stored in ``tests/fixtures/torch_port/field_reference.npz`` by
``make_fixtures.py field``, which runs ``reference_words`` here.  The
scalar helpers, host Python on both sides, run here.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu.ops import ntt as rntt
from zkir_tpu.ops import qm31 as rq
from zkir_tpu_torch.ops import field_ops as pf
from zkir_tpu_torch.ops import ntt as pntt
from zkir_tpu_torch.ops import qm31 as pq

P = (1 << 31) - 1
EDGE = np.asarray([0, 1, P - 1], dtype=np.uint32)
REFERENCE = pathlib.Path(__file__).resolve().parent / "fixtures" / \
    "torch_port" / "field_reference.npz"
OPS = ("add", "sub", "mul")
BATCH_INV_SHAPES = ((5000,), (64, 4))


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


def _binary_inputs():
    return words(1, 4096), words(2, 4096)


def _broadcast_inputs():
    return words(3, 64).reshape(8, 8), words(4, 16)[8:]


def _batch_inv_input(shape):
    return words(6, int(np.prod(shape)), zeros=True).reshape(shape)


def _cm31_inputs():
    return (words(7, 512), words(8, 512)), (words(9, 512), words(10, 512))


def _qm31_inputs():
    return (tuple(words(11 + k, 512, zeros=True) for k in range(4)),
            tuple(words(21 + k, 512) for k in range(4)),
            (words(31, 512), words(32, 512)))


def reference_words():
    """The reference's words for this file's inputs, by name (what
    ``make_fixtures.py field`` stores)."""
    import jax.numpy as jnp

    from zkir_tpu.ops import field_ops as rf

    out = {}
    a, b = _binary_inputs()
    for op in OPS:
        out[f"m31_{op}"] = getattr(rf, f"m31_{op}")(jnp.asarray(a),
                                                   jnp.asarray(b))
        out[f"m31_{op}_pallas"] = getattr(rf, f"m31_{op}_pallas")(
            jnp.asarray(a.reshape(32, 128)), jnp.asarray(b.reshape(32, 128)),
            interpret=True)
    a, col = _broadcast_inputs()
    out["broadcast_col"] = rf.m31_mul(jnp.asarray(a),
                                      jnp.asarray(col)[:, None])
    out["broadcast_const"] = rf.m31_mul(jnp.asarray(a), jnp.uint32(12345))
    out["broadcast_sub"] = rf.m31_sub(jnp.full_like(jnp.asarray(a), 7),
                                      jnp.asarray(a))
    ja = jnp.asarray(words(5, 1024, zeros=True))
    out.update(m31_neg=rf.m31_neg(ja), m31_pow=rf.m31_pow(ja, 5),
               m31_pow2=rf.m31_pow2(ja, 3), m31_inv=rf.m31_inv(ja))
    for shape in BATCH_INV_SHAPES:
        out[f"batch_inv_{len(shape)}"] = rf.m31_batch_inv(
            jnp.asarray(_batch_inv_input(shape)))
    a, b = (tuple(map(jnp.asarray, v)) for v in _cm31_inputs())
    for name in ("cm31_mul", "cm31_add", "cm31_sub"):
        out[name] = np.stack(getattr(rntt, name)(a, b))
    jx, jy, jc = (tuple(map(jnp.asarray, v)) for v in _qm31_inputs())
    for name, got in (("qm31_add", rq.qm31_add(jx, jy)),
                      ("qm31_sub", rq.qm31_sub(jx, jy)),
                      ("qm31_mul", rq.qm31_mul(jx, jy)),
                      ("qm31_mul_cm31", rq.qm31_mul_cm31(jx, jc)),
                      ("qm31_batch_inv", rq.qm31_batch_inv(jx))):
        out[name] = np.stack(got)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def stored():
    with np.load(REFERENCE) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("op", OPS)
def test_m31_binary_matches_jnp_and_pallas(op):
    a, b = _binary_inputs()
    got = host(getattr(pf, f"m31_{op}")(t(a), t(b)))
    np.testing.assert_array_equal(got, stored()[f"m31_{op}"])
    np.testing.assert_array_equal(got, stored()[f"m31_{op}_pallas"].ravel())


def test_m31_broadcast_and_python_constants():
    a, col = _broadcast_inputs()
    np.testing.assert_array_equal(host(pf.m31_mul(t(a), t(col)[:, None])),
                                  stored()["broadcast_col"])
    np.testing.assert_array_equal(host(pf.m31_mul(t(a), 12345)),
                                  stored()["broadcast_const"])
    np.testing.assert_array_equal(host(pf.m31_sub(7, t(a))),
                                  stored()["broadcast_sub"])


def test_m31_neg_pow_inv():
    ta = t(words(5, 1024, zeros=True))
    np.testing.assert_array_equal(host(pf.m31_neg(ta)), stored()["m31_neg"])
    np.testing.assert_array_equal(host(pf.m31_pow(ta, 5)),
                                  stored()["m31_pow"])
    np.testing.assert_array_equal(host(pf.m31_pow2(ta, 3)),
                                  stored()["m31_pow2"])
    np.testing.assert_array_equal(host(pf.m31_inv(ta)), stored()["m31_inv"])


@pytest.mark.parametrize("shape", BATCH_INV_SHAPES)
def test_m31_batch_inv(shape):
    """Zero -> zero, and a long 1-D input (the reference's [steps, 2048]
    schedule) as well as a batch over the leading axis."""
    a = _batch_inv_input(shape)
    got = host(pf.m31_batch_inv(t(a)))
    np.testing.assert_array_equal(got, stored()[f"batch_inv_{len(shape)}"])
    assert np.all(got[a == 0] == 0)


def test_cm31_ops():
    a, b = _cm31_inputs()
    for name in ("cm31_mul", "cm31_add", "cm31_sub"):
        got = getattr(pntt, name)(tuple(map(t, a)), tuple(map(t, b)))
        np.testing.assert_array_equal(np.stack([host(g) for g in got]),
                                      stored()[name])


def test_qm31_vector_ops():
    tx, ty, tc = (tuple(map(t, v)) for v in _qm31_inputs())
    cases = [("qm31_add", pq.qm31_add(tx, ty)),
             ("qm31_sub", pq.qm31_sub(tx, ty)),
             ("qm31_mul", pq.qm31_mul(tx, ty)),
             ("qm31_mul_cm31", pq.qm31_mul_cm31(tx, tc)),
             ("qm31_batch_inv", pq.qm31_batch_inv(tx))]
    for name, got in cases:
        np.testing.assert_array_equal(np.stack([host(g) for g in got]),
                                      stored()[name])


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
