"""QM31: the degree-4 extension of Mersenne-31 (stwo-style), in torch.

Counterpart of ``zkir_tpu/ops/qm31.py``.  QM31 = CM31[u] / (u^2 - (2 + i))
with CM31 = M31[i] / (i^2 + 1): the field the batching, DEEP, FRI-fold
and LogUp challenges are drawn from.

Representations:

- scalar: a 4-tuple of Python ints ``(ar, ai, br, bi)`` meaning
  ``(ar + ai*i) + (br + bi*i) * u`` (host copies of the reference's);
- vectorized: the same 4-tuple of int64 tensors of canonical words.
"""

from __future__ import annotations

from ..spec.field import M31_PRIME
from .field_ops import m31_add, m31_batch_inv, m31_mul, m31_neg
from .ntt import cm31_add, cm31_inv_scalar, cm31_mul, cm31_mul_scalar, \
    cm31_sub

P = M31_PRIME

# u^2 = R in CM31.
R = (2, 1)

QM31_ONE = (1, 0, 0, 0)


# ============================================================================
# Scalar (host Python ints)
# ============================================================================


def qm31_add_scalar(x, y):
    return tuple((a + b) % P for a, b in zip(x, y))


def qm31_sub_scalar(x, y):
    return tuple((a - b) % P for a, b in zip(x, y))


def qm31_mul_scalar(x, y):
    """(a1 + b1 u)(a2 + b2 u) = (a1 a2 + R b1 b2) + (a1 b2 + a2 b1) u."""
    a1, b1 = (x[0], x[1]), (x[2], x[3])
    a2, b2 = (y[0], y[1]), (y[2], y[3])
    aa = cm31_mul_scalar(a1, a2)
    bb = cm31_mul_scalar(b1, b2)
    ab = cm31_mul_scalar(a1, b2)
    ba = cm31_mul_scalar(b1, a2)
    rb = cm31_mul_scalar(R, bb)
    return ((aa[0] + rb[0]) % P, (aa[1] + rb[1]) % P,
            (ab[0] + ba[0]) % P, (ab[1] + ba[1]) % P)


def qm31_inv_scalar(x):
    """1/(a + b u) = (a - b u) / (a^2 - R b^2); the norm is in CM31."""
    a = (x[0], x[1])
    b = (x[2], x[3])
    norm = cm31_mul_scalar(a, a)
    rb2 = cm31_mul_scalar(R, cm31_mul_scalar(b, b))
    norm = ((norm[0] - rb2[0]) % P, (norm[1] - rb2[1]) % P)
    ninv = cm31_inv_scalar(norm)
    an = cm31_mul_scalar(a, ninv)
    bn = cm31_mul_scalar(b, ninv)
    return (an[0], an[1], (P - bn[0]) % P, (P - bn[1]) % P)


def qm31_pow_scalar(x, exp: int):
    result = QM31_ONE
    base = tuple(v % P for v in x)
    while exp > 0:
        if exp & 1:
            result = qm31_mul_scalar(result, base)
        base = qm31_mul_scalar(base, base)
        exp >>= 1
    return result


def qm31_mul_cm31_scalar(x, c):
    """QM31 x times CM31 c (acts componentwise on the u-basis)."""
    a = cm31_mul_scalar((x[0], x[1]), c)
    b = cm31_mul_scalar((x[2], x[3]), c)
    return (a[0], a[1], b[0], b[1])


# ============================================================================
# Vectorized (int64 tensors)
# ============================================================================


def _times_r(c):
    """R * c for a CM31 value c, R = (2, 1): (2 re - im, re + 2 im)."""
    return cm31_mul(c, R)


def qm31_add(x, y):
    return (*cm31_add(x[:2], y[:2]), *cm31_add(x[2:], y[2:]))


def qm31_sub(x, y):
    return (*cm31_sub(x[:2], y[:2]), *cm31_sub(x[2:], y[2:]))


def qm31_mul(x, y):
    a1, b1 = (x[0], x[1]), (x[2], x[3])
    a2, b2 = (y[0], y[1]), (y[2], y[3])
    aa = cm31_mul(a1, a2)
    bb = cm31_mul(b1, b2)
    ab = cm31_mul(a1, b2)
    ba = cm31_mul(b1, a2)
    a_out = cm31_add(aa, _times_r(bb))
    b_out = cm31_add(ab, ba)
    return (a_out[0], a_out[1], b_out[0], b_out[1])


def qm31_mul_cm31(x, c):
    """QM31 vector times CM31 vector (componentwise on the u-basis):
    4 CM31 products instead of a full 6-product QM31 multiply."""
    a = cm31_mul((x[0], x[1]), c)
    b = cm31_mul((x[2], x[3]), c)
    return (a[0], a[1], b[0], b[1])


def qm31_batch_inv(x):
    """Vectorized QM31 inversion via the CM31 norm and one batched M31
    inversion.  Zero maps to zero."""
    a = (x[0], x[1])
    b = (x[2], x[3])
    # norm = a^2 - R b^2 in CM31; invert via its M31 norm.
    nr, ni = cm31_sub(cm31_mul(a, a), _times_r(cm31_mul(b, b)))
    m_inv = m31_batch_inv(m31_add(m31_mul(nr, nr), m31_mul(ni, ni)))
    cinv = (m31_mul(nr, m_inv), m31_mul(m31_neg(ni), m_inv))
    an = cm31_mul(a, cinv)
    bn = cm31_mul(b, cinv)
    return (an[0], an[1], m31_neg(bn[0]), m31_neg(bn[1]))
