"""QM31: the degree-4 extension of Mersenne-31 (stwo-style), in torch.

Counterpart of ``zkir_tpu/ops/qm31.py``.  QM31 = CM31[u] / (u^2 - (2 + i))
with CM31 = M31[i] / (i^2 + 1): the field the batching, DEEP, FRI-fold
and LogUp challenges are drawn from.

Representations:

- scalar: a 4-tuple of Python ints ``(ar, ai, br, bi)`` meaning
  ``(ar + ai*i) + (br + bi*i) * u`` (host copies of the reference's);
- vectorized: the same 4-tuple of int64 tensors of canonical words.

The LogUp partial sums' two device functions live here too:
``qm31_inv_scaled`` (a (.) x^-1 + b (.) y^-1; ``qm31_batch_inv`` is its
plain form) and ``exclusive_cumsum4`` (exclusive prefix sums mod p of a
QM31 4-tuple along its last axis).  For tensors on a GPU each is one
launch of its kernel (``csrc/qm31.cu``: ``qm31_inv_scaled``,
``m31_exclusive_scan``); for tensors on the CPU they run the plain
versions ``qm31_inv_scaled_plain`` and ``exclusive_cumsum4_plain``, which
are plain torch (no K1 launch, also on a GPU tensor).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..spec.field import M31_PRIME
from .field_ops import (add_plain, cm31_mul_plain, cm31_sub_plain,
                        m31_inv_plain, mul_plain, sub_plain)
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
# Vectorized on the host (int64 numpy arrays of canonical words)
# ============================================================================


def cm31_mul_np(a, b):
    """CM31 products of int64 arrays (each coordinate two products below
    2^62 summed, then reduced); ``cm31_mul_scalar`` over arrays."""
    return ((a[0] * b[0] + (P - a[1]) * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def qm31_mul_np(x, y):
    """QM31 products of [4, ...] int64 arrays; ``qm31_mul_scalar`` over
    arrays."""
    aa = cm31_mul_np(x[:2], y[:2])
    bb = cm31_mul_np(x[2:], y[2:])
    ab = cm31_mul_np(x[:2], y[2:])
    ba = cm31_mul_np(x[2:], y[:2])
    rb = cm31_mul_np(R, bb)
    return np.stack([(aa[0] + rb[0]) % P, (aa[1] + rb[1]) % P,
                     (ab[0] + ba[0]) % P, (ab[1] + ba[1]) % P])


@functools.lru_cache(maxsize=8)
def qm31_powers_np(alpha, n: int) -> np.ndarray:
    """alpha^0 .. alpha^(n - 1) as a read-only int64 array [4, n], cached
    (the verifier weighs every query point by the same powers)."""
    pw = np.zeros((4, n), dtype=np.int64)
    power = QM31_ONE
    for k in range(n):
        pw[:, k] = power
        power = qm31_mul_scalar(power, alpha)
    pw.flags.writeable = False
    return pw


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


def qm31_batch_inv_plain(x):
    """QM31 inversion in plain torch, zero mapping to zero: the CM31 norm
    a^2 - R b^2, its M31 norm inverted by Fermat's chain
    (``m31_inv_plain``), then (a - b u) times the CM31 inverse.  A
    coordinate may be a Python int (a constant)."""
    a = (x[0], x[1])
    b = (x[2], x[3])
    nr, ni = cm31_sub_plain(cm31_mul_plain(a, a),
                            cm31_mul_plain(cm31_mul_plain(b, b), R))
    m_inv = m31_inv_plain(add_plain(mul_plain(nr, nr), mul_plain(ni, ni)))
    cinv = (mul_plain(nr, m_inv), mul_plain(sub_plain(0, ni), m_inv))
    an = cm31_mul_plain(a, cinv)
    bn = cm31_mul_plain(b, cinv)
    return (an[0], an[1], sub_plain(0, bn[0]), sub_plain(0, bn[1]))


def qm31_inv_scaled_plain(x, a=1, y=None, b=1, *, subtract=False):
    """``qm31_inv_scaled`` in plain torch: the inverses of x (and of y,
    once for its own shape, then broadcast) scaled by a (and b)."""
    out = tuple(mul_plain(c, a) for c in qm31_batch_inv_plain(x))
    if y is None:
        return out
    second = tuple(mul_plain(c, b) for c in qm31_batch_inv_plain(y))
    combine = sub_plain if subtract else add_plain
    return tuple(combine(o, t) for o, t in zip(out, second))


def _on_cuda(values) -> bool:
    return any(isinstance(v, torch.Tensor) and v.is_cuda for v in values)


# Rows a thread of the inversion kernel takes where y is one row for all
# (it inverts y once for them), and elements that share one exponent
# chain (csrc/qm31.cu INV_BATCH).
RUN_ROWS = 8
INV_BATCH = 4
# Words a block of the scan kernel takes (csrc/qm31.cu: 256 threads x 16).
SCAN_TILE = 4096


def qm31_inv_scaled(x, a=1, y=None, b=1, *, subtract=False):
    """a (.) x^-1 + b (.) y^-1 over QM31, elementwise (``subtract``: minus
    the second term; without y, a (.) x^-1), zero mapping to zero.  x and
    y are QM31 4-tuples whose coordinates are int64 tensors or Python ints
    (constants); a and b are M31 tensors or ints; every tensor broadcasts
    to the result's shape (at most two axes; y is often one row for all).
    The partial-sum functions' one form: ``1/w - m/t``, ``v/w - real/t``,
    ``n_r/w_r + n_w/w_w``, ``mask/w``, ``1/w``.  On a GPU one launch of
    ``qm31_inv_scaled`` (``csrc/qm31.cu``); on the CPU
    ``qm31_inv_scaled_plain``.  Returns a 4-tuple of tensors."""
    if not _on_cuda((*x, a, *(y or ()), b)):
        return qm31_inv_scaled_plain(x, a, y, b, subtract=subtract)
    return _inv_scaled_cuda(x, a, y, b, subtract)


def qm31_batch_inv(x):
    """Vectorized QM31 inversion, zero mapping to zero: ``qm31_inv_scaled``
    with no scale (on a GPU one launch; on the CPU the plain chain)."""
    return qm31_inv_scaled(x)


def _inv_scaled_cuda(x, a, y, b, subtract):
    from .. import _kernels

    operands = [*x, *(y if y is not None else (0, 0, 0, 0)), a, b]
    tensors = [t for t in operands if isinstance(t, torch.Tensor)]
    device = tensors[0].device
    nd = max(t.dim() for t in tensors)
    if nd > 2:
        raise ValueError(f"QM31 inversion over {nd} axes; at most two are "
                         "taken")
    # the broadcast shape (expand below refuses sizes that do not match)
    shape = torch.Size(max(t.shape[k - nd + t.dim()]
                           if k - nd + t.dim() >= 0 else 1 for t in tensors)
                       for k in range(nd))
    rows, n = (1, *shape)[-2:] if shape else (1, 1)
    if rows == 1:
        # one row: fold it into up to INV_BATCH rows, so that a thread's
        # batch shares its exponent chain
        rows = math.gcd(n, INV_BATCH)
        n //= rows
    # views (and any copy made for a layout the kernel does not take),
    # held until the launch has been queued
    views, strides, imms = [], [], []
    for t in operands:
        if not isinstance(t, torch.Tensor):
            views.append(None)
            strides.append(0)
            imms.append(int(t) % P)
            continue
        if t.dtype is not torch.int64 or t.device != device:
            raise TypeError(f"operands must be int64 on {device}, got "
                            f"{t.dtype} on {t.device}")
        view = t if t.shape == (rows, n) else \
            t.expand(shape).reshape(rows, n)
        if n > 1 and view.stride(1) != 1:
            view = view.contiguous()
        views.append(view)
        strides.append(view.stride(0) if rows > 1 else 0)
        imms.append(0)
    y_once = y is not None and not any(strides[4:8])
    # runs of at most INV_BATCH rows, as even as may be (y once: RUN_ROWS)
    rpt = min(rows, RUN_ROWS) if y_once else \
        -(-rows // -(-rows // INV_BATCH))
    flags = (y is not None) | (2 if subtract else 0)
    desc = (ctypes.c_longlong * 24)(rows, n, rpt, flags, *strides, *imms)
    out = torch.empty((4, rows, n), dtype=torch.int64, device=device)
    if out.numel():
        _kernels.launch("qm31_inv_scaled",
                        *(v if v is None else v.data_ptr() for v in views),
                        out.data_ptr(), desc)
    return tuple(out[k].reshape(shape) for k in range(4))


def exclusive_cumsum4_plain(term4):
    """Exclusive prefix sums mod p along the last axis of each coordinate
    of a QM31 4-tuple, in plain torch: an int64 cumsum, exact for < 2^33
    terms (each < 2^31), then ``% P``."""
    out = []
    for c in term4:
        cum = torch.cumsum(c, dim=-1) % P
        s = torch.zeros_like(cum)
        s[..., 1:] = cum[..., :-1]
        out.append(s)
    return tuple(out)


def exclusive_cumsum4(term4):
    """``exclusive_cumsum4_plain``'s words; on a GPU one launch of
    ``m31_exclusive_scan`` for all four coordinates (a block a tile of
    4,096 words, the tiles of a row chained by a look-back, so rows of any
    length and any count)."""
    if not _on_cuda(term4):
        return exclusive_cumsum4_plain(term4)
    from .. import _kernels

    shape = term4[0].shape
    if any(c.shape != shape or c.dtype is not torch.int64 for c in term4):
        raise ValueError("the four coordinates must be int64 tensors of one "
                         "shape")
    ins = [c.contiguous() for c in term4]
    n = shape[-1] if shape else 1
    rows = ins[0].numel() // n if n else 0
    out = torch.empty((4, *shape), dtype=torch.int64, device=ins[0].device)
    vec = n % 2 == 0 and all(t.data_ptr() % 16 == 0 for t in (*ins, out))
    if out.numel():
        # each tile's published word, then the counter that hands them out
        status = torch.zeros(4 * rows * -(-n // SCAN_TILE) + 1,
                             dtype=torch.int64, device=out.device)
        _kernels.launch("m31_exclusive_scan", *(t.data_ptr() for t in ins),
                        out.data_ptr(), status.data_ptr(), rows, n, int(vec))
    return tuple(out[k] for k in range(4))
