"""Elementwise Mersenne-31 field arithmetic on torch tensors.

Counterpart of ``zkir_tpu/ops/field_ops.py``.  Canonical M31 words are
``torch.int64`` tensors with values in [0, p): an M31 x M31 product
(< 2^62) is exact in int64 and ``a + b`` cannot overflow, while torch's
``uint32`` has no ``+``, ``>>`` or ``>=`` on the CPU.  Words are cast to
``uint32``/numpy only at the proof boundary.

Dispatch: ``m31_add``/``m31_sub``/``m31_mul`` launch the CUDA kernel K1
(``csrc/m31_binary.cu``) for tensors on a GPU and run the plain torch
versions (``add_plain``/``sub_plain``/``mul_plain``) for tensors on the
CPU.  The plain versions are also what the other modules' plain
references (e.g. the Poseidon2 permutation) are built from, so comparing
a kernel with its plain version never launches a kernel.
"""

from __future__ import annotations

import torch

P = (1 << 31) - 1

_OPS = {"add": 0, "sub": 1, "mul": 2}


# ============================================================================
# Plain torch versions (the CPU path and the kernels' references)
# ============================================================================


def add_plain(a, b):
    s = a + b
    return torch.where(s >= P, s - P, s)


def sub_plain(a, b):
    d = a - b
    return torch.where(d < 0, d + P, d)


def mul_plain(a, b):
    """One 62-bit product, one Mersenne fold, one conditional subtract:
    x = hi * 2^31 + lo = hi + lo (mod p), and hi + lo < 2p."""
    x = a * b
    r = (x & P) + (x >> 31)
    return torch.where(r >= P, r - P, r)


# ============================================================================
# Dispatching entry points
# ============================================================================


def _binary(a, b, op: str):
    """``a`` or ``b`` may be a Python int (a field constant)."""
    ta = a if isinstance(a, torch.Tensor) else b
    if ta.is_cuda or (isinstance(b, torch.Tensor) and b.is_cuda):
        return _binary_cuda(a, b, op)
    return {"add": add_plain, "sub": sub_plain, "mul": mul_plain}[op](a, b)


def _binary_cuda(a, b, op: str):
    """K1: one launch over the broadcast shape.  The kernel takes equal-
    length contiguous int64 words, so operands are expanded here."""
    from .. import _kernels

    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"M31 words must be int64, got {a.dtype}, {b.dtype}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape).contiguous()
    b = b.expand(shape).contiguous()
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if out.numel():
        _kernels.launch("m31_binary", a.data_ptr(), b.data_ptr(),
                        out.data_ptr(), out.numel(), _OPS[op])
    return out


def m31_add(a, b):
    """Field addition (canonical inputs)."""
    return _binary(a, b, "add")


def m31_sub(a, b):
    """Field subtraction (canonical inputs)."""
    return _binary(a, b, "sub")


def m31_mul(a, b):
    """Field multiplication (canonical inputs)."""
    return _binary(a, b, "mul")


def m31_neg(a):
    return torch.where(a == 0, a, P - a)


def m31_pow(a, exp: int):
    """Elementwise a^exp for a static integer exponent (square-and-multiply)."""
    result = torch.ones_like(a)
    base = a
    e = int(exp)
    while e > 0:
        if e & 1:
            result = m31_mul(result, base)
        base = m31_mul(base, base)
        e >>= 1
    return result


def m31_pow2(a, k: int):
    """a^(2^k) by repeated squaring."""
    for _ in range(k):
        a = m31_mul(a, a)
    return a


def m31_inv(a):
    """Elementwise inversion via Fermat, a^(p-2) = a^(2^31 - 3), with the
    reference's 37-multiplication addition chain.  0 maps to 0."""
    x = a
    x3 = m31_mul(m31_mul(x, x), x)            # a^3
    t2 = x3                                   # a^(2^2 - 1)
    t4 = m31_mul(m31_pow2(t2, 2), t2)         # a^(2^4 - 1)
    t8 = m31_mul(m31_pow2(t4, 4), t4)         # a^(2^8 - 1)
    t16 = m31_mul(m31_pow2(t8, 8), t8)        # a^(2^16 - 1)
    t24 = m31_mul(m31_pow2(t16, 8), t8)       # a^(2^24 - 1)
    t28 = m31_mul(m31_pow2(t24, 4), t4)       # a^(2^28 - 1)
    t29 = m31_mul(m31_pow2(t28, 1), x)        # a^(2^29 - 1)
    return m31_mul(m31_pow2(t29, 2), x)


def m31_batch_inv(a):
    """Inverse of every element, zero mapping to zero.

    The reference runs a Montgomery product chain over the leading axis
    (reshaping long 1-D inputs to [steps, 2048]); that choice only sets
    its schedule.  Inverses are unique, so an elementwise Fermat
    inversion, which is fully parallel, gives the same words (and
    0^(p-2) = 0 gives the zero rule)."""
    return m31_inv(a)
