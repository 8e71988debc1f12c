"""Elementwise Mersenne-31 field arithmetic on torch tensors.

Counterpart of ``zkir_tpu/ops/field_ops.py``.  Canonical M31 words are
``torch.int64`` tensors with values in [0, p): an M31 x M31 product
(< 2^62) is exact in int64 and ``a + b`` cannot overflow, while torch's
``uint32`` has no ``+``, ``>>`` or ``>=`` on the CPU.  Words are cast to
``uint32``/numpy only at the proof boundary.

Dispatch: for tensors on a GPU ``m31_add``/``m31_sub``/``m31_mul`` launch
the CUDA kernel K1 (``csrc/m31_binary.cu``, entry point ``m31_binary``) and
``cm31_binary`` launches its CM31 entry point (one launch for a whole
complex product, sum or difference); for tensors on the CPU they run the
plain torch versions (``add_plain``/``sub_plain``/``mul_plain`` and their
CM31 compositions).  The kernel takes each operand as a pointer with the
strides of the broadcast-collapsed shape, or as an immediate, so nothing
is expanded, filled or made contiguous before a launch
(``binary_descriptor``).  The plain versions are also what the other
modules' plain references (e.g. the Poseidon2 permutation) are built from,
so comparing a kernel with its plain version never launches a kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

P = (1 << 31) - 1

_OPS = {"add": 0, "sub": 1, "mul": 2}


# ============================================================================
# Plain torch versions (the CPU path and the kernels' references)
# ============================================================================


def add_plain(a, b):
    return (a + b) % P


def sub_plain(a, b):
    """a - b mod p (torch's ``%`` takes the divisor's sign)."""
    return (a - b) % P


def mul_plain(a, b):
    """One 62-bit product reduced mod p."""
    return a * b % P


def m31_inv_plain(a):
    """``m31_inv`` over ``mul_plain``: a^(p - 2) by the same addition
    chain of 38 products, in plain torch (no K1 launch).  0 maps to 0."""
    def sq(x, k):
        for _ in range(k):
            x = mul_plain(x, x)
        return x

    x3 = mul_plain(sq(a, 1), a)                  # a^(2^2 - 1)
    t4 = mul_plain(sq(x3, 2), x3)                # a^(2^4 - 1)
    t8 = mul_plain(sq(t4, 4), t4)                # a^(2^8 - 1)
    t16 = mul_plain(sq(t8, 8), t8)               # a^(2^16 - 1)
    t24 = mul_plain(sq(t16, 8), t8)              # a^(2^24 - 1)
    t28 = mul_plain(sq(t24, 4), t4)              # a^(2^28 - 1)
    t29 = mul_plain(sq(t28, 1), a)               # a^(2^29 - 1)
    return mul_plain(sq(t29, 2), a)


def cm31_mul_plain(a, b):
    """(ar br - ai bi, ar bi + ai br): each coordinate two 62-bit
    products summed (below 2^63, the negated one as (p - ai) bi) and
    reduced once."""
    ar, ai = a
    br, bi = b
    return ((ar * br + (P - ai) * bi) % P, (ar * bi + ai * br) % P)


def cm31_add_plain(a, b):
    return (add_plain(a[0], b[0]), add_plain(a[1], b[1]))


def cm31_sub_plain(a, b):
    return (sub_plain(a[0], b[0]), sub_plain(a[1], b[1]))


_PLAIN = {"add": add_plain, "sub": sub_plain, "mul": mul_plain}
_CM31_PLAIN = {"add": cm31_add_plain, "sub": cm31_sub_plain,
               "mul": cm31_mul_plain}


# ============================================================================
# Operand layouts for the kernel
# ============================================================================

MAX_RANK = 4   # the kernel's index arithmetic (csrc/m31_binary.cu)
_UNIT = (0, 0, 0, 1)   # rank-1 strides of a contiguous tensor
_ZERO = (0, 0, 0, 0)   # and of an immediate


def collapse(shape, strides):
    """Collapse a broadcast ``shape`` for operands whose expanded element
    strides are ``strides`` (one tuple per operand, 0 on a broadcast
    axis): axes of size 1 go, and neighbouring axes merge wherever every
    operand walks them as one (outer stride = inner stride * inner size;
    the contiguous output always does).  Returns ``(shape, strides)``
    padded in front to ``MAX_RANK``; raises ``ValueError`` where more axes
    remain, rather than copying an operand."""
    dims = []
    for d, n in enumerate(shape):
        if n == 1:
            continue
        st = [s[d] for s in strides]
        if dims and all(ps == cs * n for ps, cs in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > MAX_RANK:
        raise ValueError(
            f"operands of shape {tuple(shape)} with strides "
            f"{[tuple(s) for s in strides]} need rank {len(dims)} > "
            f"{MAX_RANK} after collapsing; make one contiguous first")
    pad = MAX_RANK - len(dims)
    out_shape = (1,) * pad + tuple(n for n, _ in dims)
    out_strides = tuple((0,) * pad + tuple(st[k] for _, st in dims)
                        for k in range(len(strides)))
    return out_shape, out_strides


def binary_descriptor(operands):
    """What one launch of K1 is told about ``operands`` (each an int64
    tensor or a Python int): ``(shape, strides, immediates, vec,
    out_shape)``.  ``shape``/``strides`` are the collapsed rank-4 layout
    (all-zero strides for an immediate), ``immediates`` the canonical
    constants (0 for a tensor), ``vec`` 2 where every operand allows two
    neighbouring words per thread (per tensor an inner stride of 0, or of
    1 with a 16-byte aligned pointer and even outer strides; an even
    inner size, or a rank-1 layout, whose odd last word the kernel takes
    alone), else 1."""
    first = None
    same = True       # every tensor contiguous and of one shape
    for x in operands:
        if isinstance(x, torch.Tensor):
            if first is None:
                first = x
            elif x.device != first.device:
                raise ValueError(f"operands on {first.device} and {x.device}")
            if x.dtype is not torch.int64:
                raise TypeError(f"M31 words must be int64, got {x.dtype}")
            if same and not (x.shape == first.shape and x.is_contiguous()):
                same = False
    if first is None:
        raise TypeError("at least one operand must be a tensor")
    if same:          # the common case, kept off the general path below
        out_shape = first.shape
        shape = (1, 1, 1, first.numel())
        strides = tuple(_UNIT if isinstance(x, torch.Tensor) else _ZERO
                        for x in operands)
    else:
        out_shape = torch.broadcast_shapes(
            *(x.shape for x in operands if isinstance(x, torch.Tensor)))
        zero = (0,) * len(out_shape)
        shape, strides = collapse(
            out_shape,
            [x.expand(out_shape).stride() if isinstance(x, torch.Tensor)
             else zero for x in operands])
    flat = shape[0] == shape[1] == shape[2] == 1
    vec = 2 if shape[3] > 1 and (flat or shape[3] % 2 == 0) else 1
    for x, st in zip(operands, strides):
        if vec == 2 and isinstance(x, torch.Tensor) and st[3] != 0 and (
                st[3] != 1 or x.data_ptr() % 16
                or st[0] % 2 or st[1] % 2 or st[2] % 2):
            vec = 1
    imms = tuple(0 if isinstance(x, torch.Tensor) else int(x) % P
                 for x in operands)
    return shape, strides, imms, vec, out_shape


@functools.lru_cache(maxsize=4096)
def _host_descriptor(shape, strides, imms, vec):
    """The descriptor as the C entry points read it (csrc/m31_binary.cu);
    cached, since a prove repeats few distinct layouts many times."""
    words = [*shape, *(s for st in strides for s in st), *imms, vec]
    return (ctypes.c_longlong * len(words))(*words)


def _launch(name, operands, n_out, op):
    from .. import _kernels

    shape, strides, imms, vec, out_shape = binary_descriptor(operands)
    first = next(x for x in operands if isinstance(x, torch.Tensor))
    if first.shape == out_shape and first.is_contiguous():
        outs = tuple(torch.empty_like(first) for _ in range(n_out))
    else:
        outs = tuple(torch.empty(out_shape, dtype=torch.int64,
                                 device=first.device) for _ in range(n_out))
    if outs[0].numel():
        _kernels.launch(
            name,
            *[x.data_ptr() if isinstance(x, torch.Tensor) else None
              for x in operands],
            *[o.data_ptr() for o in outs],
            _host_descriptor(shape, strides, imms, vec), _OPS[op])
    return outs


# ============================================================================
# Dispatching entry points
# ============================================================================


def _any_cuda(*operands):
    for x in operands:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return True
    return False


def _binary(a, b, op: str):
    """``a`` or ``b`` may be a Python int (a field constant)."""
    if _any_cuda(a, b):
        return _binary_cuda(a, b, op)
    return _PLAIN[op](a, b)


def _binary_cuda(a, b, op: str):
    """K1, entry point ``m31_binary``: one launch over the broadcast shape,
    each operand by pointer and strides or as an immediate."""
    return _launch("m31_binary", (a, b), 1, op)[0]


def cm31_binary(a, b, op: str):
    """``a op b`` over CM31 for ``(re, im)`` pairs whose coordinates are
    int64 tensors or Python ints (a constant pair); ``op`` is ``"add"``,
    ``"sub"`` or ``"mul"``.  On a GPU one launch of K1's entry point
    ``cm31_binary`` computes both coordinates."""
    if _any_cuda(*a, *b):
        return _launch("cm31_binary", (*a, *b), 2, op)
    return _CM31_PLAIN[op](a, b)


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
