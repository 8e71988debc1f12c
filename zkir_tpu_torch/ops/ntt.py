"""Radix-2 NTT over the CM31 complex extension of Mersenne-31, in torch.

Counterpart of ``zkir_tpu/ops/ntt.py``.  M31 has 2-adicity 1, so the
transforms run over CM31 = M31[i] (i^2 = -1), whose multiplicative group
has a 2-adic subgroup of size 2^31.  CM31 arrays are ``(re, im)`` pairs
of int64 tensors of canonical words, batched on the leading axes and
transformed along the last.

The host scalar helpers (twiddles, bit reversal, shift powers, the
group generator) are copies of the reference's.  The transform itself
is an iterative bit-reversal + Cooley-Tukey network: the reference
switches to a four-step split at 2^10 (``_FOUR_STEP_MIN``) to keep the
TPU's lane axis wide, which a GPU does not need; both give the same
evaluations in the same order.

``cm31_ntt`` is the one transform under every public function, with
their edges as options: an input shorter than n reads as zero beyond its
length (the LDE's padding), ``im`` may be ``None`` (real input), ``pre``
and ``post`` multiply input/output i by a CM31 scalar's i-th power (the
coset shift), ``scale`` multiplies every output (1/n).  Tensors on a GPU
take the CUDA kernel ``cm31_ntt`` (``csrc/ntt.cu``): each public
function is one call of it (``lde`` two), and no padded, zero or shifted
copy of the array is made.  Tensors on the CPU take ``ntt_plain``, the
torch network with the same signature.  ``cm31_mul``/``cm31_add``/
``cm31_sub`` are one launch each of K1's CM31 entry point on a GPU.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..spec.field import M31_PRIME, m31_inv as s_inv
from .field_ops import (cm31_add_plain, cm31_binary, cm31_mul_plain,
                        cm31_sub_plain, mul_plain)

P = M31_PRIME

# ============================================================================
# Scalar CM31 helpers (host, Python ints) for twiddle generation
# ============================================================================


def cm31_mul_scalar(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    """CM31 product of host scalar pairs."""
    ar, ai = a
    br, bi = b
    return ((ar * br - ai * bi) % P, (ar * bi + ai * br) % P)


def cm31_pow_scalar(a: Tuple[int, int], exp: int) -> Tuple[int, int]:
    result = (1, 0)
    base = a
    while exp > 0:
        if exp & 1:
            result = cm31_mul_scalar(result, base)
        base = cm31_mul_scalar(base, base)
        exp >>= 1
    return result


def cm31_inv_scalar(a: Tuple[int, int]) -> Tuple[int, int]:
    ar, ai = a
    norm = (ar * ar + ai * ai) % P
    ninv = s_inv(norm)
    return ((ar * ninv) % P, ((P - ai) * ninv) % P)


@functools.lru_cache(maxsize=1)
def _find_generator() -> Tuple[int, int]:
    """Element of CM31* of maximal order p^2 - 1.

    p^2 - 1 = 2^32 * 3^2 * 7 * 11 * 31 * 151 * 331."""
    order = P * P - 1
    prime_factors = [2, 3, 7, 11, 31, 151, 331]
    candidate = 2
    while True:
        for g in [(candidate, 1), (1, candidate), (candidate, candidate - 1)]:
            if all(
                cm31_pow_scalar(g, order // q) != (1, 0)
                for q in prime_factors
            ):
                return g
        candidate += 1


@functools.lru_cache(maxsize=None)
def root_of_unity(log_n: int) -> Tuple[int, int]:
    """Primitive 2^log_n-th root of unity in CM31 (log_n <= 31)."""
    assert 0 <= log_n <= 31
    g = _find_generator()
    order = P * P - 1
    return cm31_pow_scalar(g, order >> log_n)


@functools.lru_cache(maxsize=None)
def _twiddle_table(log_n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Powers w^0 .. w^(n-1) (numpy uint32 pair), built by doubling:
    log n vectorized steps instead of n scalar multiplications."""
    w = root_of_unity(log_n)
    if inverse:
        w = cm31_inv_scalar(w)
    re = np.ones(1, dtype=np.uint64)
    im = np.zeros(1, dtype=np.uint64)
    # Doubling construction: powers[0:2^k] known, append powers * w^(2^k).
    cur = w
    for _ in range(log_n):
        cr, ci = cur
        new_re = (re * cr + (P - im) * ci) % P  # re*cr - im*ci
        new_im = (re * ci + im * cr) % P
        re = np.concatenate([re, new_re])
        im = np.concatenate([im, new_im])
        cur = cm31_mul_scalar(cur, cur)
    return re.astype(np.uint32), im.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _bitrev(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _shift_powers(shift: Tuple[int, int], log_n: int):
    """(shift^0 .. shift^(n-1)) as numpy uint32 pairs, by doubling."""
    re = np.ones(1, dtype=np.uint64)
    im = np.zeros(1, dtype=np.uint64)
    cur = shift
    for _ in range(log_n):
        cr, ci = cur
        new_re = (re * cr + (P - im) * ci) % P
        new_im = (re * ci + im * cr) % P
        re = np.concatenate([re, new_re])
        im = np.concatenate([im, new_im])
        cur = cm31_mul_scalar(cur, cur)
    return re.astype(np.uint32), im.astype(np.uint32)


def domain_points(log_n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The evaluation domain w^0..w^(n-1) as numpy uint32 pairs."""
    return _twiddle_table(log_n, inverse=False)


@functools.lru_cache(maxsize=None)
def _on_device(key, device):
    """Host tables as tensors, made once per (table, device): int64 pairs
    for the torch code, or one int32 [len, 2] tensor of (re, im) uint32
    bit patterns for the CUDA kernel."""
    kind, args = key
    if kind == "stage":                  # twiddles of one butterfly stage
        log_n, inverse, m = args
        twr, twi = _twiddle_table(log_n, inverse)
        stride = (1 << log_n) // (2 * m)
        pair = (twr[::stride][:m], twi[::stride][:m])
    elif kind == "bitrev":
        return torch.from_numpy(_bitrev(args)).to(device)
    elif kind == "twiddles_u32":         # w^0 .. w^(n/2 - 1)
        log_n, inverse = args
        twr, twi = _twiddle_table(log_n, inverse)
        half = (1 << log_n) // 2
        return _pairs_u32(twr[:half], twi[:half], device)
    elif kind == "shift_u32":
        return _pairs_u32(*_shift_powers(*args), device)
    else:                                # "shift": powers of a coset shift
        pair = _shift_powers(*args)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in pair)


def _pairs_u32(re, im, device):
    pairs = np.ascontiguousarray(np.stack([re, im], axis=1), dtype=np.uint32)
    return torch.from_numpy(pairs.view(np.int32)).to(device)


# ============================================================================
# Vectorized CM31 arithmetic
# ============================================================================


def cm31_mul(a, b):
    return cm31_binary(a, b, "mul")


def cm31_add(a, b):
    return cm31_binary(a, b, "add")


def cm31_sub(a, b):
    return cm31_binary(a, b, "sub")


def cm31_scale(a, c: int):
    """CM31 value times the M31 constant ``c``: on a GPU one launch with
    the immediate (c, 0); on the CPU one plain product per coordinate."""
    if a[0].is_cuda:
        return cm31_binary(a, (c, 0), "mul")
    return (mul_plain(a[0], c), mul_plain(a[1], c))


# ============================================================================
# NTT
# ============================================================================


def _ntt_core(re, im, log_n: int, inverse: bool):
    """Plain NTT over the last axis (size 2^log_n), arbitrary leading
    batch: the network the CUDA kernel is held against."""
    n = 1 << log_n
    rev = _on_device(("bitrev", log_n), re.device)
    re = re.index_select(-1, rev)
    im = im.index_select(-1, rev)
    batch = re.shape[:-1]
    m = 1
    for _ in range(log_n):
        m2 = m * 2
        tw = _on_device(("stage", (log_n, inverse, m)), re.device)
        re_b = re.reshape(*batch, n // m2, 2, m)
        im_b = im.reshape(*batch, n // m2, 2, m)
        u = (re_b[..., 0, :], im_b[..., 0, :])
        v = cm31_mul_plain((re_b[..., 1, :], im_b[..., 1, :]), tw)
        s, d = cm31_add_plain(u, v), cm31_sub_plain(u, v)
        re = torch.stack([s[0], d[0]], dim=-2).reshape(*batch, n)
        im = torch.stack([s[1], d[1]], dim=-2).reshape(*batch, n)
        m = m2
    return re, im


def ntt_plain(re, im, log_n: int, inverse: bool, pre=None, post=None,
              scale: int = 1):
    """The plain torch version of ``cm31_ntt`` (same signature)."""
    n, in_len = 1 << log_n, re.shape[-1]
    if im is None:
        im = torch.zeros_like(re)
    if pre is not None:
        tr, ti = _on_device(("shift", (tuple(pre), log_n)), re.device)
        re, im = cm31_mul_plain((re, im), (tr[:in_len], ti[:in_len]))
    if in_len < n:
        re = torch.nn.functional.pad(re, (0, n - in_len))
        im = torch.nn.functional.pad(im, (0, n - in_len))
    re, im = _ntt_core(re, im, log_n, inverse)
    if post is not None:
        re, im = cm31_mul_plain(
            (re, im), _on_device(("shift", (tuple(post), log_n)), re.device))
    if scale != 1:
        re, im = mul_plain(re, scale), mul_plain(im, scale)
    return re, im


def _rows(x, what: str):
    """The row stride, in words, of ``x`` seen as rows of unit inner
    stride.  The kernel reads [batch, in_len] through one row stride; any
    other layout raises rather than being copied quietly."""
    in_len = x.shape[-1]
    if x.is_contiguous() or x.dim() == 1 and (x.stride(0) == 1 or in_len == 1):
        return in_len
    if x.dim() == 2 and (x.stride(1) == 1 or in_len == 1):
        return x.stride(0)
    raise ValueError(f"cm31_ntt: {what} of shape {tuple(x.shape)} with "
                     f"strides {x.stride()} is not rows of unit stride")


def _out_pair(out, shape, device):
    """``out`` (a pair of contiguous int64 tensors of ``shape`` on
    ``device``, e.g. row slices of a larger matrix), or a new pair."""
    if out is None:
        re = torch.empty(shape, dtype=torch.int64, device=device)
        return re, torch.empty_like(re)
    for t in out:
        if t.dtype != torch.int64 or tuple(t.shape) != tuple(shape) \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"cm31_ntt: out must be contiguous int64 "
                             f"{tuple(shape)} on {device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return out


def _ntt_cuda(re, im, log_n: int, inverse: bool, pre=None, post=None,
              scale: int = 1, out=None):
    """One call of the CUDA kernel ``cm31_ntt`` (``csrc/ntt.cu``), into
    ``out`` where given (it must not overlap the input: the kernel keeps
    its passes' points in ``out``'s storage)."""
    from .. import _kernels

    n, in_len = 1 << log_n, re.shape[-1]
    if log_n < 1:
        raise ValueError("cm31_ntt on a GPU needs log_n >= 1")
    if re.dtype != torch.int64 or (im is not None and (
            im.dtype != torch.int64 or im.shape != re.shape
            or im.device != re.device)):
        raise TypeError("cm31_ntt takes int64 words, re and im of one shape "
                        "on one device")
    if not 0 < in_len <= n:
        raise ValueError(f"cm31_ntt: input length {in_len} not in (0, {n}]")
    row_stride = _rows(re, "re")
    if im is not None and _rows(im, "im") != row_stride:
        raise ValueError("cm31_ntt: re and im differ in row stride")
    device = re.device
    out_re, out_im = _out_pair(out, (*re.shape[:-1], n), device)
    if out is not None and any(
            o.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
            for o in out for x in (re, im) if x is not None):
        raise ValueError("cm31_ntt: out shares storage with the input")
    batch = out_re.numel() // n
    if batch:
        tw = _on_device(("twiddles_u32", (log_n, inverse)), device)
        tables = [None if sh is None else
                  _on_device(("shift_u32", (tuple(sh), log_n)), device)
                  for sh in (pre, post)]
        _kernels.launch(
            "cm31_ntt", re.data_ptr(),
            None if im is None else im.data_ptr(), row_stride, in_len,
            out_re.data_ptr(), out_im.data_ptr(), tw.data_ptr(),
            *(None if t is None else t.data_ptr() for t in tables),
            batch, log_n, int(scale) % P)
    return out_re, out_im


def cm31_ntt(re, im, log_n: int, inverse: bool, pre=None, post=None,
             scale: int = 1, out=None):
    """Radix-2 CM31 transform of ``re`` [+ i ``im``] over the last axis,
    natural order in and out: 2^log_n outputs from ``re.shape[-1]`` <=
    2^log_n inputs (the rest read as zero).  ``im`` may be ``None``.
    ``pre``/``post``: a CM31 scalar s (or ``None``); input/output i is
    multiplied by s^i.  ``scale``: an M31 constant on every output.
    ``out``: a pair of contiguous tensors of the output's shape that
    receive the result (a row slice of a larger matrix is one), apart
    from the input's storage."""
    if re.is_cuda:
        return _ntt_cuda(re, im, log_n, inverse, pre, post, scale, out)
    res = ntt_plain(re, im, log_n, inverse, pre, post, scale)
    if out is None:
        return res
    for o, r in zip(_out_pair(out, res[0].shape, res[0].device), res):
        o.copy_(r)
    return out


def _shift_or_none(shift):
    return None if tuple(shift) == (1, 0) else tuple(shift)


def ntt(re, im, log_n: int):
    """Forward NTT (coefficients -> evaluations on the 2^log_n subgroup)."""
    return cm31_ntt(re, im, log_n, inverse=False)


def intt(re, im, log_n: int):
    """Inverse NTT (evaluations -> coefficients)."""
    return cm31_ntt(re, im, log_n, inverse=True, scale=s_inv(1 << log_n))


def lde(re, im, log_n: int, log_blowup: int,
        shift: Tuple[int, int] = (1, 0)):
    """Low-degree extension: evaluations on the size-2^log_n subgroup ->
    evaluations on the coset ``shift * <w>`` of the size-2^(log_n +
    log_blowup) subgroup.  ``im`` may be ``None`` (real evaluations).
    The coefficients are not padded: the forward transform reads them as
    zero beyond 2^log_n."""
    coef_r, coef_i = intt(re, im, log_n)
    return cm31_ntt(coef_r, coef_i, log_n + log_blowup, inverse=False,
                    pre=_shift_or_none(shift))


def coset_ntt(re, im, log_n: int, shift: Tuple[int, int] = (1, 0),
              out=None):
    """Coefficients -> evaluations on the coset ``shift * <w>``:
    NTT of (coeff_i * shift^i), into ``out`` where given (``cm31_ntt``)."""
    return cm31_ntt(re, im, log_n, inverse=False, pre=_shift_or_none(shift),
                    out=out)


def coset_intt(re, im, log_n: int, shift: Tuple[int, int] = (1, 0)):
    """Evaluations on the coset ``shift * <w>`` -> coefficients:
    iNTT then divide coeff_i by shift^i."""
    post = _shift_or_none(shift)
    return cm31_ntt(re, im, log_n, inverse=True,
                    post=None if post is None else cm31_inv_scalar(post),
                    scale=s_inv(1 << log_n))
