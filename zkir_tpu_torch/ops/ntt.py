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
evaluations in the same order.  The butterflies' products and sums go
through the field layer, so on a GPU they are K1 launches.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..spec.field import M31_PRIME, m31_inv as s_inv
from .field_ops import m31_add, m31_mul, m31_sub

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
    """Host tables as int64 tensors, made once per (table, device)."""
    kind, args = key
    if kind == "stage":                  # twiddles of one butterfly stage
        log_n, inverse, m = args
        twr, twi = _twiddle_table(log_n, inverse)
        stride = (1 << log_n) // (2 * m)
        pair = (twr[::stride][:m], twi[::stride][:m])
    elif kind == "bitrev":
        return torch.from_numpy(_bitrev(args)).to(device)
    else:                                # "shift": powers of a coset shift
        pair = _shift_powers(*args)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in pair)


# ============================================================================
# Vectorized CM31 arithmetic
# ============================================================================


def cm31_mul(a, b):
    ar, ai = a
    br, bi = b
    return (
        m31_sub(m31_mul(ar, br), m31_mul(ai, bi)),
        m31_add(m31_mul(ar, bi), m31_mul(ai, br)),
    )


def cm31_add(a, b):
    return (m31_add(a[0], b[0]), m31_add(a[1], b[1]))


def cm31_sub(a, b):
    return (m31_sub(a[0], b[0]), m31_sub(a[1], b[1]))


# ============================================================================
# NTT
# ============================================================================


def _ntt_core(re, im, log_n: int, inverse: bool):
    """NTT over the last axis (size 2^log_n), arbitrary leading batch."""
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
        ur, ui = re_b[..., 0, :], im_b[..., 0, :]
        vr, vi = cm31_mul((re_b[..., 1, :], im_b[..., 1, :]), tw)
        re = torch.stack([m31_add(ur, vr), m31_sub(ur, vr)],
                         dim=-2).reshape(*batch, n)
        im = torch.stack([m31_add(ui, vi), m31_sub(ui, vi)],
                         dim=-2).reshape(*batch, n)
        m = m2
    return re, im


def ntt(re, im, log_n: int):
    """Forward NTT (coefficients -> evaluations on the 2^log_n subgroup)."""
    return _ntt_core(re, im, log_n, inverse=False)


def intt(re, im, log_n: int):
    """Inverse NTT (evaluations -> coefficients)."""
    out_r, out_i = _ntt_core(re, im, log_n, inverse=True)
    n_inv = s_inv(1 << log_n)
    return m31_mul(out_r, n_inv), m31_mul(out_i, n_inv)


def _times_shift_powers(re, im, shift, log_n: int):
    return cm31_mul((re, im), _on_device(("shift", (tuple(shift), log_n)),
                                         re.device))


def lde(re, im, log_n: int, log_blowup: int,
        shift: Tuple[int, int] = (1, 0)):
    """Low-degree extension: evaluations on the size-2^log_n subgroup ->
    evaluations on the coset ``shift * <w>`` of the size-2^(log_n +
    log_blowup) subgroup."""
    coef_r, coef_i = intt(re, im, log_n)
    pad = (0, (1 << (log_n + log_blowup)) - (1 << log_n))
    coef_r = torch.nn.functional.pad(coef_r, pad)
    coef_i = torch.nn.functional.pad(coef_i, pad)
    if tuple(shift) != (1, 0):
        coef_r, coef_i = _times_shift_powers(coef_r, coef_i, shift,
                                             log_n + log_blowup)
    return ntt(coef_r, coef_i, log_n + log_blowup)


def coset_ntt(re, im, log_n: int, shift: Tuple[int, int] = (1, 0)):
    """Coefficients -> evaluations on the coset ``shift * <w>``:
    NTT of (coeff_i * shift^i)."""
    if tuple(shift) != (1, 0):
        re, im = _times_shift_powers(re, im, shift, log_n)
    return ntt(re, im, log_n)


def coset_intt(re, im, log_n: int, shift: Tuple[int, int] = (1, 0)):
    """Evaluations on the coset ``shift * <w>`` -> coefficients:
    iNTT then divide coeff_i by shift^i."""
    coef_r, coef_i = intt(re, im, log_n)
    if tuple(shift) != (1, 0):
        coef_r, coef_i = _times_shift_powers(
            coef_r, coef_i, cm31_inv_scalar(tuple(shift)), log_n)
    return coef_r, coef_i
