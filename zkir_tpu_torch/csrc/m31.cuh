// Mersenne-31 (p = 2^31 - 1) and CM31 = M31[i]/(i^2 + 1) device arithmetic,
// shared by every kernel of the port.  Inputs and outputs are canonical
// words in [0, p).
//
// Replaces the TPU-only 16-bit-split product `m31_mul32`
// (zkir_tpu/ops/field_ops.py), which exists because the TPU's vector unit
// has no 64-bit integers.  CUDA has them: one 32x32->64 product, one
// Mersenne fold (2^31 = 1 mod p) and one conditional subtract.
#pragma once

#include <stdint.h>

#define M31_P 0x7fffffffu

__device__ __forceinline__ uint32_t m31_add(uint32_t a, uint32_t b) {
    uint32_t s = a + b;  // < 2^32 - 2: no wrap
    return s >= M31_P ? s - M31_P : s;
}

__device__ __forceinline__ uint32_t m31_sub(uint32_t a, uint32_t b) {
    return a >= b ? a - b : a + (M31_P - b);
}

__device__ __forceinline__ uint32_t m31_mul(uint32_t a, uint32_t b) {
    uint64_t x = (uint64_t)a * b;  // < 2^62
    // x = hi * 2^31 + lo = hi + lo (mod p); hi, lo < p so the sum is < 2p.
    uint32_t r = (uint32_t)(x & M31_P) + (uint32_t)(x >> 31);
    return r >= M31_P ? r - M31_P : r;
}

struct cm31 {
    uint32_t re, im;
};

__device__ __forceinline__ cm31 cm31_add(cm31 a, cm31 b) {
    return {m31_add(a.re, b.re), m31_add(a.im, b.im)};
}

__device__ __forceinline__ cm31 cm31_sub(cm31 a, cm31 b) {
    return {m31_sub(a.re, b.re), m31_sub(a.im, b.im)};
}

// x < 2^63 -> x mod p.  x = lo + 2^31 mid + 2^62 hi with 2^31 = 2^62 = 1
// (mod p): the three parts sum to at most 2p + 1 < 2^32, one more fold
// leaves at most p + 1, one conditional subtract makes it canonical.
__device__ __forceinline__ uint32_t m31_reduce63(uint64_t x) {
    uint32_t s = ((uint32_t)x & M31_P) + ((uint32_t)(x >> 31) & M31_P) +
                 (uint32_t)(x >> 62);
    s = (s & M31_P) + (s >> 31);
    return s >= M31_P ? s - M31_P : s;
}

// Each coordinate is a sum of two products of < 2^62, reduced once:
// re = a.re b.re + (p - a.im) b.im, im = a.re b.im + a.im b.re.
__device__ __forceinline__ cm31 cm31_mul(cm31 a, cm31 b) {
    uint64_t re = (uint64_t)a.re * b.re + (uint64_t)(M31_P - a.im) * b.im;
    uint64_t im = (uint64_t)a.re * b.im + (uint64_t)a.im * b.re;
    return {m31_reduce63(re), m31_reduce63(im)};
}
