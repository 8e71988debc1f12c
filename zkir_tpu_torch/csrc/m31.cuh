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

__device__ __forceinline__ cm31 cm31_mul(cm31 a, cm31 b) {
    return {m31_sub(m31_mul(a.re, b.re), m31_mul(a.im, b.im)),
            m31_add(m31_mul(a.re, b.im), m31_mul(a.im, b.re))};
}
