// Device helpers of the generated quotient kernels
// (zkir_tpu_torch/prover/quotient_codegen.py writes one `quotient_part_kernel`
// per part of the constraint terms; each includes this header).
//
// Replaces the reference's jitted quotient, `_quotient_kernel` and
// `_quotient_parts_eval` with `_accumulate_quotient`
// (zkir_tpu/prover/constraints.py): one thread per point of the coset LDE
// domain evaluates its part's terms C_j in registers, accumulates
// alpha^j C_j per divisor tag, multiplies each tag's sum by that tag's
// 1/Z(x) and adds the part's QM31 result into the output.  What bounds the
// function is the bytes of its columns (one int64 word per column and
// point, each read once) or the integer instructions of its terms; the
// split into parts adds a re-read of every column that two parts share.
//
// A part's table holds, in order: one device pointer per column it reads
// (a row of int64 words), the challenge-derived constants it uses, then
// four words of alpha^j per term.  It is the kernel's parameter (a few KB;
// CUDA 12.1 and later take up to 32,764 bytes), so every word of it is a
// constant-bank operand: no load, no register, the same for all threads.
#pragma once

#include <stdint.h>
#include <string.h>

#include "m31.cuh"

template <int NW>
struct qp_table {
    int64_t w[NW];
};

// a b + c d and a b - c d, reduced once (each product < 2^62, the sum <
// 2^63: m31_reduce63's range).
__device__ __forceinline__ uint32_t m31_dot(uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
    return m31_reduce63((uint64_t)a * b + (uint64_t)c * d);
}

__device__ __forceinline__ uint32_t m31_dotn(uint32_t a, uint32_t b, uint32_t c,
                                             uint32_t d) {
    return m31_reduce63((uint64_t)a * b + (uint64_t)(M31_P - c) * d);
}

// The word at point `idx` (the point itself, or the next trace row's
// point for a `nxt` read) of the column whose address is table word k.
template <int NW>
__device__ __forceinline__ uint32_t qp_leaf(const qp_table<NW>& tab, int k,
                                            long long idx) {
    return (uint32_t)(reinterpret_cast<const int64_t*>(tab.w[k]))[idx];
}

// Table words k, k + 1 as a CM31 value.
template <int NW>
__device__ __forceinline__ cm31 qp_pair(const qp_table<NW>& tab, int k) {
    return {(uint32_t)tab.w[k], (uint32_t)tab.w[k + 1]};
}

// R c for R = u^2 = 2 + i: (2 re - im, re + 2 im).
__device__ __forceinline__ cm31 cm31_times_r(cm31 c) {
    return {m31_sub(m31_add(c.re, c.re), c.im),
            m31_add(c.re, m31_add(c.im, c.im))};
}

// One divisor tag's running sum a + b u of alpha^j C_j.
struct qacc {
    cm31 a, b;
};

// acc += t (pa + pb u) for a CM31 term t and its alpha power pa + pb u.
__device__ __forceinline__ void qp_acc2(qacc& acc, cm31 t, cm31 pa, cm31 pb) {
    acc.a = cm31_add(acc.a, cm31_mul(t, pa));
    acc.b = cm31_add(acc.b, cm31_mul(t, pb));
}

// acc += (a + b u)(pa + pb u) = (a pa + R b pb) + (a pb + b pa) u.
__device__ __forceinline__ void qp_acc4(qacc& acc, cm31 a, cm31 b, cm31 pa,
                                        cm31 pb) {
    acc.a = cm31_add(acc.a, cm31_add(cm31_mul(a, pa),
                                     cm31_times_r(cm31_mul(b, pb))));
    acc.b = cm31_add(acc.b, cm31_add(cm31_mul(a, pb), cm31_mul(b, pa)));
}

// r += acc (dr + di i): one tag's sum times its 1/Z at this point, where
// `dinv` holds the tag's real and imaginary rows.
__device__ __forceinline__ void qp_divide(qacc& r, const qacc& acc,
                                          const int64_t* __restrict__ dinv,
                                          long long n, long long i) {
    const cm31 d = {(uint32_t)dinv[i], (uint32_t)dinv[n + i]};
    r.a = cm31_add(r.a, cm31_mul(acc.a, d));
    r.b = cm31_add(r.b, cm31_mul(acc.b, d));
}

// out[:, i] = r, or out[:, i] += r after the first part; out is [4, n]
// int64 (a.re, a.im, b.re, b.im).
__device__ __forceinline__ void qp_store(int64_t* __restrict__ out,
                                         const qacc& r, long long n,
                                         long long i, int accumulate) {
    uint32_t w[4] = {r.a.re, r.a.im, r.b.re, r.b.im};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const long long at = k * n + i;
        out[at] = accumulate ? m31_add((uint32_t)out[at], w[k]) : w[k];
    }
}
