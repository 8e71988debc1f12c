// Device helpers of the generated quotient kernels
// (zkir_tpu_torch/prover/quotient_codegen.py writes one `quotient_part_kernel`
// per part of the constraint terms; each defines QP_TILE, QP_SHIFT and
// QP_SLOTS and then includes this header).
//
// Replaces the reference's jitted quotient, `_quotient_kernel` and
// `_quotient_parts_eval` with `_accumulate_quotient`
// (zkir_tpu/prover/constraints.py).  A CTA owns QP_TILE consecutive points
// of the coset LDE domain, one a thread, and computes one part of the terms
// there: alpha^j C_j accumulated per divisor tag in registers, each tag's
// sum times that tag's 1/Z(x); every part but the last stores its QM31 sum
// into its own rows of partial sums, and the last adds them to its own and
// writes the result.  What bounds the function is the bytes of its columns
// (one int64 word per column and point, each read once) or the integer
// instructions of its terms.  The design's answer: the columns are staged
// in shared memory as 32-bit words (the low half of each int64 word: every
// word is < 2^31) by asynchronous copies, a stage's copies in flight while
// the stage before computes, and every read of a column is a shared-memory
// load, so no column value has to stay live in a register.  Parts stay
// small because straight-line code runs fast only while it stays in the
// SM's instruction cache.
//
// A slot is one column over the tile plus the next trace row's points
// (QP_SHIFT = 2^log_blowup more): QP_SPAN 32-bit words.  The last tile's
// extra points wrap to point 0, as the next row of the domain's last row
// does.
//
// A part's table holds one device pointer per column it reads (a row of
// int64 words), then its challenge-derived constants and four words of
// alpha^j per term.  It is the kernel's parameter (CUDA 12.1 and later
// take up to 32,764 bytes), so every word of it is a constant-bank
// operand: no load, no register, the same for all threads.
#pragma once

#include <stdint.h>
#include <string.h>

#include "m31.cuh"

#define QP_SPAN (QP_TILE + QP_SHIFT)

template <int NC, int NW>
struct qp_table {
    const int64_t* c[NC];
    uint32_t w[NW];
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

// The primitives of the staging, the only inline assembly here: a
// 4-byte asynchronous copy from device to shared memory where `pred`
// holds (the low half of an int64 word, little-endian), the end of this
// thread's group of copies, and the wait until at most N of its groups
// are still in flight.  A wait is followed by __syncthreads() before any
// thread reads what another thread's copies wrote.
__device__ __forceinline__ void qp_cp4(uint32_t* dst, const int64_t* src,
                                       bool pred) {
    const uint32_t to = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
        " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n"
        :: "r"(to), "l"(src), "r"((int)pred) : "memory");
}

__device__ __forceinline__ void qp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void qp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage one column (its int64 row `col`) for the tile at `base` into the
// slot at `dst`: point base + t to word t, one word a thread.
__device__ __forceinline__ void qp_copy(uint32_t* dst, const int64_t* col,
                                        long long base, long long n, int t) {
    qp_cp4(dst + t, col + ((base + t) & (n - 1)), true);
}

// The slot's last QP_SHIFT words: the next trace row's points of the
// tile's last row, point base + QP_TILE + t (mod n: the last tile wraps
// to point 0) to word QP_TILE + t, for the threads t < QP_SHIFT.
__device__ __forceinline__ void qp_halo(uint32_t* dst, const int64_t* col,
                                        long long base, long long n, int t) {
    qp_cp4(dst + QP_TILE + t, col + ((base + QP_TILE + t) & (n - 1)),
           t < QP_SHIFT);
}

// Table words k, k + 1 as a CM31 value.
template <int NC, int NW>
__device__ __forceinline__ cm31 qp_pair(const qp_table<NC, NW>& tab, int k) {
    return {tab.w[k], tab.w[k + 1]};
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

// acc + a b + c d, reduced once (acc < 2^32 and each product < 2^62: the
// sum is below 2^63).
__device__ __forceinline__ uint32_t m31_mac(uint32_t acc, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
    return m31_reduce63((uint64_t)a * b + (uint64_t)c * d + acc);
}

// acc += t (pa + pb u) for a CM31 term t and its alpha power pa + pb u:
// each of the four words one m31_mac.
__device__ __forceinline__ void qp_acc2(qacc& acc, cm31 t, cm31 pa, cm31 pb) {
    const uint32_t nim = M31_P - t.im;
    acc.a = {m31_mac(acc.a.re, t.re, pa.re, nim, pa.im),
             m31_mac(acc.a.im, t.re, pa.im, t.im, pa.re)};
    acc.b = {m31_mac(acc.b.re, t.re, pb.re, nim, pb.im),
             m31_mac(acc.b.im, t.re, pb.im, t.im, pb.re)};
}

// acc += (a + b u)(pa + pb u) = (a pa + R b pb) + (a pb + b pa) u.
__device__ __forceinline__ void qp_acc4(qacc& acc, cm31 a, cm31 b, cm31 pa,
                                        cm31 pb) {
    const cm31 rb = cm31_times_r(cm31_mul(b, pb));
    const uint32_t nai = M31_P - a.im;
    const uint32_t nbi = M31_P - b.im;
    acc.a = {m31_mac(m31_add(acc.a.re, rb.re), a.re, pa.re, nai, pa.im),
             m31_mac(m31_add(acc.a.im, rb.im), a.re, pa.im, a.im, pa.re)};
    acc.b = {m31_mac(m31_mac(acc.b.re, a.re, pb.re, nai, pb.im), b.re, pa.re,
                     nbi, pa.im),
             m31_mac(m31_mac(acc.b.im, a.re, pb.im, a.im, pb.re), b.re, pa.im,
                     b.im, pa.re)};
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

// A part's sum r at point i, as QM31 words (a.re, a.im, b.re, b.im).  Every
// part but the last stores it into block `part` of the [parts - 1, 4, n]
// partial sums, its own, so no part reads another's while it runs.  The last
// (`out` not null, launched after the others on their stream) adds the
// `part` blocks before it to its own sum and writes the result, each word
// reduced once (at most 2^32 words < p: the sum is below 2^63).  The loop
// is unrolled so that a thread's loads of several parts are in flight at
// once.
__device__ __forceinline__ void qp_finish(uint32_t* __restrict__ partial,
                                          int64_t* __restrict__ out, int part,
                                          const qacc& r, long long n,
                                          long long i) {
    if (out == nullptr) {
        partial[(long long)part * 4 * n + i] = r.a.re;
        partial[(long long)part * 4 * n + n + i] = r.a.im;
        partial[(long long)part * 4 * n + 2 * n + i] = r.b.re;
        partial[(long long)part * 4 * n + 3 * n + i] = r.b.im;
        return;
    }
    uint64_t s0 = r.a.re;
    uint64_t s1 = r.a.im;
    uint64_t s2 = r.b.re;
    uint64_t s3 = r.b.im;
#pragma unroll 8
    for (int p = 0; p < part; ++p) {
        s0 = s0 + partial[(long long)p * 4 * n + i];
        s1 = s1 + partial[(long long)p * 4 * n + n + i];
        s2 = s2 + partial[(long long)p * 4 * n + 2 * n + i];
        s3 = s3 + partial[(long long)p * 4 * n + 3 * n + i];
    }
    out[i] = m31_reduce63(s0);
    out[n + i] = m31_reduce63(s1);
    out[2 * n + i] = m31_reduce63(s2);
    out[3 * n + i] = m31_reduce63(s3);
}
