// cm31_ntt: radix-2 (decimation in time) CM31 NTT over the last axis of int64 [B, n] word arrays,
// forward or inverse, natural order in and out, with the edges of `intt`,
// `lde`, `coset_ntt` and `coset_intt` fused in.
//
// Replaces, on the TPU side, the XLA transform of zkir_tpu/ops/ntt.py
// (`_ntt_core` with `_ntt_penult` and `_mid_twiddles`, and the elementwise
// passes of `intt`, `lde`, `coset_ntt`, `coset_intt`), whose butterflies are
// the products and sums of the Pallas kernel `_binary_pallas`
// (zkir_tpu/ops/field_ops.py).  Run stage by stage through the elementwise
// kernel, every one of the log n stages was a round trip of the whole array
// through device memory, ten launches and several copies each.
//
// Bound on the H100: memory, by the reckoning of one read and one write of
// the array.  What the design does about it:
//   - a block keeps a tile of 2^k points x T neighbouring columns in shared
//     memory as uint32 pairs and runs k butterfly stages there, two at a
//     time as radix-4 steps (three products where two radix-2 stages take
//     four, half the shared-memory traffic and barriers); n <= 2^12 is one
//     pass, larger sizes take ceil(log n / 9) passes (2^16: 8 + 8, 2^18:
//     9 + 9);
//   - the network is decimation in time over the bit-reversed input; the
//     bit reversal is index arithmetic in the first pass's loads (no
//     gather);
//   - the first pass owns stages 0..k-1, which pair points that lie 2^(log
//     n - k) apart in the input: it loads T neighbouring input columns per
//     point (T * 8 contiguous bytes) and writes runs of 2^k points; later
//     passes work on points 2^lo apart and tile over T neighbouring
//     positions, so loads and stores stay >= 32 contiguous bytes;
//   - between passes the points live as uint32 pairs (8 bytes, half the
//     int64 traffic) in the storage of the `out_re` tensor, which has
//     exactly 8 bytes per point: each block of a later pass reads all its
//     points into shared memory before it writes any, and blocks own
//     disjoint points, so the reuse is safe and no scratch is allocated;
//   - twiddles come from one table w^0..w^(n/2-1) per (log n, direction),
//     small enough to stay in L2; a stage's twiddle is table[j << shift];
//   - input beyond `in_len` reads as zero (the LDE's padding), `in_im` may
//     be null (real input), `pre[i]` multiplies input i on load, `post[i]`
//     and the scalar `scale` multiply output i on store: no padded, zero or
//     shifted copy of the array is ever made.
// Butterfly order cannot change a field result: the output equals the plain
// torch network word for word.
//
// Written in CUDA C++ rather than Triton: the stages need explicit shared-
// memory indexing with barriers and 64-bit integer products, and the kernel
// shares m31.cuh.
#include <cuda_runtime.h>

#include "m31.cuh"

// The two tile parameters can be set on nvcc's command line, and
// NTT_SKIP_STAGES compiles the butterflies out (wrong results: what is left
// is the passes' memory traffic); zkir_tpu_torch/tools/ntt_bench.py times
// such variants side by side.
#ifndef NTT_THREADS
#define NTT_THREADS 512
#endif
#ifndef NTT_TAU
#define NTT_TAU 4               // tiles of 2^4 columns: 128 contiguous bytes
#endif
#define NTT_SINGLE_PASS_MAX 12  // 2^12 points x 8 bytes = 32 KB of shared memory
#define NTT_PASS_LOG 9          // stages per pass when several are needed

struct NttArgs {
    const int64_t* in_re;  // [B, in_len] with row stride in_row_stride
    const int64_t* in_im;  // or null
    int64_t in_row_stride;
    int64_t in_len;
    uint2* mid;            // [B, n] uint32 pairs between passes (= out_re)
    int64_t* out_re;       // [B, n]
    int64_t* out_im;       // [B, n]
    const uint2* tw;       // w^0 .. w^(n/2 - 1)
    const uint2* pre;      // [n] or null
    const uint2* post;     // [n] or null
    uint32_t scale;        // 1: none
    int log_n;
    int lo;                // this pass runs stages lo .. lo + k - 1
    int k;
    int tau;               // T = 2^tau columns per tile
    uint32_t per_row;      // blocks per row of the batch
};

__device__ __forceinline__ uint32_t bitrev(uint32_t x, int bits) {
    return bits == 0 ? 0u : __brev(x) >> (32 - bits);
}

__device__ __forceinline__ cm31 as_cm31(uint2 v) { return {v.x, v.y}; }
__device__ __forceinline__ uint2 as_uint2(cm31 v) { return make_uint2(v.re, v.im); }

// One pass.  Positions p index the bit-reversed array the network works on
// (the output of the last stage is in natural order at the same positions).
// A block owns the positions  base | r << lo | q << tlo  for r < 2^k (the
// points of one sub-transform) and q < T (the tile's columns):
//   FIRST (lo = 0): tlo = log_n - tau, so that the T columns are T
//     neighbouring words of the input (bit reversal turns the top bits of p
//     into the low bits of the input index); shared layout [q][r], padded;
//   later passes: tlo = 0, the T columns are neighbouring positions; shared
//     layout [r][q].
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(NTT_THREADS) cm31_ntt_pass(NttArgs a) {
    extern __shared__ uint2 sm[];
    const int L = a.log_n, k = a.k, tau = a.tau, lo = a.lo;
    const uint32_t K = 1u << k, T = 1u << tau;
    const uint32_t blk = blockIdx.x % a.per_row;
    const int64_t row = blockIdx.x / a.per_row;
    const int64_t n = (int64_t)1 << L;
    const uint32_t tid = threadIdx.x;

    uint32_t base, tlo;
    if (FIRST) {
        tlo = L - tau;
        base = blk << k;
    } else {
        const int nlow = lo - tau;  // free bits below the row field
        tlo = 0;
        base = ((blk >> nlow) << (lo + k)) | ((blk & ((1u << nlow) - 1)) << tau);
    }
    const uint32_t RS = FIRST ? 1 : T;      // shared stride of r
    const uint32_t QS = FIRST ? K + 1 : 1;  // shared stride of q

    // Load the tile.
    if (FIRST) {
        const int64_t* in_re = a.in_re + row * a.in_row_stride;
        const int64_t* in_im = a.in_im ? a.in_im + row * a.in_row_stride : nullptr;
        for (uint32_t i = tid; i < K * T; i += NTT_THREADS) {
            // c, h: the input-contiguous order of the tile's points.
            uint32_t c = i & (T - 1), h = i >> tau;
            uint32_t r = bitrev(h, k), q = bitrev(c, tau);
            uint32_t p = base | r | (q << tlo);
            uint32_t idx = bitrev(p, L);
            cm31 v = {0u, 0u};
            if ((int64_t)idx < a.in_len) {
                v.re = (uint32_t)in_re[idx];
                if (in_im) v.im = (uint32_t)in_im[idx];
                if (a.pre) v = cm31_mul(v, as_cm31(a.pre[idx]));
            }
            sm[r * RS + q * QS] = as_uint2(v);
        }
    } else {
        const uint2* mid = a.mid + row * n;
        for (uint32_t i = tid; i < K * T; i += NTT_THREADS) {
            uint32_t q = i & (T - 1), r = i >> tau;
            sm[r * RS + q * QS] = mid[base | (r << lo) | q];
        }
    }

    // k butterfly stages in shared memory.  Global stage lo + s pairs
    // positions that differ in bit lo + s; its twiddle for position p is
    // w_n^((p mod 2^(lo+s)) << (L - 1 - lo - s)).  Stages run two at a time
    // as one radix-4 step per barrier (an odd k starts with one radix-2
    // stage).
#ifndef NTT_SKIP_STAGES
    int s = 0;
    if (k & 1) {
        __syncthreads();
        for (uint32_t i = tid; i < (K >> 1) * T; i += NTT_THREADS) {
            uint32_t q, bf;
            if (FIRST) {
                q = i >> (k - 1);
                bf = i & ((K >> 1) - 1);
            } else {
                q = i & (T - 1);
                bf = i >> tau;
            }
            uint32_t i0 = (bf << 1) * RS + q * QS, i1 = i0 + RS;
            cm31 u = as_cm31(sm[i0]), v = as_cm31(sm[i1]);
            if (!FIRST) {  // the first pass's stage 0 has the twiddle 1 only
                uint32_t low = (base | q) & ((1u << lo) - 1);
                v = cm31_mul(v, as_cm31(__ldg(a.tw + (low << (L - 1 - lo)))));
            }
            sm[i0] = as_uint2(cm31_add(u, v));
            sm[i1] = as_uint2(cm31_sub(u, v));
        }
        s = 1;
    }
    // w^(n/4), the twiddle that separates the two halves of a radix-4
    // step's second stage: i or -i, so its product is a swap and a negation.
    const bool w4_is_i = k >= 2 && __ldg(a.tw + (1u << (L - 2))).y == 1u;
    for (; s < k; s += 2) {
        __syncthreads();
        // Points r0 + {0, m, 2m, 3m} with x1, x3 in the upper half of stage
        // s and x2, x3 in the upper half of stage s + 1:
        //   y0, y2 = (x0 + x1 wa) +- (x2 wb + x3 wa wb)
        //   y1, y3 = (x0 - x1 wa) +- (x2 wb - x3 wa wb) w^(n/4)
        // with wa, wb the twiddles of stages s and s + 1 at x0's position:
        // three products where two radix-2 stages take four.
        const uint32_t m = 1u << s;
        const int shift_b = L - 2 - lo - s;  // stage s + 1; stage s: one more
        for (uint32_t i = tid; i < (K >> 2) * T; i += NTT_THREADS) {
            uint32_t q, g;
            if (FIRST) {
                q = i >> (k - 2);
                g = i & ((K >> 2) - 1);
            } else {
                q = i & (T - 1);
                g = i >> tau;
            }
            uint32_t j = g & (m - 1);
            uint32_t r0 = ((g >> s) << (s + 2)) | j;
            uint32_t i0 = r0 * RS + q * QS, step = m * RS;
            uint32_t low = FIRST ? 0u : ((base | q) & ((1u << lo) - 1));
            uint32_t eb = ((j << lo) | low) << shift_b;  // < n/4
            uint32_t ec = 3 * eb;                        // < 3n/4
            bool wrap = ec >= (1u << (L - 1));           // w^(n/2) = -1
            cm31 wa = as_cm31(__ldg(a.tw + 2 * eb));
            cm31 wb = as_cm31(__ldg(a.tw + eb));
            cm31 wc = as_cm31(__ldg(a.tw + (wrap ? ec - (1u << (L - 1)) : ec)));
            cm31 x0 = as_cm31(sm[i0]), x1 = as_cm31(sm[i0 + step]);
            cm31 x2 = as_cm31(sm[i0 + 2 * step]), x3 = as_cm31(sm[i0 + 3 * step]);
            cm31 t1 = cm31_mul(x1, wa), t2 = cm31_mul(x2, wb);
            cm31 t3 = cm31_mul(x3, wc);
            if (wrap) t3 = {m31_sub(0u, t3.re), m31_sub(0u, t3.im)};
            cm31 a0 = cm31_add(x0, t1), a1 = cm31_sub(x0, t1);
            cm31 b = cm31_add(t2, t3), d = cm31_sub(t2, t3);
            cm31 c = w4_is_i ? cm31{m31_sub(0u, d.im), d.re}
                             : cm31{d.im, m31_sub(0u, d.re)};
            sm[i0] = as_uint2(cm31_add(a0, b));
            sm[i0 + step] = as_uint2(cm31_add(a1, c));
            sm[i0 + 2 * step] = as_uint2(cm31_sub(a0, b));
            sm[i0 + 3 * step] = as_uint2(cm31_sub(a1, c));
        }
    }
#endif
    __syncthreads();

    // Store the tile.
    for (uint32_t i = tid; i < K * T; i += NTT_THREADS) {
        uint32_t q, r;
        if (FIRST) {
            r = i & (K - 1);
            q = i >> k;
        } else {
            q = i & (T - 1);
            r = i >> tau;
        }
        uint32_t p = base | (r << lo) | (q << tlo);
        cm31 v = as_cm31(sm[r * RS + q * QS]);
        if (LAST) {
            if (a.post) v = cm31_mul(v, as_cm31(a.post[p]));
            if (a.scale != 1u) {
                v.re = m31_mul(v.re, a.scale);
                v.im = m31_mul(v.im, a.scale);
            }
            a.out_re[row * n + p] = (int64_t)v.re;
            a.out_im[row * n + p] = (int64_t)v.im;
        } else {
            a.mid[row * n + p] = as_uint2(v);
        }
    }
}

template <bool FIRST, bool LAST>
static int launch_pass(const NttArgs& a, long long batch, cudaStream_t s) {
    long long blocks = batch * (long long)a.per_row;
    if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    size_t points = FIRST ? ((size_t)(1u << a.k) + 1) << a.tau
                          : (size_t)1 << (a.k + a.tau);
    if (points * sizeof(uint2) > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            cm31_ntt_pass<FIRST, LAST>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(points * sizeof(uint2)));
        if (e != cudaSuccess) return (int)e;
    }
    cm31_ntt_pass<FIRST, LAST><<<(unsigned)blocks, NTT_THREADS,
                                 points * sizeof(uint2), s>>>(a);
    return (int)cudaGetLastError();
}

// Transforms `batch` rows.  `in_re`/`in_im`: int64 words, row stride
// `in_row_stride`, `in_len` <= n valid per row (the rest reads as zero),
// `in_im` may be null.  `out_re`/`out_im`: contiguous int64 [batch, n], not
// aliasing the input.  `tw`, `pre`, `post`: uint32 (re, im) pairs; `pre`
// and `post` may be null.  `scale`: a canonical word, 1 for none.
extern "C" int cm31_ntt(const void* in_re, const void* in_im,
                        long long in_row_stride, long long in_len,
                        void* out_re, void* out_im, const void* tw,
                        const void* pre, const void* post, long long batch,
                        int log_n, long long scale, void* stream) {
    if (log_n < 1 || log_n > 31 || in_len < 0 ||
        in_len > ((long long)1 << log_n) || scale < 0 || scale >= M31_P)
        return (int)cudaErrorInvalidValue;
    if (batch <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    NttArgs a;
    a.in_re = (const int64_t*)in_re;
    a.in_im = (const int64_t*)in_im;
    a.in_row_stride = in_row_stride;
    a.in_len = in_len;
    a.mid = (uint2*)out_re;
    a.out_re = (int64_t*)out_re;
    a.out_im = (int64_t*)out_im;
    a.tw = (const uint2*)tw;
    a.pre = (const uint2*)pre;
    a.post = (const uint2*)post;
    a.scale = (uint32_t)scale;
    a.log_n = log_n;
    a.lo = 0;

    if (log_n <= NTT_SINGLE_PASS_MAX) {
        a.k = log_n;
        a.tau = 0;
        a.per_row = 1;
        return launch_pass<true, true>(a, batch, s);
    }
    const int passes = (log_n + NTT_PASS_LOG - 1) / NTT_PASS_LOG;
    const int k_max = (log_n + passes - 1) / passes;
    // Tiles of 16 columns (128 contiguous bytes of uint32 pairs, 64 KB of
    // shared memory a block); 4 columns when the batch alone would leave
    // most of the 132 SMs without a block.
    a.tau = NTT_TAU;
    if (batch * ((long long)1 << (log_n - k_max - NTT_TAU)) < 132) a.tau = 2;
    int err = 0;
    for (int pass = 0; pass < passes && err == 0; ++pass) {
        // Spread log_n over the passes, the larger ones first.
        a.k = log_n / passes + (pass < log_n % passes ? 1 : 0);
        a.per_row = 1u << (log_n - a.k - a.tau);
        if (pass == 0)
            err = launch_pass<true, false>(a, batch, s);
        else if (pass < passes - 1)
            err = launch_pass<false, false>(a, batch, s);
        else
            err = launch_pass<false, true>(a, batch, s);
        a.lo += a.k;
    }
    return err;
}
