// cm31_ntt: radix-2 (decimation in time) CM31 NTT over the last axis of
// [B, n] word arrays, forward or inverse, natural order in and out, with
// the edges of `intt`, `lde`, `coset_ntt` and `coset_intt` fused in.
//
// Replaces, on the TPU side, the XLA transform of zkir_tpu/ops/ntt.py
// (`_ntt_core` with `_ntt_penult` and `_mid_twiddles`, and the elementwise
// passes of `intt`, `lde`, `coset_ntt`, `coset_intt`), whose butterflies are
// the products and sums of the Pallas kernel `_binary_pallas`
// (zkir_tpu/ops/field_ops.py).
//
// Bound on the H100: the larger of one read of the input and one write of
// the output at the memory rate, and the instructions of every butterfly's
// sum and difference and of the fewest CM31 products a split of the stages
// into radix-2, -4 and -8 steps needs (a product 17, a sum and difference
// 8, by this build's SASS: tools/sass_count.py ntt_instructions) at the
// SMs' issue rate.  The
// passes move more than the bound's bytes (a point goes to device memory
// between passes), and the integer instructions of a 2^18 transform take
// about as long as its bytes, so the design keeps both streams busy at
// once:
//   - the pass plan (stages a pass, tile shape, register steps, skipped
//     stages, the steps' factor tables and the DFT's constants) is chosen
//     on the host (ops/ntt.py `ntt_plan`, `plan_words`) and handed to the
//     launch; n <= 2^12 is one pass, larger sizes two or three: where the
//     batch fills the card, passes of at most 8 stages, whose tiles keep
//     16 or more neighbouring positions (runs of 128 bytes or more);
//   - a pass's blocks are persistent, three an SM: each walks over tiles of
//     2^k points of 2^tau sub-transforms, with a ring of NTT_STAGES tiles
//     in shared memory filled by cp.async, so tile t + 1 arrives while
//     tile t's butterflies run and tile t - 1 is being stored;
//   - a thread holds 8 points in registers and runs up to three stages on
//     them as one radix-8 step: the inputs multiplied by their factors
//     (seven products from one record of the step's table, none in a first
//     pass's first step), then an 8-point DFT whose constants are 1, +-i (a
//     swap and a negation), w^(n/8) and w^(3n/8); points go through shared
//     memory only between steps, so a 9-stage pass has 3 steps and 2
//     exchanges;
//   - words are lazy between load and store: in [0, p], p standing for 0,
//     so a sum is one instruction, a difference two, and a product's fold
//     skips its last conditional subtraction; stores make them canonical;
//   - the network runs over the bit-reversed input; the reversal is the
//     addresses of the first pass's copies (no gather), which take 4-byte
//     low halves of the int64 words (the uint32 pair a point in shared
//     memory) with the copy's zero fill beyond `in_len`; neither 16-byte
//     copies of whole words nor 16-byte stores made it faster (the
//     NTT_WIDE_* variants below);
//   - an input zero beyond n >> b (the LDE's coefficients) lets the first
//     pass skip the b stages that only replicate it: a tile of
//     coefficients gives all 2^b cosets' points;
//   - between passes points are uint32 pairs (8 bytes) in `mid`, the
//     storage of `out_re` (8 bytes a point) or, for `lde`, of the larger
//     output; a block reads its tile before it writes it and blocks own
//     disjoint points, so passes run in place.  `lde` multiplies its
//     coefficients by the coset shift's powers as its iNTT stores them
//     (`post`), as uint32 pairs (FLAG_OUT_PAIRS) in the output's second
//     half's storage, and the forward transform reads them there
//     (FLAG_IN_PAIRS): no int64 coefficients in device memory;
//   - `pre[i]` multiplies input i on load, `post[i]` and the scalar
//     `scale` multiply output i on store.
// Butterfly order cannot change a field result: the output equals the plain
// torch network word for word.  tests/test_torch_ntt_plan.py runs this
// kernel's plan, copies, index maps and lazy words translated into torch.
//
// Written in CUDA C++ rather than Triton: the steps need explicit shared-
// memory indexing with barriers, asynchronous copies with zero fill, and
// 64-bit integer products, and the kernel shares m31.cuh.
#include <cuda_runtime.h>

#include "m31.cuh"

// Build parameters that zkir_tpu_torch/tools/ntt_bench.py varies to time
// other designs side by side: the ring's depth, the blocks an SM the
// registers leave room for, the threads and points a thread of a tile, and
// NTT_SKIP_STAGES (the butterflies compiled out: wrong results, what is
// left is the passes' copies, exchanges and stores).  Two more variants
// move 16 bytes a thread where the committed build moves 4 or 8:
// NTT_WIDE_LOADS, a first pass of int64 input copies whole words, two
// neighbouring ones a copy, into a tile of twice the bytes (a complex
// input's), and its first step reads their low halves; NTT_WIDE_STORES,
// the lanes of a pair hold neighbouring positions and trade one word a
// point by a shuffle, so each stores 16 bytes (two neighbouring words of
// one output array, or two uint32 pairs) where it stored 8.
#ifndef NTT_STAGES
#define NTT_STAGES 2
#endif
#ifndef NTT_MAX_THREADS
#define NTT_MAX_THREADS 512
#endif
#ifndef NTT_MIN_BLOCKS
#define NTT_MIN_BLOCKS 3   // blocks an SM the registers must leave room for
#endif
#ifndef NTT_POINTS_LOG
#define NTT_POINTS_LOG 3   // points a thread: 8, tiles of up to 2^12 points
#endif
#define NTT_POINTS (1 << NTT_POINTS_LOG)
#define NTT_PAD 1          // uint2 padding a column of a first pass's tile
#define NTT_MAX_STEPS 4
#define FLAG_IN_PAIRS 1    // input: uint32 pairs [B, in_len], not int64 words
#define FLAG_OUT_PAIRS 2   // output: uint32 pairs [B, n] at `out_re`

struct NttPass {
    int lo, k, tau, skip, nsteps;
    int steps[NTT_MAX_STEPS];
    // Per step: for each x0 < 2^G its 2^RL - 1 factors, one record (null
    // where G = 0: the factors are all 1).
    const uint2* tw[NTT_MAX_STEPS];
};

// The 8-point DFT's constants: w^(n/4) (+-i), w^(n/8), w^(3n/8).
struct Consts {
    bool w4_is_i;
    cm31 w8, w8_3;
};

struct NttArgs {
    const int64_t* in_re;  // [B, in_len] with row stride in_row_stride
    const int64_t* in_im;  // or null
    int64_t in_row_stride;
    int64_t in_len;
    uint2* mid;            // [B, n] uint32 pairs between passes
    int64_t* out_re;       // [B, n] (FLAG_OUT_PAIRS: uint32 pairs)
    int64_t* out_im;
    int64_t out_row_stride;
    const uint2* pre;      // [n] or null
    const uint2* post;     // [n] or null
    uint32_t scale;        // 1: none
    int log_n;
    int flags;
    uint32_t per_row;      // tiles a row
    long long tiles;
    bool wide_in;          // NTT_WIDE_LOADS: the input's rows 16-byte aligned
    bool wide_out;         // NTT_WIDE_STORES: the output's rows likewise
    Consts cs;
    NttPass ps;
};

// Lazy words in [0, p].
__device__ __forceinline__ uint32_t lz_add(uint32_t a, uint32_t b) {
    uint32_t s = a + b;
    return min(s, s - M31_P);
}

__device__ __forceinline__ uint32_t lz_sub(uint32_t a, uint32_t b) {
    uint32_t d = a - b;
    return min(d, d + M31_P);
}

// x <= 2 p^2 -> [0, p]: the three 31-bit parts sum to at most 2p.
__device__ __forceinline__ uint32_t lz_fold(uint64_t x) {
    uint32_t s = ((uint32_t)x & M31_P) + ((uint32_t)(x >> 31) & M31_P) +
                 (uint32_t)(x >> 62);
    return min(s, s - M31_P);
}

__device__ __forceinline__ cm31 lz_cmul(cm31 a, cm31 b) {
    uint64_t re = (uint64_t)a.re * b.re + (uint64_t)(M31_P - a.im) * b.im;
    uint64_t im = (uint64_t)a.re * b.im + (uint64_t)a.im * b.re;
    return {lz_fold(re), lz_fold(im)};
}

__device__ __forceinline__ uint32_t canon(uint32_t x) {
    return min(x, x - M31_P);
}

__device__ __forceinline__ uint32_t bitrev(uint32_t x, int bits) {
    return bits == 0 ? 0u : __brev(x) >> (32 - bits);
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0));
    else if (bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                     "l"(gmem), "r"(valid ? 8 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                     "l"(gmem), "r"(valid ? 4 : 0));
}

#ifdef NTT_WIDE_LOADS
// 16 bytes into shared memory, `bytes` of them from `gmem`, the rest zero.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes));
}

// The shared row of input row h of a wide first-pass tile: rows 2^(kk - 4)
// apart (a warp's first step reads them together) trade places with their
// neighbours, so they fall in different halves of the banks.
__device__ __forceinline__ uint32_t raw_row(uint32_t h, int kk) {
    return kk >= 5 ? h ^ ((h >> (kk - 4)) & 1) : h;
}
#endif

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The tile of a pass: positions p(r, q) for r < 2^k (the points of one
// sub-transform) and q < 2^tau (the sub-transforms):
//   first pass (lo = 0): p = blk << k | r | q << (L - tau), so the 2^tau
//     columns are neighbouring input words after the bit reversal; shared
//     layout [q][r], pitch 2^k + NTT_PAD (loaded: 2^(k - skip) + NTT_PAD);
//   later passes: p = hi_b | r << lo | low_b | q, q the low position bits;
//     shared layout [row(r)][q], rows permuted so that the groups of a
//     warp's first step (r 8 apart) fall in different banks.
struct Tile {
    long long row;
    uint32_t blk, low_b, hi_b;
};

__device__ __forceinline__ uint32_t row(uint32_t r) {
    return r ^ ((r >> 3) & 3);
}

template <bool FIRST>
__device__ __forceinline__ uint32_t position(const NttArgs& a, const Tile& t,
                                             uint32_t r, uint32_t q) {
    const NttPass& ps = a.ps;
    if (FIRST) return (t.blk << ps.k) | r | (q << (a.log_n - ps.tau));
    return t.hi_b | (r << ps.lo) | t.low_b | q;
}

template <bool FIRST>
__device__ __forceinline__ Tile tile_of(const NttArgs& a, long long tile) {
    Tile t;
    t.row = tile / a.per_row;
    t.blk = (uint32_t)(tile % a.per_row);
    const int nlow = a.ps.lo - a.ps.tau;
    t.low_b = FIRST ? 0u : (t.blk & ((1u << nlow) - 1)) << a.ps.tau;
    t.hi_b = FIRST ? 0u : (t.blk >> nlow) << (a.ps.lo + a.ps.k);
    return t;
}

// The tile's asynchronous copies into `slot`.
template <bool FIRST>
__device__ __forceinline__ void issue(const NttArgs& a, long long tile,
                                      uint2* slot) {
    const NttPass& ps = a.ps;
    const int L = a.log_n, k = ps.k, tau = ps.tau;
    const uint32_t T = 1u << tau, nt = blockDim.x;
    const Tile t = tile_of<FIRST>(a, tile);
    if (FIRST) {
        const int kk = k - ps.skip;
        const uint32_t pitch = (1u << kk) + NTT_PAD;
        const uint32_t mid = bitrev(t.blk, L - k - tau) << tau;
        const int64_t* re = a.in_re + t.row * a.in_row_stride;
        const int64_t* im = a.in_im ? a.in_im + t.row * a.in_row_stride
                                    : nullptr;
        const uint2* pairs = (const uint2*)a.in_re + t.row * a.in_row_stride;
#ifdef NTT_WIDE_LOADS
        if (a.wide_in) {
            // Layout: the real words [raw_row(h)][c], then the imaginary.
            int64_t* raw = (int64_t*)slot;
            const uint32_t words = 1u << (kk + tau);
            for (uint32_t w2 = threadIdx.x; w2 < words / 2; w2 += nt) {
                const uint32_t h = w2 >> (tau - 1), c = (w2 & (T / 2 - 1)) << 1;
                const uint32_t idx = (h << (L - k)) | mid | c;
                const int64_t left = a.in_len - (int64_t)idx;
                const int bytes = left >= 2 ? 16 : left == 1 ? 8 : 0;
                int64_t* dst = raw + raw_row(h, kk) * T + c;
                cp_async16(dst, re + (bytes ? idx : 0), bytes);
                if (im) cp_async16(dst + words, im + (bytes ? idx : 0), bytes);
            }
            return;
        }
#endif
        for (uint32_t w = threadIdx.x; w < (1u << (kk + tau)); w += nt) {
            const uint32_t h = w >> tau, c = w & (T - 1);
            const uint32_t idx = (h << (L - k)) | mid | c;
            const bool ok = (int64_t)idx < a.in_len;
            uint2* dst = slot + bitrev(c, tau) * pitch + bitrev(h, kk);
            if (a.flags & FLAG_IN_PAIRS) {
                cp_async(dst, pairs + (ok ? idx : 0), 8, ok);
            } else {
                cp_async(&dst->x, re + (ok ? idx : 0), 4, ok);
                if (im) cp_async(&dst->y, im + (ok ? idx : 0), 4, ok);
            }
        }
    } else {
        const int64_t n = (int64_t)1 << L;
        const uint2* src = a.mid + t.row * n;
        for (uint32_t c2 = threadIdx.x; c2 < (1u << (k + tau - 1)); c2 += nt) {
            const uint32_t r = c2 >> (tau - 1), qq = (c2 & (T / 2 - 1)) << 1;
            cp_async(slot + row(r) * T + qq,
                     src + position<false>(a, t, r, qq), 16, true);
        }
    }
}

__device__ __forceinline__ cm31 times_w4(cm31 v, bool w4_is_i) {
    return w4_is_i ? cm31{M31_P - v.im, v.re} : cm31{v.im, M31_P - v.re};
}

// One register step: stages s .. s + RL - 1 of the pass on groups of 2^RL
// points; a thread holds 8 points, 8 >> RL groups.  Group gid = u * nt +
// tid (consecutive threads, consecutive groups): a first pass orders gid
// as (lo_ fastest, then q, then hi), later passes as (q, lo_, hi), so the
// last step's stores are runs of neighbouring positions; the group's
// points are r0 + j 2^s, r0 = lo_ | hi << (s + RL).  Points 1 .. 2^RL - 1
// are multiplied by W^(x0 rev(j) 2^(L - G - RL)), x0 the position's bits
// below G = lo + s (the record x0 of the step's table `tw`), then run
// through the RL stages of an 8-point DFT.
template <int RL, bool FIRST, bool LAST>
__device__ __forceinline__ void step(const NttArgs& a, const Tile& t,
                                     uint2* w, int s, bool first_step,
                                     bool last_step, const uint2* tw) {
    const Consts& cs = a.cs;
    constexpr int R = 1 << RL, U = NTT_POINTS / R;
    const NttPass& ps = a.ps;
    const int L = a.log_n, k = ps.k, tau = ps.tau, lo = ps.lo;
    const int skip = FIRST ? ps.skip : 0;
    const uint32_t K = 1u << k, T = 1u << tau, nt = blockDim.x;
    const uint32_t groups = (K << tau) >> RL;
    const uint32_t in_pitch = (1u << (k - skip)) + NTT_PAD;
    const uint32_t pitch = K + NTT_PAD;
    cm31 x[NTT_POINTS];
    uint32_t gq[U], gr0[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const uint32_t gid = u * nt + threadIdx.x;
        uint32_t q, lo_, hi;
        if (FIRST) {
            lo_ = gid & ((1u << s) - 1);
            const uint32_t rest = gid >> s;
            q = rest & (T - 1);
            hi = rest >> tau;
        } else {
            q = gid & (T - 1);
            const uint32_t rest = gid >> tau;
            lo_ = rest & ((1u << s) - 1);
            hi = rest >> s;
        }
        gq[u] = q;
        gr0[u] = lo_ | (hi << (s + RL));
        if (gid >= groups) continue;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const uint32_t r = gr0[u] + ((uint32_t)j << s);
            cm31 v;
            if (FIRST && first_step) {
#ifdef NTT_WIDE_LOADS
                if (a.wide_in) {
                    const int kk = k - skip;
                    const uint32_t at =
                        raw_row(bitrev(r >> skip, kk), kk) * T +
                        bitrev(q, tau);
                    const int64_t* raw = (const int64_t*)w;
                    v = {(uint32_t)raw[at],
                         a.in_im ? (uint32_t)raw[at + (1u << (kk + tau))]
                                 : 0u};
                } else
#endif
                {
                    const uint2 e = w[q * in_pitch + (r >> skip)];
                    v = {e.x,
                         (a.in_im || (a.flags & FLAG_IN_PAIRS)) ? e.y : 0u};
                }
                if (a.pre) {
                    const uint32_t src = (r >> skip) << skip;
                    const uint2 f = __ldg(
                        a.pre + bitrev(position<true>(a, t, src, q), L));
                    v = lz_cmul(v, {f.x, f.y});
                }
            } else {
                const uint2 e = FIRST ? w[q * pitch + r] : w[row(r) * T + q];
                v = {e.x, e.y};
            }
            x[u * R + j] = v;
        }
#ifndef NTT_SKIP_STAGES
        if (tw) {
            const uint32_t x0 = FIRST ? lo_ : (lo_ << lo) | t.low_b | q;
            const uint2* f = tw + x0 * (R - 1);
#pragma unroll
            for (int j = 1; j < R; ++j) {
                const uint2 e = __ldg(f + j - 1);
                x[u * R + j] = lz_cmul(x[u * R + j], {e.x, e.y});
            }
        }
        // The DFT's stages: tt pairs j and j + 2^tt, the upper one times
        // w_(2^(tt+1))^(j mod 2^tt).
#pragma unroll
        for (int tt = 0; tt < RL; ++tt) {
#pragma unroll
            for (int j = 0; j < R; ++j) {
                if (j >> tt & 1) continue;
                cm31 lo_v = x[u * R + j], hi_v = x[u * R + j + (1 << tt)];
                const int m = j & ((1 << tt) - 1);
                if (m == 0) {
                } else if ((tt == 1 && m == 1) || (tt == 2 && m == 2)) {
                    hi_v = times_w4(hi_v, cs.w4_is_i);
                } else if (m == 1) {
                    hi_v = lz_cmul(hi_v, cs.w8);
                } else {
                    hi_v = lz_cmul(hi_v, cs.w8_3);
                }
                x[u * R + j] = {lz_add(lo_v.re, hi_v.re),
                                lz_add(lo_v.im, hi_v.im)};
                x[u * R + j + (1 << tt)] = {lz_sub(lo_v.re, hi_v.re),
                                            lz_sub(lo_v.im, hi_v.im)};
            }
        }
#endif
    }
    // A first pass's first step changes the layout in place: every thread
    // reads before any writes.
    if (FIRST && first_step && !last_step) __syncthreads();
    const int64_t n = (int64_t)1 << L;
#ifdef NTT_WIDE_STORES
    // Lane pairs hold neighbouring positions: in a first pass r differs in
    // its low bit (s >= 1), in a later pass q does.  Every lane is here
    // (groups = U nt).
    if (last_step && nt >= 32 && (!FIRST || s >= 1) &&
        (!LAST || a.wide_out)) {
        const uint32_t odd = threadIdx.x & 1;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const uint32_t q = gq[u];
#pragma unroll
            for (int j = 0; j < (LAST ? R : 0); ++j) {
                const uint32_t pp =
                    position<FIRST>(a, t, gr0[u] + ((uint32_t)j << s), q);
                cm31 v = x[u * R + j];
                if (a.post) {
                    const uint2 f = __ldg(a.post + pp);
                    v = lz_cmul(v, {f.x, f.y});
                }
                if (a.scale != 1u) {
                    v.re = lz_fold((uint64_t)v.re * a.scale);
                    v.im = lz_fold((uint64_t)v.im * a.scale);
                }
                x[u * R + j] = {canon(v.re), canon(v.im)};
            }
            if (!LAST || (a.flags & FLAG_OUT_PAIRS)) {
                // Points j, j + 1: the even lane stores j's two positions,
                // the odd lane j + 1's.
                uint2* base = LAST ? (uint2*)a.out_re + t.row * a.out_row_stride
                                   : a.mid + t.row * n;
#pragma unroll
                for (int j = 0; j < R; j += 2) {
                    const cm31 a0 = x[u * R + j], a1 = x[u * R + j + 1];
                    const cm31 snd = odd ? a0 : a1;
                    const uint32_t gre = __shfl_xor_sync(~0u, snd.re, 1);
                    const uint32_t gim = __shfl_xor_sync(~0u, snd.im, 1);
                    const uint32_t pp = position<FIRST>(
                        a, t, gr0[u] + ((uint32_t)(j + odd) << s), q);
                    *(uint4*)(base + pp - odd) =
                        odd ? make_uint4(gre, gim, a1.re, a1.im)
                            : make_uint4(a0.re, a0.im, gre, gim);
                }
            } else {
                // The even lane stores two real words, the odd two imaginary.
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    const cm31 v = x[u * R + j];
                    const uint32_t got =
                        __shfl_xor_sync(~0u, odd ? v.re : v.im, 1);
                    const int64_t p =
                        t.row * a.out_row_stride +
                        position<FIRST>(a, t, gr0[u] + ((uint32_t)j << s), q);
                    if (odd)
                        *(longlong2*)(a.out_im + p - 1) =
                            make_longlong2(got, v.im);
                    else
                        *(longlong2*)(a.out_re + p) = make_longlong2(v.re, got);
                }
            }
        }
        return;
    }
#endif
#pragma unroll
    for (int u = 0; u < U; ++u) {
        if (u * nt + threadIdx.x >= groups) continue;
        const uint32_t q = gq[u];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const uint32_t r = gr0[u] + ((uint32_t)j << s);
            cm31 v = x[u * R + j];
            if (!last_step) {
                (FIRST ? w[q * pitch + r] : w[row(r) * T + q]) =
                    make_uint2(v.re, v.im);
                continue;
            }
            const uint32_t pp = position<FIRST>(a, t, r, q);
            if (!LAST) {
                a.mid[t.row * n + pp] = make_uint2(v.re, v.im);
                continue;
            }
            const int64_t p = t.row * a.out_row_stride + pp;
            if (a.post) {
                const uint2 f = __ldg(a.post + pp);
                v = lz_cmul(v, {f.x, f.y});
            }
            if (a.scale != 1u) {
                v.re = lz_fold((uint64_t)v.re * a.scale);
                v.im = lz_fold((uint64_t)v.im * a.scale);
            }
            v = {canon(v.re), canon(v.im)};
            if (a.flags & FLAG_OUT_PAIRS) {
                ((uint2*)a.out_re)[p] = make_uint2(v.re, v.im);
            } else {
                a.out_re[p] = (int64_t)v.re;
                a.out_im[p] = (int64_t)v.im;
            }
        }
    }
}

// uint2 words of a tile's slot in the ring.
template <bool FIRST>
__host__ __device__ __forceinline__ uint32_t slot_words(const NttArgs& a) {
    const NttPass& ps = a.ps;
    uint32_t words = (FIRST ? (1u << ps.k) + NTT_PAD : 1u << ps.k) << ps.tau;
#ifdef NTT_WIDE_LOADS
    // int64 words, a complex input's twice: twice the bytes of uint32 pairs.
    const uint32_t raw = (a.in_im ? 2u : 1u) << (ps.k - ps.skip + ps.tau);
    if (FIRST && a.wide_in && raw > words) words = raw;
#endif
    return words;
}

// One pass.  Persistent blocks: block b runs tiles b, b + grid, ...; a ring
// of NTT_STAGES slots holds the tiles whose copies are in flight.
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(NTT_MAX_THREADS, NTT_MIN_BLOCKS)
    cm31_ntt_pass(NttArgs a) {
    extern __shared__ uint2 sm[];
    const NttPass& ps = a.ps;
    const uint32_t slot = slot_words<FIRST>(a);

    const long long grid = gridDim.x;
#pragma unroll
    for (int st = 0; st < NTT_STAGES - 1; ++st) {
        const long long tile = blockIdx.x + st * grid;
        if (tile < a.tiles) issue<FIRST>(a, tile, sm + st * slot);
        cp_async_commit();
    }
    int it = 0;
    for (long long tile = blockIdx.x; tile < a.tiles; tile += grid, ++it) {
        // Every thread is done with the previous tile's slot.
        __syncthreads();
        const long long ahead = tile + (NTT_STAGES - 1) * grid;
        if (ahead < a.tiles)
            issue<FIRST>(
                a, ahead,
                sm + ((it + NTT_STAGES - 1) % NTT_STAGES) * slot);
        cp_async_commit();
        cp_async_wait<NTT_STAGES - 1>();
        __syncthreads();
        uint2* w = sm + (it % NTT_STAGES) * slot;
        const Tile t = tile_of<FIRST>(a, tile);
        int s = FIRST ? ps.skip : 0;
        for (int i = 0; i < ps.nsteps; ++i) {
            const bool first_step = i == 0, last_step = i == ps.nsteps - 1;
            if (i > 0) __syncthreads();
            switch (ps.steps[i]) {
                case 1:
                    step<1, FIRST, LAST>(a, t, w, s, first_step, last_step,
                                         ps.tw[i]);
                    break;
                case 2:
                    step<2, FIRST, LAST>(a, t, w, s, first_step, last_step,
                                         ps.tw[i]);
                    break;
                default:
                    step<3, FIRST, LAST>(a, t, w, s, first_step, last_step,
                                         ps.tw[i]);
                    break;
            }
            s += ps.steps[i];
        }
    }
    cp_async_wait<0>();
}

// Blocks of one pass an SM, by (threads, shared memory), computed once
// each: a prove makes hundreds of launches, and the occupancy query costs
// host time.
template <bool FIRST, bool LAST>
static int resident_blocks(int threads, size_t smem, int* blocks) {
    static int sms = 0, max_smem = 48 * 1024, used = 0;
    static int key_threads[32], value[32];
    static size_t key_smem[32];
    for (int i = 0; i < used; ++i)
        if (key_threads[i] == threads && key_smem[i] == smem) {
            *blocks = value[i];
            return 0;
        }
    auto kernel = cm31_ntt_pass<FIRST, LAST>;
    cudaError_t e;
    if (sms == 0) {
        int device;
        if ((e = cudaGetDevice(&device)) != cudaSuccess ||
            (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        device)) != cudaSuccess)
            return (int)e;
    }
    if ((int)smem > max_smem) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        max_smem = (int)smem;
    }
    int per_sm;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    *blocks = per_sm * sms;
    if (used < 32) {
        key_threads[used] = threads;
        key_smem[used] = smem;
        value[used++] = *blocks;
    }
    return 0;
}

template <bool FIRST, bool LAST>
static int launch_pass(NttArgs a, long long batch, cudaStream_t stream) {
    const NttPass& ps = a.ps;
    const int threads = ps.k + ps.tau >= NTT_POINTS_LOG
                            ? 1 << (ps.k + ps.tau - NTT_POINTS_LOG)
                            : 1;
    const size_t slot = slot_words<FIRST>(a);
    const size_t smem = NTT_STAGES * slot * sizeof(uint2);
    int resident;
    const int err = resident_blocks<FIRST, LAST>(threads, smem, &resident);
    if (err) return err;
    a.per_row = 1u << (a.log_n - ps.k - ps.tau);
    a.tiles = batch * (long long)a.per_row;
    const long long grid = a.tiles < resident ? a.tiles : resident;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
    cm31_ntt_pass<FIRST, LAST><<<(unsigned)grid, threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// Transforms `batch` rows by the passes of `plan` (host int64: pass count,
// flags, w^(n/4) is i, w^(n/8) and w^(3n/8) as re | im << 32, then per
// pass lo, k, tau, skip, step count, NTT_MAX_STEPS step sizes and
// NTT_MAX_STEPS factor-table addresses; ops/ntt.py `ntt_plan`,
// `plan_words`).  `in_re`/`in_im`: int64 words, row stride
// `in_row_stride`, `in_len` <= n valid per row (the rest reads as zero),
// `in_im` may be null; with FLAG_IN_PAIRS `in_re` is uint32 pairs.  `mid`:
// [batch, n] uint32 pairs between passes, 16-byte aligned, which may be
// `out_re`'s storage but must not overlap the input.  `out_re`/`out_im`:
// int64 [batch, n] with row stride `out_row_stride` (FLAG_OUT_PAIRS: uint32
// pairs at `out_re`, row stride in pairs).  `pre`, `post`: uint32 (re, im)
// pairs [n] or null.  `scale`: a canonical word, 1 for none.
extern "C" int cm31_ntt(const void* in_re, const void* in_im,
                        long long in_row_stride, long long in_len,
                        void* out_re, void* out_im, long long out_row_stride,
                        void* mid, const void* pre, const void* post,
                        long long batch, int log_n, long long scale,
                        const void* plan, void* stream) {
    const long long* pw = (const long long*)plan;
    const int passes = (int)pw[0];
    if (log_n < 1 || log_n > 30 || in_len < 0 ||
        in_len > ((long long)1 << log_n) || scale < 0 || scale >= M31_P ||
        passes < 1 || passes > 3 || (passes > 1 && ((uintptr_t)mid & 15)))
        return (int)cudaErrorInvalidValue;
    if (batch <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    NttArgs a;
    a.in_re = (const int64_t*)in_re;
    a.in_im = (const int64_t*)in_im;
    a.in_row_stride = in_row_stride;
    a.in_len = in_len;
    a.mid = (uint2*)mid;
    a.out_re = (int64_t*)out_re;
    a.out_im = (int64_t*)out_im;
    a.out_row_stride = out_row_stride;
    a.pre = (const uint2*)pre;
    a.post = (const uint2*)post;
    a.scale = (uint32_t)scale;
    a.log_n = log_n;
    const int flags = (int)pw[1];
    a.cs.w4_is_i = pw[2] != 0;
    a.cs.w8 = {(uint32_t)pw[3], (uint32_t)(pw[3] >> 32)};
    a.cs.w8_3 = {(uint32_t)pw[4], (uint32_t)(pw[4] >> 32)};
    int err = 0;
    for (int i = 0; i < passes && err == 0; ++i) {
        const long long* q = pw + 5 + i * (5 + 2 * NTT_MAX_STEPS);
        a.ps.lo = (int)q[0];
        a.ps.k = (int)q[1];
        a.ps.tau = (int)q[2];
        a.ps.skip = (int)q[3];
        a.ps.nsteps = (int)q[4];
        for (int j = 0; j < NTT_MAX_STEPS; ++j) {
            a.ps.steps[j] = (int)q[5 + j];
            a.ps.tw[j] = (const uint2*)q[5 + NTT_MAX_STEPS + j];
        }
        if (a.ps.k < 1 ||
            (1 << (a.ps.k + a.ps.tau)) > NTT_POINTS * NTT_MAX_THREADS ||
            a.ps.nsteps < 1 || a.ps.nsteps > NTT_MAX_STEPS ||
            (i > 0 && a.ps.tau < 1))
            return (int)cudaErrorInvalidValue;
        // Only the first pass reads the input's format, only the last
        // writes the output's.
        a.flags = flags & ((i == 0 ? FLAG_IN_PAIRS : 0) |
                           (i == passes - 1 ? FLAG_OUT_PAIRS : 0));
        a.wide_in = i == 0 && !(a.flags & FLAG_IN_PAIRS) && a.ps.tau >= 1 &&
                    !(((uintptr_t)in_re | (uintptr_t)in_im) & 15) &&
                    !(in_row_stride & 1);
        a.wide_out = !(((uintptr_t)out_re | (uintptr_t)out_im) & 15) &&
                     !(out_row_stride & 1);
        if (passes == 1)
            err = launch_pass<true, true>(a, batch, s);
        else if (i == 0)
            err = launch_pass<true, false>(a, batch, s);
        else if (i < passes - 1)
            err = launch_pass<false, false>(a, batch, s);
        else
            err = launch_pass<false, true>(a, batch, s);
    }
    return err;
}
