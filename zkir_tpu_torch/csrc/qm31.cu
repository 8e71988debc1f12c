// The LogUp partial sums' two device functions, a launch each:
//
//   qm31_inv_scaled     out = a (.) x^-1 + b (.) y^-1 over QM31, elementwise,
//                       zero mapping to zero (kernel A);
//   m31_exclusive_scan  exclusive prefix sums mod p along rows (kernel B).
//
// Replace the reference's XLA functions that build the partial sums
// (zkir_tpu/prover/prover.py `_masked_inv_kernel`, `_qm31_inv_sum_kernel`,
// `_memory_partial_sum_kernel`, `_two_sided_sum_kernel`,
// `_channel_sum_kernel`, `_aux_sum_kernel`, `_exclusive_cumsum4`): QM31
// batch inversion (`zkir_tpu/ops/qm31.py` `qm31_batch_inv` over
// `ops/field_ops.py` `m31_batch_inv` / `_batch_inv_chain`, a Montgomery
// product chain) and an int64 cumsum followed by `% P`.  Written by hand
// rather than left to plain torch: there each such function was some 50 K1
// launches (the Fermat chain of `m31_inv` one product a launch) and the
// scan three torch operators a coordinate.
//
// Kernel A.  x, y are QM31 4-tuples of [R, n] word columns, a and b M31
// scales; every operand is a pointer with a row stride (0: one row for
// all) or an immediate.  A thread owns a column j and a run of `rpt` rows,
// taken in batches of INV_BATCH (4): each element's CM31 norm a^2 - R b^2
// and its M31 norm, Montgomery's trick over the batch's M31 norms (one
// exponent chain p - 2, `m31_inv`'s 38 products, for the batch, three
// products an element), then each inverse back out.  Where y is one row
// for all (the lookup channels' table column) the thread inverts y once
// for its run.  A zero element has a zero norm, which the batch's product
// takes as 1, and its inverse comes out zero.  Loads and stores are
// coalesced along j; nothing is staged.  A batch of 8 took fewer
// instructions but more registers, and ran slower on the H100.
//
// Kernel B.  4 R rows of n words (the four coordinates of one function's
// term, each an [R, n] tensor) in tiles of 256 threads x 16 words, a
// block a tile: a warp's 512 words in eight rounds of a pair a lane (a
// warp's loads and stores whole runs of 512 bytes), each round scanned by
// shuffles with a carry, the 8 warp sums by the first warp.  Tiles take
// their place in order from a counter (so a tile waits only on tiles
// already running) and chain along their row by a decoupled look-back: a
// tile publishes its sum, then its first warp sums the published words of
// the tiles before it, 32 at a time, back to the nearest one that has
// published its row's running total, and publishes its own.  So every SM
// takes part whatever the row count, and rows of any length take one
// launch (the streaming prover's 2^20 and 2^22).  The combine is a mod-p
// add, so the words are those of an int64 cumsum then `% P`.  Bound on the
// H100: bytes (16 a word).
#include <cuda_runtime.h>

#include "m31.cuh"

namespace {

struct Col {
    const int64_t* p;  // null: the immediate `imm`
    int64_t stride;    // words between rows (0: one row for all)
    uint32_t imm;
};

__device__ __forceinline__ uint32_t col_word(const Col& c, int64_t r,
                                             int64_t j) {
    return c.p ? m31_reduce63((uint64_t)c.p[r * c.stride + j]) : c.imm;
}

struct qm31 {
    cm31 a, b;  // a + b u, u^2 = R = 2 + i
};

__device__ __forceinline__ uint32_t m31_neg(uint32_t x) {
    return x ? M31_P - x : 0;
}

__device__ __forceinline__ uint32_t m31_square_n(uint32_t x, int n) {
#pragma unroll
    for (int k = 0; k < n; ++k) x = m31_mul(x, x);
    return x;
}

// x^(p - 2) by the reference's addition chain (0 -> 0).
__device__ __forceinline__ uint32_t m31_inv(uint32_t x) {
    const uint32_t x3 = m31_mul(m31_mul(x, x), x);           // 2^2 - 1
    const uint32_t t4 = m31_mul(m31_square_n(x3, 2), x3);    // 2^4 - 1
    const uint32_t t8 = m31_mul(m31_square_n(t4, 4), t4);    // 2^8 - 1
    const uint32_t t16 = m31_mul(m31_square_n(t8, 8), t8);   // 2^16 - 1
    const uint32_t t24 = m31_mul(m31_square_n(t16, 8), t8);  // 2^24 - 1
    const uint32_t t28 = m31_mul(m31_square_n(t24, 4), t4);  // 2^28 - 1
    const uint32_t t29 = m31_mul(m31_mul(t28, t28), x);      // 2^29 - 1
    return m31_mul(m31_square_n(t29, 2), x);                 // 2^31 - 3
}

// The CM31 norm a^2 - R b^2 of a + b u.
__device__ __forceinline__ cm31 qm31_norm(qm31 x) {
    const cm31 bb = cm31_mul(x.b, x.b);
    const cm31 rbb = {m31_sub(m31_add(bb.re, bb.re), bb.im),
                      m31_add(bb.re, m31_add(bb.im, bb.im))};
    return cm31_sub(cm31_mul(x.a, x.a), rbb);
}

__device__ __forceinline__ uint32_t cm31_norm(cm31 n) {
    return m31_add(m31_mul(n.re, n.re), m31_mul(n.im, n.im));
}

// 1 / (a + b u) = (a - b u) / n from x, its CM31 norm n and the inverse of
// n's M31 norm.
__device__ __forceinline__ qm31 qm31_back(qm31 x, cm31 n, uint32_t minv) {
    const cm31 ninv = {m31_mul(n.re, minv), m31_mul(m31_neg(n.im), minv)};
    const cm31 an = cm31_mul(x.a, ninv), bn = cm31_mul(x.b, ninv);
    return {an, {m31_neg(bn.re), m31_neg(bn.im)}};
}

// 1 / x, zero mapping to zero.
__device__ __forceinline__ qm31 qm31_inv(qm31 x) {
    const cm31 n = qm31_norm(x);
    return qm31_back(x, n, m31_inv(cm31_norm(n)));
}

// x[k] = 1 / x[k] for every k, zero mapping to zero: one exponent chain
// for the batch (Montgomery's trick over the M31 norms; a zero norm, that
// of a zero element, enters the product as 1).
template <int B>
__device__ __forceinline__ void qm31_inv_batch(qm31 (&x)[B]) {
    cm31 n[B];
    uint32_t m[B], before[B];  // before[k]: m[0] .. m[k - 1]
    uint32_t acc = 1;
#pragma unroll
    for (int k = 0; k < B; ++k) {
        n[k] = qm31_norm(x[k]);
        const uint32_t mk = cm31_norm(n[k]);
        m[k] = mk ? mk : 1;
        before[k] = acc;
        acc = k ? m31_mul(acc, m[k]) : m[k];
    }
    uint32_t inv = m31_inv(acc);  // 1 / (m[0] .. m[k])
#pragma unroll
    for (int k = B - 1; k >= 0; --k) {
        const uint32_t mi = k ? m31_mul(inv, before[k]) : inv;
        if (k) inv = m31_mul(inv, m[k]);
        x[k] = qm31_back(x[k], n[k], mi);
    }
}

__device__ __forceinline__ qm31 load_qm31(const Col* c, int64_t r,
                                          int64_t j) {
    return {{col_word(c[0], r, j), col_word(c[1], r, j)},
            {col_word(c[2], r, j), col_word(c[3], r, j)}};
}

__device__ __forceinline__ qm31 qm31_scale(qm31 x, uint32_t s) {
    return {{m31_mul(x.a.re, s), m31_mul(x.a.im, s)},
            {m31_mul(x.b.re, s), m31_mul(x.b.im, s)}};
}

struct InvArgs {
    Col x[4], y[4], a, b;
    int64_t rows, n, rpt;
    int negate_b;
};

constexpr int INV_BATCH = 4;

// Rows b0 .. b0 + min(cnt, INV_BATCH) - 1 of column j of q; QM31 one past
// the end.
__device__ __forceinline__ void load_batch(const Col* q, int64_t b0,
                                           int64_t cnt, int64_t j,
                                           qm31 (&x)[INV_BATCH]) {
#pragma unroll
    for (int k = 0; k < INV_BATCH; ++k)
        x[k] = k < cnt ? load_qm31(q, b0 + k, j) : qm31{{1, 0}, {0, 0}};
}

// HAS_Y: the second term is there; Y_ONCE: y is one row for all rows.
template <bool HAS_Y, bool Y_ONCE>
__global__ void __launch_bounds__(256)
    qm31_inv_scaled_kernel(InvArgs g, int64_t* out) {
    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= g.n) return;
    const int64_t r0 = (int64_t)blockIdx.y * g.rpt;
    const int64_t r1 = r0 + g.rpt < g.rows ? r0 + g.rpt : g.rows;
    const int64_t plane = g.rows * g.n;
    qm31 y_once;
    if (HAS_Y && Y_ONCE) y_once = qm31_inv(load_qm31(g.y, 0, j));
    for (int64_t b0 = r0; b0 < r1; b0 += INV_BATCH) {
        const int64_t cnt = r1 - b0;
        qm31 o[INV_BATCH];
        load_batch(g.x, b0, cnt, j, o);
        qm31_inv_batch(o);
#pragma unroll
        for (int k = 0; k < INV_BATCH; ++k)
            if (k < cnt) o[k] = qm31_scale(o[k], col_word(g.a, b0 + k, j));
        if (HAS_Y) {
            qm31 t[INV_BATCH];
            if (!Y_ONCE) {
                load_batch(g.y, b0, cnt, j, t);
                qm31_inv_batch(t);
            }
#pragma unroll
            for (int k = 0; k < INV_BATCH; ++k) {
                if (k >= cnt) continue;
                uint32_t s = col_word(g.b, b0 + k, j);
                if (g.negate_b) s = m31_neg(s);
                const qm31 u = qm31_scale(Y_ONCE ? y_once : t[k], s);
                o[k] = {cm31_add(o[k].a, u.a), cm31_add(o[k].b, u.b)};
            }
        }
#pragma unroll
        for (int k = 0; k < INV_BATCH; ++k) {
            if (k >= cnt) continue;
            int64_t* p = out + (b0 + k) * g.n + j;
            p[0] = o[k].a.re;
            p[plane] = o[k].a.im;
            p[2 * plane] = o[k].b.re;
            p[3 * plane] = o[k].b.im;
        }
    }
}

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 16;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = m31_add(v, t);
    }
    return v;
}

// A tile's published word: its flag in the high half, a word mod p in the
// low half (one 64-bit store, so the two are seen together).
constexpr uint64_t TILE_SUM = 1ull << 32;    // the tile's own sum
constexpr uint64_t ROW_TOTAL = 2ull << 32;   // the row's sum up to its end

__device__ __forceinline__ uint32_t warp_sum_all(uint32_t v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = m31_add(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// The sum of the row before tile `tile` (its `t`-th), from the words the
// tiles before it have published; by the first warp, the result in every
// lane.
__device__ __forceinline__ uint32_t look_back(const uint64_t* status,
                                              int64_t tile, int64_t t,
                                              int lane) {
    const int64_t first = tile - t;  // the row's first tile: a ROW_TOTAL
    uint32_t sum = 0;
    for (int64_t look = tile - 1;; look -= 32) {
        const int64_t at = look - lane;
        uint64_t w = ROW_TOTAL;  // before the row: a total of 0
        if (at >= first) {
            const volatile uint64_t* p = status + at;
            do w = *p; while ((w >> 32) == 0);
        }
        const unsigned total = __ballot_sync(0xffffffffu, w >= ROW_TOTAL);
        const int stop = total ? __ffs(total) - 1 : 31;
        sum = m31_add(sum, warp_sum_all(lane <= stop ? (uint32_t)w : 0));
        if (total) return sum;
    }
}

// VEC: 16-byte aligned rows of an even length (two words a load/store).
// status: tiles + 1 zero words (the tiles' published words, then the
// counter that hands out tiles).
template <bool VEC>
__global__ void __launch_bounds__(SCAN_THREADS)
    exclusive_scan_kernel(const int64_t* in0, const int64_t* in1,
                          const int64_t* in2, const int64_t* in3,
                          int64_t* out, int64_t rows, int64_t n,
                          int64_t tiles_a_row, uint64_t* status) {
    __shared__ uint32_t warp_sum[SCAN_WARPS];
    __shared__ uint32_t row_before;
    __shared__ int64_t tile_of_block;
    if (threadIdx.x == 0)
        tile_of_block = (int64_t)atomicAdd(
            (unsigned long long*)(status + 4 * rows * tiles_a_row), 1ull);
    __syncthreads();
    const int64_t tile = tile_of_block;
    const int64_t row = tile / tiles_a_row, t = tile - row * tiles_a_row;
    const int c = (int)(row / rows);
    const int64_t* src =
        (c == 0 ? in0 : c == 1 ? in1 : c == 2 ? in2 : in3) +
        (row - c * rows) * n;
    int64_t* dst = out + row * n;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // A warp takes 512 words of the tile in rounds of 64: in round r lane
    // l holds words 64 r + 2 l and + 1 (each load and store of a warp one
    // run of 512 bytes).
    const int64_t w0 = t * SCAN_TILE + (int64_t)warp * (32 * SCAN_ITEMS);
    uint32_t v[SCAN_ITEMS];
#pragma unroll
    for (int r = 0; r < SCAN_ITEMS / 2; ++r) {
        const int64_t i = w0 + 64 * r + 2 * lane;
        if (VEC && i < n) {
            const longlong2 w = *reinterpret_cast<const longlong2*>(src + i);
            v[2 * r] = m31_reduce63((uint64_t)w.x);
            v[2 * r + 1] = m31_reduce63((uint64_t)w.y);
        } else {
            v[2 * r] = i < n ? m31_reduce63((uint64_t)src[i]) : 0;
            v[2 * r + 1] =
                i + 1 < n ? m31_reduce63((uint64_t)src[i + 1]) : 0;
        }
    }
    // The words, exclusive within the warp, in place; a round's pairs
    // scanned by shuffles, the rounds by a carry.
    uint32_t carry = 0;
#pragma unroll
    for (int r = 0; r < SCAN_ITEMS / 2; ++r) {
        const uint32_t pair = m31_add(v[2 * r], v[2 * r + 1]);
        const uint32_t incl = warp_inclusive(pair, lane);
        const uint32_t before = m31_add(carry, m31_sub(incl, pair));
        v[2 * r + 1] = m31_add(before, v[2 * r]);
        v[2 * r] = before;
        carry = m31_add(carry, __shfl_sync(0xffffffffu, incl, 31));
    }
    if (lane == 0) warp_sum[warp] = carry;
    __syncthreads();
    if (warp == 0) {
        uint32_t w = lane < SCAN_WARPS ? warp_sum[lane] : 0;
        w = warp_inclusive(w, lane);
        if (lane < SCAN_WARPS) warp_sum[lane] = w;
        const uint32_t own = __shfl_sync(0xffffffffu, w, SCAN_WARPS - 1);
        volatile uint64_t* mine = status + tile;
        if (t == 0) {
            if (lane == 0) {
                *mine = ROW_TOTAL | own;
                row_before = 0;
            }
        } else {
            if (lane == 0) *mine = TILE_SUM | own;
            const uint32_t before = look_back(status, tile, t, lane);
            if (lane == 0) {
                *mine = ROW_TOTAL | m31_add(before, own);
                row_before = before;
            }
        }
    }
    __syncthreads();
    uint32_t base = row_before;
    if (warp > 0) base = m31_add(base, warp_sum[warp - 1]);
#pragma unroll
    for (int r = 0; r < SCAN_ITEMS / 2; ++r) {
        const int64_t i = w0 + 64 * r + 2 * lane;
        const uint32_t a = m31_add(base, v[2 * r]);
        const uint32_t b = m31_add(base, v[2 * r + 1]);
        if (VEC && i < n) {
            longlong2 w;
            w.x = a;
            w.y = b;
            *reinterpret_cast<longlong2*>(dst + i) = w;
        } else {
            if (i < n) dst[i] = a;
            if (i + 1 < n) dst[i + 1] = b;
        }
    }
}

}  // namespace

// x0..x3, y0..y3, a, b: pointers or null (the operand's immediate); out:
// [4, rows, n] int64.  desc: rows, n, rows a thread, flags (1: y is there,
// 2: subtract the second term), then the ten operands' row strides, then
// their immediates (x0..x3, y0..y3, a, b).
extern "C" int qm31_inv_scaled(const void* x0, const void* x1,
                               const void* x2, const void* x3,
                               const void* y0, const void* y1,
                               const void* y2, const void* y3,
                               const void* a, const void* b, void* out,
                               const long long* desc, void* stream) {
    const void* ptrs[10] = {x0, x1, x2, x3, y0, y1, y2, y3, a, b};
    Col cols[10];
    for (int k = 0; k < 10; ++k)
        cols[k] = {(const int64_t*)ptrs[k], desc[4 + k],
                   (uint32_t)desc[14 + k]};
    InvArgs g;
    for (int k = 0; k < 4; ++k) {
        g.x[k] = cols[k];
        g.y[k] = cols[4 + k];
    }
    g.a = cols[8];
    g.b = cols[9];
    g.rows = desc[0];
    g.n = desc[1];
    g.rpt = desc[2];
    const bool has_y = desc[3] & 1;
    g.negate_b = (desc[3] & 2) != 0;
    if (g.rows < 0 || g.n < 0 || g.rpt < 1)
        return (int)cudaErrorInvalidValue;
    if (g.rows == 0 || g.n == 0) return 0;
    bool y_once = true;
    for (int k = 0; k < 4; ++k) y_once = y_once && g.y[k].stride == 0;
    const dim3 grid((unsigned)((g.n + 255) / 256),
                    (unsigned)((g.rows + g.rpt - 1) / g.rpt));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int64_t* o = (int64_t*)out;
    if (!has_y)
        qm31_inv_scaled_kernel<false, false><<<grid, 256, 0, s>>>(g, o);
    else if (y_once)
        qm31_inv_scaled_kernel<true, true><<<grid, 256, 0, s>>>(g, o);
    else
        qm31_inv_scaled_kernel<true, false><<<grid, 256, 0, s>>>(g, o);
    return (int)cudaGetLastError();
}

// in0..in3: [rows, n] int64 words each (contiguous); out: [4, rows, n],
// row k of coordinate c at out + (c rows + k) n; status: 4 rows
// ceil(n / 4096) + 1 zero words, which the kernel uses up.  vec (1 or 0)
// promises 16-byte aligned pointers and an even n.
extern "C" int m31_exclusive_scan(const void* in0, const void* in1,
                                  const void* in2, const void* in3,
                                  void* out, void* status, long long rows,
                                  long long n, int vec, void* stream) {
    if (rows < 0 || n < 0) return (int)cudaErrorInvalidValue;
    if (rows == 0 || n == 0) return 0;
    const long long tile = SCAN_THREADS * SCAN_ITEMS;
    const long long tiles_a_row = (n + tile - 1) / tile;
    const long long blocks = 4 * rows * tiles_a_row;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t *i0 = (const int64_t*)in0, *i1 = (const int64_t*)in1,
                  *i2 = (const int64_t*)in2, *i3 = (const int64_t*)in3;
    uint64_t* st = (uint64_t*)status;
    if (vec)
        exclusive_scan_kernel<true><<<(unsigned)blocks, SCAN_THREADS, 0, s>>>(
            i0, i1, i2, i3, (int64_t*)out, rows, n, tiles_a_row, st);
    else
        exclusive_scan_kernel<false><<<(unsigned)blocks, SCAN_THREADS, 0, s>>>(
            i0, i1, i2, i3, (int64_t*)out, rows, n, tiles_a_row, st);
    return (int)cudaGetLastError();
}
