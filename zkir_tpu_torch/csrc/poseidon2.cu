// K2: the width-16 Poseidon2 permutation over M31, and the ways the prover
// feeds it: a row sponge (Merkle leaves) from zero or resumed from stored
// states (the streaming prover's column blocks), a tree-level compression, a
// whole Merkle tree in one launch and the transcript's proof-of-work search.
//
// Replaces the Pallas kernel `poseidon2_permute_pallas`
// (zkir_tpu/ops/poseidon2.py, body `_poseidon2_kernel` with
// `_ext_matrix_2d` and `_internal_matrix_2d`), which permutes tiles of 1024
// states in VMEM.  Here one thread owns one state: its 16 words live in
// registers through all 22 rounds, and the round constants (external
// [8][16], internal [14], internal diagonal minus one [16]) sit in
// __constant__ memory, set once from `poseidon2_params()` by
// `p2_set_constants`.
//
// Round structure (as zkir_tpu/ops/poseidon2_ref.py): external matrix
// circ(2*M4, M4, M4, M4) first, 4 full rounds, 14 partial rounds with the
// internal matrix sum(x) + (diag - 1) * x, 4 full rounds; x^5 S-box.
//
// Bound on the H100: integer multiplies.  A permutation is 8*16*3 + 14*3
// S-box products plus 14*16 internal-matrix products = 650 32x32->64
// multiplies against 128 bytes of state moved, so the kernel is compute-
// bound; each thread's independent state keeps the multiply pipes busy
// without shared memory.  The sponge reads its row straight from the
// row-major matrix, one thread per row (loads are not coalesced; the rows
// are long, so each thread's line reads still hit cache).
//
// A tree's narrow levels are bound by latency instead: a level of a few
// nodes is one permutation's chain of dependent instructions, whatever
// the card's rate.  `merkle_tree_kernel` therefore builds every level of a
// tree in one launch (the reference fuses them into one XLA program,
// `_tree_levels_jit` in zkir_tpu/ops/merkle.py) and spreads a narrow
// level's permutations over 4 lanes each (`permute4`).
//
// Written in CUDA C++ rather than Triton: the state has to stay in 16
// named registers through 22 rounds, which a Triton block of tensors does
// not express, and the port's kernels share m31.cuh.
#include <cuda_runtime.h>
#include <string.h>

#include "bytes.cuh"
#include "m31.cuh"

#define WIDTH 16
#define RATE 8
#define ROUNDS_F 8
#define ROUNDS_P 14

__constant__ uint32_t c_external[ROUNDS_F][WIDTH];
__constant__ uint32_t c_internal[ROUNDS_P];
__constant__ uint32_t c_dm1[WIDTH];

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
    uint32_t x2 = m31_mul(x, x);
    uint32_t x4 = m31_mul(x2, x2);
    return m31_mul(x4, x);
}

// The Poseidon2 paper's M4 (eprint 2023/323, appendix B), in place.
__device__ __forceinline__ void apply_m4(uint32_t* b) {
    uint32_t t0 = m31_add(b[0], b[1]);
    uint32_t t1 = m31_add(b[2], b[3]);
    uint32_t t2 = m31_add(m31_add(b[1], b[1]), t1);
    uint32_t t3 = m31_add(m31_add(b[3], b[3]), t0);
    uint32_t t4 = m31_add(m31_add(m31_add(t1, t1), m31_add(t1, t1)), t3);
    uint32_t t5 = m31_add(m31_add(m31_add(t0, t0), m31_add(t0, t0)), t2);
    b[0] = m31_add(t3, t5);
    b[1] = t5;
    b[2] = m31_add(t2, t4);
    b[3] = t4;
}

__device__ __forceinline__ void external_matrix(uint32_t* x) {
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) apply_m4(x + 4 * blk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint32_t s = m31_add(m31_add(x[i], x[4 + i]),
                             m31_add(x[8 + i], x[12 + i]));
#pragma unroll
        for (int blk = 0; blk < 4; ++blk) x[4 * blk + i] = m31_add(x[4 * blk + i], s);
    }
}

__device__ __forceinline__ void internal_matrix(uint32_t* x) {
    uint64_t total = 0;  // 16 words < 2^35: one fold after the sum
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) total += x[i];
    uint32_t t = (uint32_t)(total & M31_P) + (uint32_t)(total >> 31);
    t = t >= M31_P ? t - M31_P : t;
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) x[i] = m31_add(t, m31_mul(x[i], c_dm1[i]));
}

__device__ __forceinline__ void full_round(uint32_t* x, int r) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) x[i] = sbox(m31_add(x[i], c_external[r][i]));
    external_matrix(x);
}

// The round loops stay rolled (a fully unrolled permutation inlined into
// every kernel crashes the device front end, cicc); every state index is
// still a compile-time constant, so the state stays in registers.
__device__ __forceinline__ void permute(uint32_t* x) {
    external_matrix(x);
#pragma unroll 1
    for (int r = 0; r < ROUNDS_F / 2; ++r) full_round(x, r);
#pragma unroll 1
    for (int r = 0; r < ROUNDS_P; ++r) {
        x[0] = sbox(m31_add(x[0], c_internal[r]));
        internal_matrix(x);
    }
#pragma unroll 1
    for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) full_round(x, r);
}

// [n, 16] -> [n, 16].
__global__ void permute_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out, int64_t n) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) x[k] = (uint32_t)in[i * WIDTH + k];
    permute(x);
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) out[i * WIDTH + k] = (int64_t)x[k];
}

// Row i of a row-major [n, w] matrix absorbed by a sponge: rate-8 blocks of
// the row, then (pad != 0) the 1||0* padding, which is appended even when w
// is a multiple of 8; with pad == 0, w % 8 == 0.  RESUME == false: the
// state starts at zero and `out` [n, 8] receives the digest (p2_sponge_rows,
// the leaves of a Merkle tree).  RESUME == true: `out` [n, 16] holds the
// states, read before and written after (p2_sponge_absorb, a row sponge fed
// one column block at a time by the streaming prover; the reference's
// `_absorb_blocks` and `RowSponge.finalize`).
template <bool RESUME>
__global__ void sponge_rows_kernel(const int64_t* __restrict__ mat,
                                   int64_t* __restrict__ out, int64_t n,
                                   int64_t w, int pad) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t* row = mat + i * w;
    int64_t padded_w = pad ? ((w + 1 + RATE - 1) / RATE) * RATE : w;
    uint32_t x[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) x[k] = RESUME ? (uint32_t)out[i * WIDTH + k] : 0u;
    for (int64_t off = 0; off < padded_w; off += RATE) {
        if (off + RATE <= w) {
#pragma unroll
            for (int k = 0; k < RATE; ++k) x[k] = m31_add(x[k], (uint32_t)row[off + k]);
        } else {
#pragma unroll
            for (int k = 0; k < RATE; ++k) {
                int64_t j = off + k;
                uint32_t v = j < w ? (uint32_t)row[j] : (j == w ? 1u : 0u);
                x[k] = m31_add(x[k], v);
            }
        }
        permute(x);
    }
    if (RESUME) {
#pragma unroll
        for (int k = 0; k < WIDTH; ++k) out[i * WIDTH + k] = (int64_t)x[k];
    } else {
#pragma unroll
        for (int k = 0; k < RATE; ++k) out[i * RATE + k] = (int64_t)x[k];
    }
}

// One Merkle level: [2m, 8] -> [m, 8], node i = permute(l || r)[:8] + l with
// l, r = rows 2i, 2i + 1.
__global__ void compress_level_kernel(const int64_t* __restrict__ in,
                                      int64_t* __restrict__ out, int64_t m) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    uint32_t x[WIDTH], l[RATE];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) x[k] = (uint32_t)in[2 * i * RATE + k];
#pragma unroll
    for (int k = 0; k < RATE; ++k) l[k] = x[k];
    permute(x);
#pragma unroll
    for (int k = 0; k < RATE; ++k) out[i * RATE + k] = (int64_t)m31_add(x[k], l[k]);
}

// ---------------------------------------------------------------------------
// The permutation spread over 4 lanes, a block of 4 words a lane (lane b of
// a 4-lane group holds words 4b .. 4b + 3): a narrow tree level's latency.
// One thread's permutation is some 8,000 instructions in a chain
// (`permute`, about 12 us on the H100); here M4 is the lane's own, each
// lane runs a quarter of the S-boxes, and each matrix's sum crosses the
// group in two shuffles.  Every lane of the warp takes part (the full
// mask); `b` is the lane's block, `cst` the round constants staged in
// shared memory (a lane-dependent index into __constant__ memory would
// serialise).

#define FULL_MASK 0xffffffffu

struct P2Constants {
    uint32_t external[ROUNDS_F][WIDTH];
    uint32_t internal[ROUNDS_P];
    uint32_t dm1[WIDTH];
};

__device__ __forceinline__ void stage_constants(P2Constants* cst, int tid, int threads) {
    for (int i = tid; i < ROUNDS_F * WIDTH; i += threads)
        (&cst->external[0][0])[i] = (&c_external[0][0])[i];
    for (int i = tid; i < ROUNDS_P; i += threads) cst->internal[i] = c_internal[i];
    for (int i = tid; i < WIDTH; i += threads) cst->dm1[i] = c_dm1[i];
}

__device__ __forceinline__ void external_matrix4(uint32_t* x) {
    apply_m4(x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        uint32_t s = m31_add(x[i], __shfl_xor_sync(FULL_MASK, x[i], 1));
        s = m31_add(s, __shfl_xor_sync(FULL_MASK, s, 2));
        x[i] = m31_add(x[i], s);
    }
}

__device__ __forceinline__ void full_round4(uint32_t* x, int b, int r, const P2Constants* cst) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = sbox(m31_add(x[i], cst->external[r][4 * b + i]));
    external_matrix4(x);
}

__device__ __forceinline__ void permute4(uint32_t* x, int b, const P2Constants* cst) {
    external_matrix4(x);
#pragma unroll 1
    for (int r = 0; r < ROUNDS_F / 2; ++r) full_round4(x, b, r, cst);
    uint32_t dm1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) dm1[i] = cst->dm1[4 * b + i];
#pragma unroll 1
    for (int r = 0; r < ROUNDS_P; ++r) {
        // Word 0's S-box and the sum of the other 15 words run side by
        // side; lane 0's result then reaches its group by one shuffle.
        const uint32_t head = __shfl_sync(FULL_MASK, sbox(m31_add(x[0], cst->internal[r])), 0, 4);
        const uint32_t x0 = b == 0 ? head : x[0];
        uint32_t rest = m31_add(m31_add(b == 0 ? 0u : x[0], x[1]), m31_add(x[2], x[3]));
        rest = m31_add(rest, __shfl_xor_sync(FULL_MASK, rest, 1));
        rest = m31_add(rest, __shfl_xor_sync(FULL_MASK, rest, 2));
        const uint32_t total = m31_add(rest, head);
        x[0] = m31_add(total, m31_mul(x0, dm1[0]));
#pragma unroll
        for (int i = 1; i < 4; ++i) x[i] = m31_add(total, m31_mul(x[i], dm1[i]));
    }
#pragma unroll 1
    for (int r = ROUNDS_F / 2; r < ROUNDS_F; ++r) full_round4(x, b, r, cst);
}

// ---------------------------------------------------------------------------
// A whole Merkle tree in one launch: leaves [n, 8] -> levels 1 .. log2 n in
// one [n - 1, 8] buffer, level j (n >> j nodes) from row n - (n >> (j - 1)),
// the root last.  Node i of a level is permute(l || r)[:8] + l, l and r
// rows 2i and 2i + 1 of the level below (compress_level_kernel's function).
//
// A unit is a subtree of up to TREE_LEAVES nodes of one level: a CTA loads
// them into shared memory (as uint32, 32 bytes a node), builds the unit's
// levels there, a __syncthreads between levels, and writes each level to
// global memory as it goes (int64, coalesced).  Each CTA starts with a unit
// of leaves.  When it is done it takes a ticket on its group (the
// TREE_LEAVES units whose roots are the next tier's unit); the last CTA of
// the group to finish builds that unit, and so on up to the root.  So the
// tree's top never waits for a second launch, and a tier's first level
// runs at the width of a whole CTA.  The tickets are the library's own
// (g_tree_tickets); the entry point resets those a launch needs on the
// stream before it, so tree launches on one device must not overlap.
//
// A level of at most TREE_LANE_NODES nodes runs 4 lanes a node (permute4,
// about 4.5 us a level on the H100); a wider one a thread a node (permute,
// which needs fewer instructions a node where the level fills the card).
// TREE_THREADS and TREE_LANE_NODES were chosen by measurement
// (tools/merkle_bench.py; the designs and their times are in PERF.md).

#ifndef TREE_THREADS
#define TREE_THREADS 256
#endif
#define NODE_LANES 4  // lanes a node in permute4
#ifndef TREE_LANE_NODES
#define TREE_LANE_NODES (TREE_THREADS / NODE_LANES)
#endif
#define TREE_LEAVES (2 * TREE_THREADS)
#define TREE_MAX_TICKETS 65536

static_assert(TREE_LANE_NODES * NODE_LANES <= TREE_THREADS, "a level's lanes must fit the CTA");

static int ilog2(long long x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

__device__ unsigned int g_tree_tickets[TREE_MAX_TICKETS];

// First row of level j (>= 1) in the [n - 1, 8] buffer.
__device__ __forceinline__ long long level_row(long long n, int j) {
    return n - (n >> (j - 1));
}

__global__ void __launch_bounds__(TREE_THREADS)
merkle_tree_kernel(const int64_t* __restrict__ leaves, int64_t* __restrict__ out, int log_n) {
    __shared__ __align__(16) uint32_t buf_a[TREE_LEAVES * RATE];
    __shared__ __align__(16) uint32_t buf_b[TREE_LEAVES / 2 * RATE];
    __shared__ P2Constants cst;
    __shared__ int last;
    const int tid = threadIdx.x;
    const long long n = 1ll << log_n;
    stage_constants(&cst, tid, TREE_THREADS);  // read after the first __syncthreads

    int in_level = 0;            // the level a unit starts from
    long long unit = blockIdx.x;
    long long tickets = 0;       // first ticket of the next tier's units
    for (;;) {
        const long long width = n >> in_level;                  // nodes at in_level
        const int count = (int)(width < TREE_LEAVES ? width : TREE_LEAVES);
        const long long first = unit * TREE_LEAVES;
        if (in_level == 0) {
            const int64_t* src = leaves + first * RATE;
            for (int i = tid; i < count * RATE; i += TREE_THREADS) buf_a[i] = (uint32_t)src[i];
        } else {
            // Roots written by other CTAs: read through L2, never a stale L1 line.
            const long long* src = (const long long*)out + (level_row(n, in_level) + first) * RATE;
            for (int i = tid; i < count * RATE; i += TREE_THREADS) buf_a[i] = (uint32_t)__ldcg(src + i);
        }
        __syncthreads();

        uint32_t* cur = buf_a;
        uint32_t* nxt = buf_b;
        int level = in_level;
        for (int m = count / 2; m >= 1; m /= 2) {
            ++level;
            if (m <= TREE_LANE_NODES) {
                // Whole warps only (the shuffles' full mask): a lane past the
                // level's nodes repeats the last node and stores nothing.
                if ((tid & ~31) < m * NODE_LANES) {
                    const int node = min(tid / NODE_LANES, m - 1);
                    const int b = tid % NODE_LANES;
                    const bool store = tid < m * NODE_LANES;
                    const uint4 v = *(const uint4*)(cur + WIDTH * node + 4 * b);
                    uint32_t x[4] = {v.x, v.y, v.z, v.w};
                    permute4(x, b, &cst);
                    if (store && b < RATE / 4)  // the lanes of the left child's words
                        *(uint4*)(nxt + RATE * node + 4 * b) =
                            make_uint4(m31_add(x[0], v.x), m31_add(x[1], v.y),
                                       m31_add(x[2], v.z), m31_add(x[3], v.w));
                }
            } else if (tid < m) {
                uint32_t x[WIDTH], l[RATE];
                const uint4* src = (const uint4*)(cur + 16 * tid);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const uint4 v = src[q];
                    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
                }
#pragma unroll
                for (int k = 0; k < RATE; ++k) l[k] = x[k];
                permute(x);
                uint4* dst = (uint4*)(nxt + RATE * tid);
                dst[0] = make_uint4(m31_add(x[0], l[0]), m31_add(x[1], l[1]),
                                    m31_add(x[2], l[2]), m31_add(x[3], l[3]));
                dst[1] = make_uint4(m31_add(x[4], l[4]), m31_add(x[5], l[5]),
                                    m31_add(x[6], l[6]), m31_add(x[7], l[7]));
            }
            __syncthreads();
            int64_t* dst = out + (level_row(n, level) + (first >> (level - in_level))) * RATE;
            for (int i = tid; i < m * RATE; i += TREE_THREADS) dst[i] = (int64_t)nxt[i];
            uint32_t* t = cur;
            cur = nxt;
            nxt = t;
        }
        if (level == log_n) return;  // this unit's root is the tree's

        // Publish this unit's root, then take the group's ticket.
        const long long units = width / TREE_LEAVES;  // >= 2 units at this tier
        const long long parent = unit / TREE_LEAVES;
        const long long group = units < TREE_LEAVES ? units : TREE_LEAVES;
        __threadfence();
        __syncthreads();
        if (tid == 0)
            last = atomicAdd(&g_tree_tickets[tickets + parent], 1u) == (unsigned)(group - 1);
        __syncthreads();
        if (!last) return;
        __threadfence();
        tickets += (units + TREE_LEAVES - 1) / TREE_LEAVES;
        in_level = level;
        unit = parent;
    }
}

// ---------------------------------------------------------------------------
// The interpreter's Poseidon2 syscalls, every paused lane's in one launch:
// rows of bytes that lie anywhere in `data` (the lanes' memory images), row
// i at data + offsets[i], lengths[i] bytes, each hashed as the reference's
// `poseidon2_sponge_hash_bytes` (zkir_tpu/ops/poseidon2_ref.py) hashes one:
// 4-byte little-endian words mod p (a short last word zero-extended), a 1
// after the last word, zeros to a whole rate-8 block; each block added into
// the rate of the state (from zero) and permuted; the digest is the first 8
// words.  Digest i goes to row rows[i] of `out` [k, 8]: the host hands the
// rows over in descending count of blocks, so the rows of a warp end
// together, and this puts each digest back in the caller's order.
//
// The port's earlier path gathered every row into an int64 tensor of
// 8 * blocks words, made its words with torch operations, and launched
// p2_permute once a block position (94 launches for a 3,000-byte row).
// Here the bytes are read where they lie, a row's state stays in registers
// through all its blocks, and the whole batch is one launch.
//
// Bound: a row of b blocks is a chain of b permutations, so the batch takes
// at least its longest row's blocks times one permutation's latency; its
// blocks times a permutation's instructions at the card's issue rate is the
// other bound.  A round's rows are some thousands, so the chain sets the
// time, and a row is spread over 4 lanes (permute4: M4 inside a lane, each
// matrix's sum in two shuffles): a shorter chain than a thread a row's, for
// 1.4 times the instructions.  At the crypto service's shapes it took about
// 0.6 times a thread a row's time on the H100 (PERF.md).

#define SPONGE_THREADS 128

// A 32-bit word mod p.
__device__ __forceinline__ uint32_t m31_from_u32(uint32_t w) {
    const uint32_t r = (w & M31_P) + (w >> 31);
    return r >= M31_P ? r - M31_P : r;
}

// N words from word w0 of a row of len bytes, after the sponge's padding:
// each 4 little-endian bytes mod p (the last zero-extended), then a 1 at
// the row's count of words, zeros beyond.
template <int N>
__device__ __forceinline__ void sponge_words(const uint8_t* msg, long long len,
                                             long long w0, uint32_t* w) {
    const long long q = 4 * w0;
    if (q + 4 * N <= len) {
        load_le_words<N>(msg + q, w);
#pragma unroll
        for (int k = 0; k < N; ++k) w[k] = m31_from_u32(w[k]);
        return;
    }
    const long long pad = (len + 3) / 4 * 4;   // the 1's byte offset
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const long long b = q + 4 * k;
        uint32_t x = 0;
#pragma unroll
        for (int j = 3; j >= 0; --j) x = (x << 8) | msg_byte(msg, b + j, len, 0u);
        w[k] = b == pad ? 1u : m31_from_u32(x);
    }
}

__global__ void __launch_bounds__(SPONGE_THREADS)
sponge_bytes_kernel(const uint8_t* __restrict__ data,
                    const int64_t* __restrict__ offsets,
                    const int64_t* __restrict__ lengths,
                    const int64_t* __restrict__ rows, int64_t* __restrict__ out,
                    long long k) {
    __shared__ P2Constants cst;
    stage_constants(&cst, threadIdx.x, SPONGE_THREADS);
    __syncthreads();
    // Lane b of a row's 4 holds state words 4b .. 4b + 3; lanes 0 and 1
    // hold the rate.  Every lane of the warp runs the warp's most blocks
    // (the shuffles' full mask); a row's digest is taken after its own
    // last block, and a lane past it or past the last row permutes on.
    const long long t = blockIdx.x * (long long)SPONGE_THREADS + threadIdx.x;
    const long long i = t / 4;
    const int b = (int)(t % 4);
    const bool live = i < k;
    const long long len = live ? lengths[i] : 0;
    const uint8_t* msg = data + (live ? offsets[i] : 0);
    const long long blocks = live ? (len + 3) / 4 / RATE + 1 : 0;
    const long long most = __reduce_max_sync(FULL_MASK, (unsigned)blocks);
    uint32_t x[4] = {0, 0, 0, 0}, digest[4];
    for (long long j = 0; j < most; ++j) {
        if (b < RATE / 4 && j < blocks) {
            uint32_t w[4];
            sponge_words<4>(msg, len, RATE * j + 4 * b, w);
#pragma unroll
            for (int q = 0; q < 4; ++q) x[q] = m31_add(x[q], w[q]);
        }
        permute4(x, b, &cst);
        if (j + 1 == blocks) {
#pragma unroll
            for (int q = 0; q < 4; ++q) digest[q] = x[q];
        }
    }
    if (live && b < RATE / 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) out[RATE * rows[i] + 4 * b + q] = digest[q];
    }
}

// Proof-of-work search: the lowest nonce >= start whose trial state,
// `state` with word 0 replaced by (state[0] + nonce) mod p, permutes to a
// word RATE - 1 with its low `bits` bits clear (the transcript's next draw).
// Each thread forms its candidates in registers and walks nonces
// grid-stride in increasing order; a hit goes into `result` by atomicMin,
// and a thread stops once `result` is below its next nonce.  A nonce below
// the final result is therefore always tried by its thread, so the lowest
// hit wins whatever the grid.  `result` starts at all ones; it stays so if
// no nonce below `limit` hits.  The state travels by value, in the launch's
// parameters.

struct GrindState {
    uint32_t w[WIDTH];
};

#define GRIND_THREADS 128
#ifndef GRIND_BLOCKS_PER_SM
#define GRIND_BLOCKS_PER_SM 2
#endif

__device__ unsigned long long g_grind_result;

__global__ void __launch_bounds__(GRIND_THREADS)
grind_kernel(GrindState state, uint32_t mask, unsigned long long start,
             unsigned long long limit) {
    const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
    unsigned long long nonce =
        start + (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
    volatile unsigned long long* result = &g_grind_result;
#pragma unroll 1
    for (; nonce < limit; nonce += stride) {
        if (*result < nonce) return;
        uint32_t x[WIDTH];
#pragma unroll
        for (int k = 1; k < WIDTH; ++k) x[k] = state.w[k];
        x[0] = (uint32_t)((state.w[0] + nonce) % M31_P);
        permute(x);
        if ((x[RATE - 1] & mask) == 0) {
            atomicMin(&g_grind_result, nonce);
            return;
        }
    }
}

static unsigned blocks_for(long long n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

extern "C" int p2_set_constants(const void* external, const void* internal,
                                const void* dm1) {
    cudaError_t e = cudaMemcpyToSymbol(c_external, external, sizeof(c_external));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_internal, internal, sizeof(c_internal));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_dm1, dm1, sizeof(c_dm1));
    return (int)e;
}

extern "C" int p2_permute(const void* in, void* out, long long n, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    permute_kernel<<<blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)in, (int64_t*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int p2_sponge_rows(const void* mat, void* out, long long n,
                              long long w, int pad, void* stream) {
    if (n <= 0) return 0;
    if (!pad && w % RATE != 0) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    sponge_rows_kernel<false><<<blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)mat, (int64_t*)out, n, w, pad);
    return (int)cudaGetLastError();
}

// states: [n, 16], read and written in place; blocks: [n, w] row-major.
extern "C" int p2_sponge_absorb(void* states, const void* blocks, long long n,
                                long long w, int pad, void* stream) {
    if (n <= 0) return 0;
    if (w < 0 || (!pad && w % RATE != 0)) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    sponge_rows_kernel<true><<<blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)blocks, (int64_t*)states, n, w, pad);
    return (int)cudaGetLastError();
}

extern "C" int p2_compress_level(const void* in, void* out, long long m,
                                 void* stream) {
    if (m <= 0) return 0;
    const int threads = 128;
    compress_level_kernel<<<blocks_for(m, threads), threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)in, (int64_t*)out, m);
    return (int)cudaGetLastError();
}

// offsets, lengths, rows: [k] (rows in descending count of blocks, see
// sponge_bytes_kernel); out: [k, 8], row i's digest in row rows[i].
extern "C" int p2_sponge_bytes(const void* data, const void* offsets,
                               const void* lengths, const void* rows, void* out,
                               long long k, void* stream) {
    if (k <= 0) return 0;
    sponge_bytes_kernel<<<blocks_for(4 * k, SPONGE_THREADS), SPONGE_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int64_t*)offsets, (const int64_t*)lengths,
        (const int64_t*)rows, (int64_t*)out, k);
    return (int)cudaGetLastError();
}

// leaves: [n, 8], n a power of two >= 2; out: [n - 1, 8].
extern "C" int p2_merkle_tree(const void* leaves, void* out, long long n,
                              void* stream) {
    if (n < 2 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    long long units = n / TREE_LEAVES > 1 ? n / TREE_LEAVES : 1;
    long long tickets = 0;
    for (long long u = units; u > 1;) {
        u = (u + TREE_LEAVES - 1) / TREE_LEAVES;
        tickets += u;
    }
    if (tickets > TREE_MAX_TICKETS) return (int)cudaErrorInvalidValue;
    if (tickets) {
        void* counters = nullptr;
        cudaError_t e = cudaGetSymbolAddress(&counters, g_tree_tickets);
        if (e == cudaSuccess)
            e = cudaMemsetAsync(counters, 0, tickets * sizeof(unsigned int), st);
        if (e != cudaSuccess) return (int)e;
    }
    merkle_tree_kernel<<<(unsigned)units, TREE_THREADS, 0, st>>>(
        (const int64_t*)leaves, (int64_t*)out, ilog2(n));
    return (int)cudaGetLastError();
}

// The one entry point that synchronises: state is 16 host uint32 words,
// nonce a host long long that receives the lowest hitting nonce (-1 if
// none below `limit`).  The result word is the library's own
// (g_grind_result), reset on the stream, read back through a pinned host
// word, so searches must not overlap.  The grid is GRIND_BLOCKS_PER_SM
// CTAs an SM, or 2^bits trials if that is fewer; a search that misses in
// its first round walks on.  At 2 CTAs an SM a round of one permutation a
// thread takes about one permutation's latency (some 12 us on the H100);
// at 4 it takes twice as long, the SMs' issue rate reached, so the
// expected 2^bits trials cost fewer microseconds at 2 (tools/merkle_bench.py,
// PERF.md).
extern "C" int p2_grind(const void* state, int bits, long long start,
                        long long limit, void* nonce, void* stream) {
    if (bits < 1 || bits > 31 || start < 0 || limit <= start)
        return (int)cudaErrorInvalidValue;
    static unsigned long long* pinned = nullptr;
    static int sms = 0;
    cudaError_t e = cudaSuccess;
    if (!pinned) e = cudaHostAlloc((void**)&pinned, sizeof(*pinned), cudaHostAllocDefault);
    if (e == cudaSuccess && !sms) {
        int device = 0;
        e = cudaGetDevice(&device);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    void* result = nullptr;
    if (e == cudaSuccess) e = cudaGetSymbolAddress(&result, g_grind_result);
    if (e != cudaSuccess) return (int)e;

    const cudaStream_t st = (cudaStream_t)stream;
    GrindState s;
    memcpy(s.w, state, sizeof(s.w));
    long long blocks = blocks_for(1ll << bits, GRIND_THREADS);
    if (blocks > (long long)sms * GRIND_BLOCKS_PER_SM) blocks = (long long)sms * GRIND_BLOCKS_PER_SM;
    e = cudaMemsetAsync(result, 0xff, sizeof(unsigned long long), st);
    if (e != cudaSuccess) return (int)e;
    grind_kernel<<<(unsigned)blocks, GRIND_THREADS, 0, st>>>(
        s, (1u << bits) - 1u, (unsigned long long)start, (unsigned long long)limit);
    e = cudaGetLastError();
    if (e == cudaSuccess)
        e = cudaMemcpyAsync(pinned, result, sizeof(*pinned), cudaMemcpyDeviceToHost, st);
    if (e == cudaSuccess) e = cudaStreamSynchronize(st);
    if (e == cudaSuccess) *(long long*)nonce = (long long)*pinned;
    return (int)e;
}
