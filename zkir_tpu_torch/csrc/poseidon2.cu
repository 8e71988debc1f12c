// K2: the width-16 Poseidon2 permutation over M31, and the ways the prover
// feeds it: a row sponge (Merkle leaves), a tree-level compression and the
// transcript's proof-of-work search.
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
// Written in CUDA C++ rather than Triton: the state has to stay in 16
// named registers through 22 rounds, which a Triton block of tensors does
// not express, and the port's kernels share m31.cuh.
#include <cuda_runtime.h>

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

// Row i of a row-major [n, w] matrix -> its 8-word sponge digest: absorb
// rate-8 blocks of the row, then (pad != 0) the 1||0* padding, which is
// appended even when w is a multiple of 8.  With pad == 0, w % 8 == 0.
__global__ void sponge_rows_kernel(const int64_t* __restrict__ mat,
                                   int64_t* __restrict__ out, int64_t n,
                                   int64_t w, int pad) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t* row = mat + i * w;
    int64_t padded_w = pad ? ((w + 1 + RATE - 1) / RATE) * RATE : w;
    uint32_t x[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) x[k] = 0;
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
#pragma unroll
    for (int k = 0; k < RATE; ++k) out[i * RATE + k] = (int64_t)x[k];
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

// Proof-of-work search: the lowest nonce >= start whose trial state,
// `state` with word 0 replaced by (state[0] + nonce) mod p, permutes to a
// word RATE - 1 with its low `bits` bits clear (the transcript's next draw).
// Each thread forms its candidates in registers and walks nonces
// grid-stride in increasing order; a hit goes into `result` by atomicMin,
// and a thread stops once `result` is below its next nonce.  A nonce below
// the final result is therefore always tried by its thread, so the lowest
// hit wins whatever the grid.  `result` starts at all ones; it stays so if
// no nonce below `limit` hits.
__global__ void grind_kernel(const int64_t* __restrict__ state, uint32_t mask,
                             unsigned long long start, unsigned long long limit,
                             unsigned long long* result) {
    const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
    unsigned long long nonce =
        start + (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
    uint32_t base[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) base[k] = (uint32_t)state[k];
#pragma unroll 1
    for (; nonce < limit; nonce += stride) {
        if (*(volatile unsigned long long*)result < nonce) return;
        uint32_t x[WIDTH];
#pragma unroll
        for (int k = 1; k < WIDTH; ++k) x[k] = base[k];
        x[0] = (uint32_t)((base[0] + nonce) % M31_P);
        permute(x);
        if ((x[RATE - 1] & mask) == 0) {
            atomicMin(result, nonce);
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
    sponge_rows_kernel<<<blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)mat, (int64_t*)out, n, w, pad);
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

// state: 16 words; result: one 8-byte word, all ones on entry.  The grid
// holds the expected number of trials (2^bits; a search that misses in its
// first round walks on), up to the card's 132 SMs x 2,048 threads.
extern "C" int p2_grind(const void* state, int bits, long long start,
                        long long limit, void* result, void* stream) {
    if (bits < 1 || bits > 31 || start < 0 || limit <= start)
        return (int)cudaErrorInvalidValue;
    const int threads = 128;
    long long want = 1ll << (bits > 18 ? 18 : bits);
    unsigned blocks = blocks_for(want, threads);
    if (blocks > 132 * 16) blocks = 132 * 16;
    grind_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)state, (1u << bits) - 1u, (unsigned long long)start,
        (unsigned long long)limit, (unsigned long long*)result);
    return (int)cudaGetLastError();
}
