// K4: batched SHA-256, Keccak-256 and BLAKE3 over byte strings that lie
// anywhere in one device buffer: the interpreter's crypto syscalls of all
// paused lanes at once, read straight from the lanes' memory images.
//
// Replaces the reference's jitted batch functions (XLA, not Pallas):
// `sha256_compress_batch` / `sha256_compress_batch_with_witness` /
// `sha256_many` (zkir_tpu/ops/sha256.py:32, :87, :94), `keccak_f1600_batch`
// / `keccak256_many` (zkir_tpu/ops/keccak.py:30, :73) and
// `b3_compress_batch` / `blake3_many` (zkir_tpu/ops/blake3.py:61, :107).
// The reference pads every message on the host and advances all streams
// one block at a time, a masked `lax.scan` step a block (shorter messages
// idle through the longest one's blocks), and merges each BLAKE3 tree in a
// host loop of one-row compressions.  Here one thread owns one message
// (SHA-256, Keccak, one BLAKE3 compression) or one BLAKE3 chunk: it reads
// its own bytes from (data + offsets[i], lengths[i]), pads them itself as
// it goes, keeps the whole state in registers through all its blocks, and
// stores the result once.  So a message costs its own blocks, and nothing
// is staged in device memory between blocks.
//
// Entry points (every array int64 unless said otherwise; data is bytes):
//   sha256_blocks  one thread a message: its blocks from the state given
//                  (or H0), with SHA-256's padding (`pad`) or whole 64-byte
//                  blocks; optionally a one-block row's 64 round states.
//   keccak_absorb  one thread a message: its 136-byte blocks XORed into
//                  the rate of the state given (or zero), each followed by
//                  keccak-f[1600], with the original Keccak padding
//                  (0x01 ... 0x80) or whole blocks.
//   b3_rows        whole BLAKE3 messages: a lane a chunk (its blocks
//                  chained from the IV with CHUNK_START / CHUNK_END and the
//                  64-bit chunk counter), a message's lanes inside one
//                  warp, its tree merged there by shuffles (PARENT, ROOT
//                  on the last compression), one digest a message.  It
//                  replaces the earlier path of a chunk kernel and a
//                  b3_compress launch a tree level, with per-chunk arrays
//                  and a numpy loop a level on the host.
//   b3_compress    one compression a row: the reference's
//                  `b3_compress_batch`.
//
// Bound on the H100: integer instructions.  A message moves its bytes once
// (a few hundred bytes) and runs 64 rounds a 64-byte block (SHA-256), 24
// rounds a 136-byte block (Keccak) or 7 rounds a 64-byte block (BLAKE3):
// some 10-30 instructions a byte against the card's 10 instructions a byte
// of memory rate.  Every message is independent, so a thread a message
// keeps the pipes busy without shared memory.  Loads are one thread's own
// bytes, not coalesced; a whole block inside the message is read as the
// aligned words that hold it (shifted together where it is unaligned), a
// last partial block byte by byte.
//
// Written in CUDA C++ rather than Triton: a message's state has to stay in
// named registers through all its blocks, each row has its own count of
// blocks, and Keccak rotates 64-bit words.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bytes.cuh"

#define SHA_BLOCK 64
#define KECCAK_RATE 136
#define B3_BLOCK 64
#define B3_CHUNK 1024
#define B3_CHUNK_START 1u
#define B3_CHUNK_END 2u
#define B3_PARENT 4u
#define B3_ROOT 8u

__constant__ uint32_t c_sha256_k[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

// SHA-256's initial state; BLAKE3's IV is the same eight words.
__constant__ uint32_t c_iv[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                                 0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                                 0x1F83D9ABu, 0x5BE0CD19u};

__constant__ uint64_t c_keccak_rc[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

static inline unsigned crypto_grid(long long n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

// ---------------------------------------------------------------------------
// SHA-256
// ---------------------------------------------------------------------------

// One compression of block w (16 big-endian words, overwritten by the
// schedule) into h; with `wit`, the state after each round (a..h) as
// int64 [64][8].
__device__ __forceinline__ void sha256_compress(uint32_t* h, uint32_t* w,
                                                int64_t* wit) {
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
    for (int r = 0; r < 64; ++r) {
        uint32_t wr;
        if (r < 16) {
            wr = w[r];
        } else {
            const uint32_t w1 = w[(r + 1) & 15], w14 = w[(r + 14) & 15];
            const uint32_t s0 = rotr32(w1, 7) ^ rotr32(w1, 18) ^ (w1 >> 3);
            const uint32_t s1 = rotr32(w14, 17) ^ rotr32(w14, 19) ^ (w14 >> 10);
            wr = w[r & 15] + s0 + w[(r + 9) & 15] + s1;
            w[r & 15] = wr;
        }
        const uint32_t t1 = hh + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25))
                            + ((e & f) ^ (~e & g)) + c_sha256_k[r] + wr;
        const uint32_t t2 = (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22))
                            + ((a & b) ^ (a & c) ^ (b & c));
        hh = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
        if (wit) {
            int64_t* o = wit + 8 * r;
            o[0] = a; o[1] = b; o[2] = c; o[3] = d;
            o[4] = e; o[5] = f; o[6] = g; o[7] = hh;
        }
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// Block b of a message (offset q = 64 b), padded or not: a whole block
// inside the message as word loads, the rest byte by byte.
__device__ __forceinline__ void sha256_block(const uint8_t* msg, long long q,
                                             long long len, bool pad,
                                             bool last, uint32_t* w) {
    if (q + SHA_BLOCK <= len) {
        load_le_words<16>(msg + q, w);
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = __byte_perm(w[j], 0, 0x0123);
        return;
    }
    const uint32_t first = pad ? 0x80u : 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        uint32_t x = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) x = (x << 8) | msg_byte(msg, q + 4 * j + k, len, first);
        w[j] = x;
    }
    if (pad && last) {                  // the message's length in bits
        const unsigned long long bits = (unsigned long long)len * 8ull;
        w[14] = (uint32_t)(bits >> 32);
        w[15] = (uint32_t)bits;
    }
}

template <bool WITNESS>
__global__ void sha256_kernel(const uint8_t* __restrict__ data,
                              const int64_t* __restrict__ offsets,
                              const int64_t* __restrict__ lengths,
                              const int64_t* __restrict__ states_in,
                              int64_t* __restrict__ states_out,
                              int64_t* __restrict__ witness, long long n,
                              int pad) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long len = lengths[i];
    const uint8_t* msg = data + offsets[i];
    uint32_t h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
        h[k] = states_in ? (uint32_t)states_in[8 * i + k] : c_iv[k];
    // Padding adds 0x80 and the 8-byte length: (len + 9) bytes, rounded up.
    const long long blocks = pad ? (len + 9 + SHA_BLOCK - 1) / SHA_BLOCK
                                 : len / SHA_BLOCK;
    for (long long b = 0; b < blocks; ++b) {
        uint32_t w[16];
        sha256_block(msg, b * SHA_BLOCK, len, pad, b == blocks - 1, w);
        sha256_compress(h, w, WITNESS && b == 0 ? witness + i * 512 : nullptr);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) states_out[8 * i + k] = h[k];
}

// ---------------------------------------------------------------------------
// Keccak-256
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ uint64_t rotl64(uint64_t x) {
    if constexpr (N == 0) return x;
    else return (x << N) | (x >> (64 - N));
}

// keccak-f[1600] on lanes s[x + 5y], in place.  Every index is fixed once
// the rounds are unrolled, so the 25 lanes stay in registers and each
// round constant is an operand from constant memory.
__device__ __forceinline__ void keccak_f(uint64_t* s) {
#pragma unroll
    for (int r = 0; r < 24; ++r) {
        uint64_t c[5], b[25];
#pragma unroll
        for (int x = 0; x < 5; ++x)
            c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x) {
            const uint64_t d = c[(x + 4) % 5] ^ rotl64<1>(c[(x + 1) % 5]);
#pragma unroll
            for (int y = 0; y < 5; ++y) s[x + 5 * y] ^= d;
        }
        // rho and pi: b[y + 5 ((2x + 3y) mod 5)] = s[x + 5y] <<< r[x][y].
        b[0] = rotl64<0>(s[0]);    b[16] = rotl64<36>(s[5]);
        b[7] = rotl64<3>(s[10]);   b[23] = rotl64<41>(s[15]);
        b[14] = rotl64<18>(s[20]); b[10] = rotl64<1>(s[1]);
        b[1] = rotl64<44>(s[6]);   b[17] = rotl64<10>(s[11]);
        b[8] = rotl64<45>(s[16]);  b[24] = rotl64<2>(s[21]);
        b[20] = rotl64<62>(s[2]);  b[11] = rotl64<6>(s[7]);
        b[2] = rotl64<43>(s[12]);  b[18] = rotl64<15>(s[17]);
        b[9] = rotl64<61>(s[22]);  b[5] = rotl64<28>(s[3]);
        b[21] = rotl64<55>(s[8]);  b[12] = rotl64<25>(s[13]);
        b[3] = rotl64<21>(s[18]);  b[19] = rotl64<56>(s[23]);
        b[15] = rotl64<27>(s[4]);  b[6] = rotl64<20>(s[9]);
        b[22] = rotl64<39>(s[14]); b[13] = rotl64<8>(s[19]);
        b[4] = rotl64<14>(s[24]);
#pragma unroll
        for (int y = 0; y < 5; ++y)
#pragma unroll
            for (int x = 0; x < 5; ++x)
                s[x + 5 * y] = b[x + 5 * y]
                               ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
        s[0] ^= c_keccak_rc[r];
    }
}

__global__ void keccak_kernel(const uint8_t* __restrict__ data,
                              const int64_t* __restrict__ offsets,
                              const int64_t* __restrict__ lengths,
                              const int64_t* __restrict__ state_in,
                              int64_t* __restrict__ state_out, long long n,
                              int pad) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long len = lengths[i];
    const uint8_t* msg = data + offsets[i];
    uint64_t s[25];
#pragma unroll
    for (int k = 0; k < 25; ++k)
        s[k] = state_in ? (uint64_t)state_in[25 * i + k] : 0ull;
    // Padding adds at least the byte 0x01: len / 136 + 1 blocks.
    const long long blocks = pad ? len / KECCAK_RATE + 1 : len / KECCAK_RATE;
    for (long long b = 0; b < blocks; ++b) {
        const long long q = b * KECCAK_RATE;
        if (q + KECCAK_RATE <= len) {
#pragma unroll
            for (int j = 0; j < 17; ++j) {      // a lane at a time: few registers
                uint32_t w[2];
                load_le_words<2>(msg + q + 8 * j, w);
                s[j] ^= (uint64_t)w[0] | ((uint64_t)w[1] << 32);
            }
        } else {
            const uint32_t first = pad ? 0x01u : 0u;
#pragma unroll
            for (int j = 0; j < 17; ++j) {
                uint64_t lane = 0;
#pragma unroll
                for (int k = 7; k >= 0; --k)
                    lane = (lane << 8) | msg_byte(msg, q + 8 * j + k, len, first);
                s[j] ^= lane;
            }
            if (pad && b == blocks - 1) s[16] ^= 0x80ull << 56;   // byte 135
        }
        keccak_f(s);
    }
#pragma unroll
    for (int k = 0; k < 25; ++k) state_out[25 * i + k] = (int64_t)s[k];
}

// ---------------------------------------------------------------------------
// BLAKE3
// ---------------------------------------------------------------------------

#define B3G(a, b, c, d, x, y)                                 \
    do {                                                      \
        v[a] = v[a] + v[b] + (x); v[d] = rotr32(v[d] ^ v[a], 16); \
        v[c] = v[c] + v[d];       v[b] = rotr32(v[b] ^ v[c], 12); \
        v[a] = v[a] + v[b] + (y); v[d] = rotr32(v[d] ^ v[a], 8);  \
        v[c] = v[c] + v[d];       v[b] = rotr32(v[b] ^ v[c], 7);  \
    } while (0)

// The compression function: cv (8 words) is replaced by the output
// chaining value, the first 8 words of state ^ its last 8.  m is permuted
// in place.
__device__ __forceinline__ void b3_compress_words(uint32_t* cv, uint32_t* m,
                                                  uint64_t counter,
                                                  uint32_t block_len,
                                                  uint32_t flags) {
    uint32_t v[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                      c_iv[0], c_iv[1], c_iv[2], c_iv[3],
                      (uint32_t)counter, (uint32_t)(counter >> 32), block_len,
                      flags};
#pragma unroll
    for (int r = 0; r < 7; ++r) {
        B3G(0, 4, 8, 12, m[0], m[1]);
        B3G(1, 5, 9, 13, m[2], m[3]);
        B3G(2, 6, 10, 14, m[4], m[5]);
        B3G(3, 7, 11, 15, m[6], m[7]);
        B3G(0, 5, 10, 15, m[8], m[9]);
        B3G(1, 6, 11, 12, m[10], m[11]);
        B3G(2, 7, 8, 13, m[12], m[13]);
        B3G(3, 4, 9, 14, m[14], m[15]);
        if (r < 6) {                    // the message schedule's permutation
            const uint32_t t[16] = {m[2], m[6], m[3], m[10], m[7], m[0],
                                    m[4], m[13], m[1], m[11], m[12], m[5],
                                    m[9], m[14], m[15], m[8]};
#pragma unroll
            for (int k = 0; k < 16; ++k) m[k] = t[k];
        }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) cv[k] = v[k] ^ v[k + 8];
}

// Chunk j of a message of `len` bytes at `msg` (len may be 0: one empty
// block): its blocks chained from the IV with the chunk counter j,
// CHUNK_START on the first block and CHUNK_END | `last_flags` on the last;
// cv receives its chaining value.
__device__ __forceinline__ void b3_chunk_cv(const uint8_t* msg, long long len,
                                            uint64_t j, uint32_t last_flags,
                                            uint32_t* cv) {
    const uint8_t* chunk = msg + j * B3_CHUNK;
    long long rest = len - (long long)j * B3_CHUNK;
    rest = rest < B3_CHUNK ? rest : B3_CHUNK;
#pragma unroll
    for (int k = 0; k < 8; ++k) cv[k] = c_iv[k];
    const int blocks = rest > 0 ? (int)((rest + B3_BLOCK - 1) / B3_BLOCK) : 1;
    for (int b = 0; b < blocks; ++b) {
        const long long q = (long long)b * B3_BLOCK;
        uint32_t m[16];
        if (q + B3_BLOCK <= rest) {
            load_le_words<16>(chunk + q, m);
        } else {
#pragma unroll
            for (int w = 0; w < 16; ++w) {
                uint32_t x = 0;
#pragma unroll
                for (int k = 3; k >= 0; --k) x = (x << 8) | msg_byte(chunk, q + 4 * w + k, rest, 0u);
                m[w] = x;
            }
        }
        const long long left = rest - q;
        const uint32_t block_len = (uint32_t)(left < B3_BLOCK ? (left > 0 ? left : 0) : B3_BLOCK);
        uint32_t flags = b == 0 ? B3_CHUNK_START : 0u;
        if (b == blocks - 1) flags |= B3_CHUNK_END | last_flags;
        b3_compress_words(cv, m, j, block_len, flags);
    }
}

// cv <- the parent node of chaining values cv (left) and right.
__device__ __forceinline__ void b3_parent(uint32_t* cv, const uint32_t* right,
                                          uint32_t flags) {
    uint32_t m[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        m[k] = cv[k];
        m[8 + k] = right[k];
        cv[k] = c_iv[k];
    }
    b3_compress_words(cv, m, 0, B3_BLOCK, B3_PARENT | flags);
}

// Whole messages, each to its 8-word digest, in one launch.  A message of
// c chunks (1,024 bytes each; an empty message is one chunk of one empty
// block) owns a group of lanes of one warp: the next power of two >= c
// lanes, or the whole warp where c > 32.  The host orders the messages by
// group size, largest first (one-chunk messages by their blocks, most
// first, so that a warp's lanes end together), and gives each its first
// lane (`lanes`, in ascending order), so every group lies aligned inside
// one warp; a lane finds its message by binary search.  Lane o of a group hashes chunk o
// (of each batch of 32, for a message of more than 32 chunks), then the
// group merges its chaining values in the warp: at each level node i sits
// in lane i << level, and a left node takes its right neighbour by a
// shuffle (nodes paired left to right, an odd last node carried up as it
// is: BLAKE3's tree, as the reference's host loop builds it), PARENT on
// each merge and ROOT on the message's last.  A message of more than 32
// chunks merges each batch's root into a stack of subtree roots kept by
// lane 0 in shared memory (BLAKE3's incremental chaining-value stack: a
// batch root merges with the top while the count of batches so far is
// even; the last batch's root merges with the whole stack, ROOT on the
// last merge).  Digest i goes to row `rows[i]` of `out`.
#define B3_WARPS 4
// Subtree roots a warp's stack holds: one per bit of a message's count of
// 32-chunk batches, so messages of up to 2^47 bytes.
#define B3_STACK 32

__global__ void __launch_bounds__(32 * B3_WARPS)
b3_rows_kernel(const uint8_t* __restrict__ data,
               const int64_t* __restrict__ offsets,
               const int64_t* __restrict__ lengths,
               const int64_t* __restrict__ lanes,
               const int64_t* __restrict__ rows, int64_t* __restrict__ out,
               long long n) {
    __shared__ uint32_t stack[B3_WARPS][B3_STACK][8];
    const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    // The last message whose first lane is t or before.
    long long lo = 0, hi = n - 1;
    while (lo < hi) {
        const long long mid = (lo + hi + 1) / 2;
        if (lanes[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const long long len = lengths[lo];
    const uint8_t* msg = data + offsets[lo];
    const long long chunks = len > 0 ? (len + B3_CHUNK - 1) / B3_CHUNK : 1;
    const int group = chunks >= 32 ? 32 : 1 << (32 - __clz((int)chunks - 1));
    const long long o = t - lanes[lo];
    const bool inside = o < group;   // lanes past the last group: none
    const long long batches = (chunks + 31) / 32;
    // Warp-uniform: a message of more than one batch owns its warp.
    const long long all = __reduce_max_sync(0xffffffffu, inside ? (unsigned)batches : 1u);
    uint32_t (*top)[8] = stack[threadIdx.x / 32];
    int depth = 0;
    uint32_t cv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (long long batch = 0; batch < all; ++batch) {
        const long long live = chunks - 32 * batch;   // this batch's chunks
        const long long r = live < 32 ? live : 32;
        if (inside && o < r)
            b3_chunk_cv(msg, len, (uint64_t)(32 * batch + o), chunks == 1 ? B3_ROOT : 0u, cv);
        // The batch's tree: r nodes at level 0, lane o holding node o.
#pragma unroll
        for (int level = 0; level < 5; ++level) {
            const int step = 1 << level;
            uint32_t right[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) right[k] = __shfl_down_sync(0xffffffffu, cv[k], step);
            const long long m = (r + step - 1) >> level;   // nodes at this level
            if (inside && (o & (2 * step - 1)) == 0 && (o >> level) + 1 < m)
                b3_parent(cv, right, m == 2 && batches == 1 ? B3_ROOT : 0u);
        }
        if (batches == 1 || !inside || o != 0) continue;
        if (batch + 1 < batches) {      // push the batch's root
            for (long long done = batch + 1; (done & 1) == 0; done >>= 1) {
                uint32_t left[8];
                --depth;
#pragma unroll
                for (int k = 0; k < 8; ++k) left[k] = top[depth][k];
                b3_parent(left, cv, 0u);
#pragma unroll
                for (int k = 0; k < 8; ++k) cv[k] = left[k];
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) top[depth][k] = cv[k];
            ++depth;
        } else {                        // the last: merge the whole stack
            while (depth > 0) {
                uint32_t left[8];
                --depth;
#pragma unroll
                for (int k = 0; k < 8; ++k) left[k] = top[depth][k];
                b3_parent(left, cv, depth == 0 ? B3_ROOT : 0u);
#pragma unroll
                for (int k = 0; k < 8; ++k) cv[k] = left[k];
            }
        }
    }
    if (inside && o == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) out[8 * rows[lo] + k] = cv[k];
    }
}

__global__ void b3_compress_kernel(const int64_t* __restrict__ cv_in,
                                   const int64_t* __restrict__ words,
                                   const int64_t* __restrict__ counter_lo,
                                   const int64_t* __restrict__ counter_hi,
                                   const int64_t* __restrict__ block_len,
                                   const int64_t* __restrict__ flags,
                                   int64_t* __restrict__ out, long long n) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t cv[8], m[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) cv[k] = cv_in ? (uint32_t)cv_in[8 * i + k] : c_iv[k];
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = (uint32_t)words[16 * i + k];
    const uint64_t counter = (uint64_t)(uint32_t)counter_lo[i]
                             | ((uint64_t)(uint32_t)counter_hi[i] << 32);
    b3_compress_words(cv, m, counter, (uint32_t)block_len[i], (uint32_t)flags[i]);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[8 * i + k] = cv[k];
}

// ---------------------------------------------------------------------------
// Entry points: launch on `stream`, no synchronisation, cudaGetLastError().
// ---------------------------------------------------------------------------

#define CRYPTO_THREADS 128

// states_in: [n, 8] or null (H0); states_out: [n, 8]; witness: null, or
// [n, 64, 8] receiving the round states of each row's first block (the
// caller's rows are then one block each).
extern "C" int sha256_blocks(const void* data, const void* offsets,
                             const void* lengths, const void* states_in,
                             void* states_out, void* witness, long long n,
                             int pad, void* stream) {
    if (n <= 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned grid = crypto_grid(n, CRYPTO_THREADS);
    if (witness)
        sha256_kernel<true><<<grid, CRYPTO_THREADS, 0, st>>>(
            (const uint8_t*)data, (const int64_t*)offsets, (const int64_t*)lengths,
            (const int64_t*)states_in, (int64_t*)states_out, (int64_t*)witness,
            n, pad);
    else
        sha256_kernel<false><<<grid, CRYPTO_THREADS, 0, st>>>(
            (const uint8_t*)data, (const int64_t*)offsets, (const int64_t*)lengths,
            (const int64_t*)states_in, (int64_t*)states_out, nullptr, n, pad);
    return (int)cudaGetLastError();
}

// state_in: [n, 25] or null (zero); state_out: [n, 25].
extern "C" int keccak_absorb(const void* data, const void* offsets,
                             const void* lengths, const void* state_in,
                             void* state_out, long long n, int pad,
                             void* stream) {
    if (n <= 0) return 0;
    keccak_kernel<<<crypto_grid(n, CRYPTO_THREADS), CRYPTO_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int64_t*)offsets, (const int64_t*)lengths,
        (const int64_t*)state_in, (int64_t*)state_out, n, pad);
    return (int)cudaGetLastError();
}

// Messages: offsets, lengths, lanes (each message's first lane, ascending,
// every group inside one warp: see b3_rows_kernel), rows [n]; out: [n, 8]
// digests, message i's in row rows[i]; total: the lanes of all groups.
extern "C" int b3_rows(const void* data, const void* offsets,
                       const void* lengths, const void* lanes,
                       const void* rows, void* out, long long n,
                       long long total, void* stream) {
    if (n <= 0) return 0;
    b3_rows_kernel<<<crypto_grid(total, 32 * B3_WARPS), 32 * B3_WARPS, 0,
                     (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int64_t*)offsets, (const int64_t*)lengths,
        (const int64_t*)lanes, (const int64_t*)rows, (int64_t*)out, n);
    return (int)cudaGetLastError();
}

// cv: [n, 8] or null (the IV); words: [n, 16]; counter_lo, counter_hi,
// block_len, flags: [n]; out: [n, 8].
extern "C" int b3_compress(const void* cv, const void* words,
                           const void* counter_lo, const void* counter_hi,
                           const void* block_len, const void* flags, void* out,
                           long long n, void* stream) {
    if (n <= 0) return 0;
    b3_compress_kernel<<<crypto_grid(n, CRYPTO_THREADS), CRYPTO_THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)cv, (const int64_t*)words, (const int64_t*)counter_lo,
        (const int64_t*)counter_hi, (const int64_t*)block_len,
        (const int64_t*)flags, (int64_t*)out, n);
    return (int)cudaGetLastError();
}
