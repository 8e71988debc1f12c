// Byte strings that lie at any byte offset of a device buffer, read as
// little-endian 32-bit words: the loads of the hash kernels (crypto.cu) and
// of the Poseidon2 syscall sponge (poseidon2.cu).
#pragma once

#include <stdint.h>

// N little-endian words from p on, p of any alignment: the aligned words
// that hold those bytes, shifted together.  Every aligned word read holds
// one of the 4 N bytes, so it lies inside the buffer (whose allocation is
// at least 4-byte aligned).
template <int N>
__device__ __forceinline__ void load_le_words(const uint8_t* p, uint32_t* out) {
    const uint32_t* w = (const uint32_t*)((uintptr_t)p & ~(uintptr_t)3);
    const int s = (int)((uintptr_t)p & 3) * 8;
    if (s == 0) {
#pragma unroll
        for (int j = 0; j < N; ++j) out[j] = __ldg(w + j);
        return;
    }
    uint32_t lo = __ldg(w);
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const uint32_t hi = __ldg(w + j + 1);
        out[j] = __funnelshift_r(lo, hi, s);
        lo = hi;
    }
}

// Byte p of a message of `len` bytes followed by its padding: `first`
// right after the message, zeros beyond.
__device__ __forceinline__ uint32_t msg_byte(const uint8_t* msg, long long p,
                                             long long len, uint32_t first) {
    return p < len ? (uint32_t)msg[p] : (p == len ? first : 0u);
}
