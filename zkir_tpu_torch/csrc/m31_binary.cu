// K1: elementwise M31 a+b, a-b, a*b over equal-length int64 canonical words.
//
// Replaces the Pallas kernel `_binary_pallas` (zkir_tpu/ops/field_ops.py,
// with `_add_kernel`, `_sub_kernel`, `_mul_kernel`), which holds the whole
// array as one VMEM block.  Here a grid-stride loop walks any length.
//
// Bound on the H100: memory.  Each element moves 24 bytes (two 8-byte
// loads, one 8-byte store) for at most one 64-bit product, far below the
// card's operations-per-byte balance; int64 words cost twice the bytes of
// uint32 (narrowing them is later work).  Loads are coalesced: neighbouring
// threads read neighbouring words.
//
// Written in CUDA C++ rather than Triton: the port's kernels are CUDA C++
// built by nvcc into one plain-C library, so they share m31.cuh.
#include <cuda_runtime.h>

#include "m31.cuh"

template <int OP>
__global__ void m31_binary_kernel(const int64_t* __restrict__ a,
                                  const int64_t* __restrict__ b,
                                  int64_t* __restrict__ out, int64_t n) {
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        uint32_t x = (uint32_t)a[i], y = (uint32_t)b[i];
        uint32_t r = OP == 0 ? m31_add(x, y)
                   : OP == 1 ? m31_sub(x, y)
                             : m31_mul(x, y);
        out[i] = (int64_t)r;
    }
}

// Error text for the codes every entry point of the library returns.
extern "C" const char* zk_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// op: 0 = add, 1 = sub, 2 = mul.
extern "C" int m31_binary(const void* a, const void* b, void* out,
                          long long n, int op, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t* pa = (const int64_t*)a;
    const int64_t* pb = (const int64_t*)b;
    int64_t* po = (int64_t*)out;
    if (op == 0)
        m31_binary_kernel<0><<<(unsigned)blocks, threads, 0, s>>>(pa, pb, po, n);
    else if (op == 1)
        m31_binary_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(pa, pb, po, n);
    else if (op == 2)
        m31_binary_kernel<2><<<(unsigned)blocks, threads, 0, s>>>(pa, pb, po, n);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
