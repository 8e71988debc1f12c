// K1: elementwise M31 and CM31 a+b, a-b, a*b over int64 canonical words, with
// strided (broadcast, transposed, sliced) or immediate operands.
//
// Replaces the Pallas kernel `_binary_pallas` (zkir_tpu/ops/field_ops.py,
// with `_add_kernel`, `_sub_kernel`, `_mul_kernel`), which holds the whole
// array as one VMEM block and leaves broadcasting and the CM31 composition
// to XLA's fusion.  PyTorch runs eagerly and fuses nothing, so the fusion is
// done here, in two entry points over one body:
//
//   m31_binary   out = a op b                       (one word per element)
//   cm31_binary  (o_re, o_im) = (a_re, a_im) op (b_re, b_im)   in ONE launch
//
// Bound on the H100: memory.  An M31 op moves 24 bytes per element for at
// most one 64-bit product; a CM31 product moves 48 bytes per point (four
// words in, two out) where six one-word launches moved 144 and four of them
// wrote temporaries.  What the design does about it:
//   - every operand is a base pointer with the element strides of the
//     broadcast-collapsed shape (rank <= 4; stride 0 on a broadcast axis), or
//     a scalar immediate (null pointer), so no operand is ever expanded or
//     filled in device memory before the launch;
//   - the output is contiguous, and each thread handles two neighbouring
//     words of the last axis with one 16-byte load per operand and one
//     16-byte store per output wherever alignment and a unit (or zero)
//     inner stride allow (VEC = 2); otherwise one word per thread;
//   - a rank-1 layout (the common case: equal contiguous shapes) skips the
//     index arithmetic altogether (FLAT).
// Words stay int64 in device memory because the rest of the port computes
// on them with torch's int64 operators.
//
// Written in CUDA C++ rather than Triton: the port's kernels are CUDA C++
// built by nvcc into one plain-C library, so they share m31.cuh.
#include <cuda_runtime.h>

#include "m31.cuh"

struct Operand {
    const int64_t* p;  // null: the operand is the immediate `imm`
    int64_t s[4];      // element strides of the collapsed shape
    uint32_t imm;
};

struct Dims {
    int64_t n[4];   // collapsed shape, padded with 1 in front
    int64_t count;  // elements / VEC
};

// Offsets of the element(s) a thread handles: idx[] is the index into the
// collapsed shape of the first of its VEC words.
template <int VEC, bool FLAT>
__device__ __forceinline__ void unravel(int64_t i, const Dims& d,
                                        int64_t idx[4]) {
    if (FLAT) {
        idx[0] = idx[1] = idx[2] = 0;
        idx[3] = i * VEC;
        return;
    }
    int64_t inner = d.n[3] / VEC;
    if (d.count <= 0xffffffffLL) {  // 32-bit division is several times cheaper
        const uint32_t n3 = (uint32_t)inner, n2 = (uint32_t)d.n[2],
                       n1 = (uint32_t)d.n[1];
        uint32_t r = (uint32_t)i, q = r / n3;
        idx[3] = (int64_t)(r - q * n3) * VEC;
        r = q;
        q = r / n2;
        idx[2] = r - q * n2;
        r = q;
        q = r / n1;
        idx[1] = r - q * n1;
        idx[0] = q;
    } else {
        int64_t r = i;
        idx[3] = (r % inner) * VEC; r /= inner;
        idx[2] = r % d.n[2]; r /= d.n[2];
        idx[1] = r % d.n[1];
        idx[0] = r / d.n[1];
    }
}

template <int VEC>
__device__ __forceinline__ void load(const Operand& o, const int64_t idx[4],
                                     uint32_t v[VEC]) {
    if (o.p == nullptr) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = o.imm;
        return;
    }
    const int64_t* p = o.p + idx[0] * o.s[0] + idx[1] * o.s[1] +
                       idx[2] * o.s[2] + idx[3] * o.s[3];
    if (VEC == 2 && o.s[3] == 1) {
        longlong2 w = *reinterpret_cast<const longlong2*>(p);
        v[0] = (uint32_t)w.x;
        v[VEC - 1] = (uint32_t)w.y;
    } else {  // VEC == 1, or a broadcast inner axis (stride 0)
        uint32_t w = (uint32_t)*p;
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = w;
    }
}

template <int VEC>
__device__ __forceinline__ void store(int64_t* out, int64_t i,
                                      const uint32_t v[VEC]) {
    if (VEC == 2) {
        longlong2 w;
        w.x = (int64_t)v[0];
        w.y = (int64_t)v[VEC - 1];
        *reinterpret_cast<longlong2*>(out + i * 2) = w;
    } else {
        out[i] = (int64_t)v[0];
    }
}

template <int OP>
__device__ __forceinline__ uint32_t m31_op(uint32_t x, uint32_t y) {
    return OP == 0 ? m31_add(x, y) : OP == 1 ? m31_sub(x, y) : m31_mul(x, y);
}

template <int OP>
__device__ __forceinline__ cm31 cm31_op(cm31 x, cm31 y) {
    return OP == 0 ? cm31_add(x, y) : OP == 1 ? cm31_sub(x, y) : cm31_mul(x, y);
}

template <int OP, int VEC, bool FLAT>
__global__ void m31_binary_kernel(Operand a, Operand b, int64_t* out, Dims d) {
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < d.count; i += stride) {
        int64_t idx[4];
        unravel<VEC, FLAT>(i, d, idx);
        uint32_t x[VEC], y[VEC], r[VEC];
        load<VEC>(a, idx, x);
        load<VEC>(b, idx, y);
#pragma unroll
        for (int k = 0; k < VEC; ++k) r[k] = m31_op<OP>(x[k], y[k]);
        store<VEC>(out, i, r);
    }
    if (VEC == 2 && FLAT && (d.n[3] & 1) && blockIdx.x == 0 &&
        threadIdx.x == 0) {  // the odd last word of a rank-1 layout
        int64_t idx[4] = {0, 0, 0, d.n[3] - 1};
        uint32_t x[1], y[1], r[1];
        load<1>(a, idx, x);
        load<1>(b, idx, y);
        r[0] = m31_op<OP>(x[0], y[0]);
        store<1>(out, idx[3], r);
    }
}

template <int OP, int VEC, bool FLAT>
__global__ void cm31_binary_kernel(Operand ar, Operand ai, Operand br,
                                   Operand bi, int64_t* out_re,
                                   int64_t* out_im, Dims d) {
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < d.count; i += stride) {
        int64_t idx[4];
        unravel<VEC, FLAT>(i, d, idx);
        uint32_t xr[VEC], xi[VEC], yr[VEC], yi[VEC], rr[VEC], ri[VEC];
        load<VEC>(ar, idx, xr);
        load<VEC>(ai, idx, xi);
        load<VEC>(br, idx, yr);
        load<VEC>(bi, idx, yi);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            cm31 r = cm31_op<OP>({xr[k], xi[k]}, {yr[k], yi[k]});
            rr[k] = r.re;
            ri[k] = r.im;
        }
        store<VEC>(out_re, i, rr);
        store<VEC>(out_im, i, ri);
    }
    if (VEC == 2 && FLAT && (d.n[3] & 1) && blockIdx.x == 0 &&
        threadIdx.x == 0) {  // the odd last point of a rank-1 layout
        int64_t idx[4] = {0, 0, 0, d.n[3] - 1};
        uint32_t xr[1], xi[1], yr[1], yi[1];
        load<1>(ar, idx, xr);
        load<1>(ai, idx, xi);
        load<1>(br, idx, yr);
        load<1>(bi, idx, yi);
        cm31 r = cm31_op<OP>({xr[0], xi[0]}, {yr[0], yi[0]});
        store<1>(out_re, idx[3], &r.re);
        store<1>(out_im, idx[3], &r.im);
    }
}

// Error text for the codes every entry point of the library returns.
extern "C" const char* zk_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The host-side descriptor both entry points read before they return:
//   desc[0..4)            collapsed shape n0..n3 (contiguous output)
//   desc[4 + 4k .. 8+4k)  element strides of operand k
//   then one immediate per operand (used where its pointer is null),
//   then VEC (1 or 2; 2 promises 16-byte aligned pointers, inner strides
//   of 0 or 1, even outer strides on every stride-1 operand, and an even
//   n3 unless the layout is rank 1, whose odd last word one thread takes).
static Operand operand(const void* p, const long long* desc, int k,
                       int n_operands) {
    Operand o;
    o.p = (const int64_t*)p;
    for (int j = 0; j < 4; ++j) o.s[j] = desc[4 + 4 * k + j];
    o.imm = (uint32_t)desc[4 + 4 * n_operands + k];
    return o;
}

static bool dims(const long long* desc, int n_operands, Dims* d, int* vec) {
    int64_t total = 1;
    for (int j = 0; j < 4; ++j) {
        d->n[j] = desc[j];
        if (desc[j] < 0) return false;
        total *= desc[j];
    }
    *vec = (int)desc[4 + 5 * n_operands];
    if (*vec != 1 && *vec != 2) return false;
    d->count = total / *vec;
    return true;
}

static unsigned grid_for(int64_t count, int threads) {
    int64_t blocks = (count + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
    return (unsigned)blocks;
}

#define ZK_DISPATCH(KERNEL, ...)                                             \
    do {                                                                     \
        bool flat = d.n[0] == 1 && d.n[1] == 1 && d.n[2] == 1;               \
        unsigned g = grid_for(d.count, 256);                                 \
        cudaStream_t s = (cudaStream_t)stream;                               \
        if (vec == 2 && flat) KERNEL<OP, 2, true><<<g, 256, 0, s>>>(__VA_ARGS__); \
        else if (vec == 2) KERNEL<OP, 2, false><<<g, 256, 0, s>>>(__VA_ARGS__);   \
        else if (flat) KERNEL<OP, 1, true><<<g, 256, 0, s>>>(__VA_ARGS__);   \
        else KERNEL<OP, 1, false><<<g, 256, 0, s>>>(__VA_ARGS__);            \
    } while (0)

template <int OP>
static void launch_m31(const void* a, const void* b, void* out,
                       const long long* desc, const Dims& d, int vec,
                       void* stream) {
    ZK_DISPATCH(m31_binary_kernel, operand(a, desc, 0, 2),
                operand(b, desc, 1, 2), (int64_t*)out, d);
}

template <int OP>
static void launch_cm31(const void* a_re, const void* a_im, const void* b_re,
                        const void* b_im, void* o_re, void* o_im,
                        const long long* desc, const Dims& d, int vec,
                        void* stream) {
    ZK_DISPATCH(cm31_binary_kernel, operand(a_re, desc, 0, 4),
                operand(a_im, desc, 1, 4), operand(b_re, desc, 2, 4),
                operand(b_im, desc, 3, 4), (int64_t*)o_re, (int64_t*)o_im, d);
}

// op: 0 = add, 1 = sub, 2 = mul.  `a`/`b` may be null (immediate operand).
extern "C" int m31_binary(const void* a, const void* b, void* out,
                          const long long* desc, int op, void* stream) {
    Dims d;
    int vec;
    if (!dims(desc, 2, &d, &vec)) return (int)cudaErrorInvalidValue;
    if (d.count <= 0) return 0;
    if (op == 0) launch_m31<0>(a, b, out, desc, d, vec, stream);
    else if (op == 1) launch_m31<1>(a, b, out, desc, d, vec, stream);
    else if (op == 2) launch_m31<2>(a, b, out, desc, d, vec, stream);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

extern "C" int cm31_binary(const void* a_re, const void* a_im,
                           const void* b_re, const void* b_im, void* o_re,
                           void* o_im, const long long* desc, int op,
                           void* stream) {
    Dims d;
    int vec;
    if (!dims(desc, 4, &d, &vec)) return (int)cudaErrorInvalidValue;
    if (d.count <= 0) return 0;
    if (op == 0)
        launch_cm31<0>(a_re, a_im, b_re, b_im, o_re, o_im, desc, d, vec, stream);
    else if (op == 1)
        launch_cm31<1>(a_re, a_im, b_re, b_im, o_re, o_im, desc, d, vec, stream);
    else if (op == 2)
        launch_cm31<2>(a_re, a_im, b_re, b_im, o_re, o_im, desc, d, vec, stream);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
