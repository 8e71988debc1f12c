// K3: the batched ZK-IR interpreter.  `interp_run` runs every lane until it
// halts, pauses for a crypto syscall or reaches the end of the launch's
// segment of chunks (one chunk for columnar.py::interp_chunk).
//
// Replaces the jitted `lax.scan` behind `_chunk_fn_for`
// (zkir_tpu/interp/columnar.py, body `step`), which is XLA code shaped by
// the TPU: 64-bit words as pairs of 32-bit limbs (interp/pairs.py), a
// one-hot register file, a one-hot matmul instruction fetch, every opcode
// family computed each cycle and selected by masks, and one compiled step
// per set of opcode families.  Hopper needs none of that.  Here each lane
// is a sequential machine that loops over its cycles: the instruction's
// fields come from a table decoded once per program on the device (one
// 16-byte entry per code word: an instruction class, the register fields,
// the immediates), a `switch` on the class runs only that instruction and
// sends the rarer ones (MULH, the divider, loads and stores, syscalls) to
// a `switch` on the opcode, 64-bit values are `unsigned long long`, MULH's
// 128-bit product is `__umul64hi`, the divider is `/` and `%` on unsigned
// values (signs handled around it, because INT64_MIN / -1 is undefined in
// C), and a load or store is one aligned access of its width.  One kernel
// serves every program.
//
// Chunks.  `chunk` cycles stay the unit of the trace's layout and of the
// cycle limit, as in the reference's host loop: row (k * chunk + t) of the
// run's trace is cycle t of a lane's chunk k.  Each lane keeps its own
// chunk index (`lane_chunk`): a lane that halts or pauses ends its chunk
// at once (the rest of that chunk's rows stay invalid) and goes on, after
// the host has serviced a pause, at its next chunk.  A launch covers the
// chunks [seg_lo, seg_hi) and writes their rows into the segment's trace
// buffers (zeroed by the wrapper: a row that is not written keeps `valid`
// 0).  No lane waits for another, so the grid needs no barrier.
//
// Two layouts of one kernel text (the template parameter WARP), so that a
// fix to an opcode reaches both:
// - a thread per lane, for many lanes: the 16 registers and their bounds
//   live in a [16][THREADS] shared tile (a register index is data, so a
//   per-thread array would go to local memory; lane-minor rows keep the
//   accesses of a warp in distinct banks);
// - a warp per lane, for few lanes (the one-lane main path): thread j holds
//   register j & 15 and its bound in registers (threads 16-31 mirror 0-15),
//   an operand is one `__shfl_sync`, rd is written by its owners, every
//   thread computes the cycle's scalar values alike, the trace row's
//   registers and bounds are one coalesced store each, and its scalars
//   wait in shared memory until 32 rows are stored at once.
//
// The deferred-carry model (InterpConfig(deferred=True); the template
// parameter DEFERRED, so that the plain model's build keeps its
// instructions): ADD, SUB and ADDI add limbs without extracting carries
// and mark rd accumulated; an observation point first normalizes rs1 and,
// for the two-source ones, an accumulated rs2 (runtime/deferred.py,
// normalize.py, execute.py::execute_with_deferred).  A lane's accumulated
// registers are one 16-bit mask in a register, the same in every thread of
// its warp.  The normalized sources are written back at the commit (or at
// a fault, as the reference's step writes them for any lane that runs), so
// that the trace row stores the pre-state.  The row adds the pre-state's
// mask (accum_mask); the normalization witness is a function of the row,
// made on the host (columnar.py::_norm_witness).
//
// Bound on the H100: the instructions of a cycle (a dependent chain per
// lane); with a trace, also the 244 bytes a row writes (248 deferred).  A
// single lane uses a single warp of the card, so every instruction of a
// cycle waits for the one before: fewer instructions a cycle is what makes
// it faster (zkir_tpu_torch/tools/interp_bench.py splits its clocks by
// phase).
//
// Written in CUDA C++ rather than Triton: a sequential machine per lane
// with data-dependent control flow, gathers and scatters of 1 to 8 bytes
// and 64- and 128-bit integer arithmetic is not a block of tensors.
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define THREADS 128
#define FULL_MASK 0xFFFFFFFFu
#define M40 0xFFFFFFFFFFull
#define CODE_BASE 0x1000ull
#define STACK_TOP 0xFFFFFFFFFFull

#define HALT_NONE 0
#define HALT_EBREAK 1
#define HALT_EXIT 2
#define HALT_ERROR 4
#define PAUSE_CRYPTO 5

// clock64() stamps between the phases of a cycle, summed per phase over
// the run; on only in the build of zkir_tpu_torch/tools/interp_bench.py.
#ifdef INTERP_CLOCKS
__device__ unsigned long long zk_clocks[8];
#define CLK_BEGIN unsigned long long clk_t = clock64(), clk_acc[5] = {0, 0, 0, 0, 0};
#define CLK(k) { const unsigned long long n_ = clock64(); clk_acc[k] += n_ - clk_t; clk_t = n_; }
#define CLK_END(who) if (who) for (int k_ = 0; k_ < 5; ++k_) atomicAdd(&zk_clocks[k_], clk_acc[k_]);
extern "C" int zk_clocks_take(unsigned long long* out) {
    cudaMemcpyFromSymbol(out, zk_clocks, sizeof(zk_clocks));
    unsigned long long zero[8] = {0};
    return (int)cudaMemcpyToSymbol(zk_clocks, zero, sizeof(zk_clocks));
}
#else
#define CLK_BEGIN
#define CLK(k)
#define CLK_END(who)
#endif

// The descriptor's slots (64-bit words; pointers as integers), filled by
// zkir_tpu_torch/interp/columnar.py::_descriptor in this order.  After the
// trace: the decoded program (uint4 [n_words], columnar.py::decode_table);
// each lane's next chunk (int32 [lanes], or 0: every lane at seg_lo); the
// launch's chunks [seg_lo, seg_hi); 1 for a warp per lane; 1 for the
// deferred model, its limb widths (normalized, accumulated) and the
// observation points' opcode mask (bits 0-63, 64-127).
enum {
    D_CODE, D_N_WORDS, D_LANES, D_CHUNK,
    D_PC, D_REGS, D_BOUND, D_ACCUM, D_HALTED, D_EXIT, D_CYCLES,
    D_MEM, D_MEM_STRIDE, D_LOW_BYTES, D_STACK_BYTES, D_HAS_MEM,
    D_INPUTS, D_N_INPUTS, D_INPUT_POS, D_MAX_INPUTS,
    D_OUTPUTS, D_OUT_POS, D_MAX_OUTPUTS,
    D_COLLECT,
    T_VALID, T_CYCLE, T_PC, T_WORD, T_REGS, T_BOUNDS,
    T_MEM_VALID, T_MEM_ADDR, T_MEM_VALUE, T_MEM_WIDTH, T_MEM_IS_WRITE,
    T_RC_VALID, T_RC_VALUE, T_ACCUM_MASK,
    D_DECODED, D_LANE_CHUNK, D_SEG_LO, D_SEG_HI, D_WARP,
    D_DEFERRED, D_NORM_BITS, D_LIMB_BITS, D_OBS_LO, D_OBS_HI,
    D_COUNT
};

// A decoded word (columnar.py::decode_table): x the packed fields below,
// y imm17 sign-extended, z JAL's imm21 sign-extended or an immediate
// shift's amount, w the word.
#define F_CLASS(x) ((x) & 0xF)
#define F_IMM(x) (((x) >> 4) & 1)       // the second operand is the immediate
#define F_KIND(x) (((x) >> 5) & 3)      // compare: 0 unsigned <, 1 signed <, 2 ==
#define F_NEG(x) (((x) >> 7) & 1)       // negate it (also CMOVZ, JALR)
#define F_RD(x) (((x) >> 8) & 0xF)      // 0 for S- and B-type words
#define F_RS1(x) (((x) >> 12) & 0xF)
#define F_RS2(x) (((x) >> 16) & 0xF)
#define F_IMM_BITS(x) (((x) >> 20) & 0x7F)
#define F_WIDTH(x) (((x) >> 27) & 0xF)  // 0 outside loads and stores

// Instruction classes, columnar.py::_CLASSES.  C_SLOW (MULH, the divider,
// loads, stores, ECALL, EBREAK, and words that are no instruction) goes on
// to a `switch` on the opcode.
enum {
    C_ADD, C_SUB, C_MUL, C_AND, C_OR, C_XOR, C_SLL, C_SRL, C_SRA, C_CMP,
    C_CMOV, C_JUMP, C_BRANCH, C_SLOW
};

struct Interp {
    long long d[D_COUNT];
};

template <typename T>
__device__ __forceinline__ T* ptr(const Interp& a, int slot) {
    return reinterpret_cast<T*>(a.d[slot]);
}

__device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }
__device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }

__device__ __forceinline__ u64 shfl64(u64 v, int src) {
    const unsigned lo = __shfl_sync(FULL_MASK, (unsigned)v, src);
    const unsigned hi = __shfl_sync(FULL_MASK, (unsigned)(v >> 32), src);
    return ((u64)hi << 32) | lo;
}

// `width` bytes at p, little-endian: one access where p is aligned to it
// (the windows' offsets are multiples of 8, and the address is checked to
// be aligned), else byte by byte.
__device__ __forceinline__ u64 load_bytes(const uint8_t* p, int width) {
    if (((uintptr_t)p & (width - 1)) == 0) {
        switch (width) {
        case 1: return *p;
        case 2: return *reinterpret_cast<const uint16_t*>(p);
        case 4: return *reinterpret_cast<const uint32_t*>(p);
        default: return *reinterpret_cast<const u64*>(p);
        }
    }
    u64 v = 0;
    for (int k = 0; k < width; ++k) v |= (u64)p[k] << (8 * k);
    return v;
}

__device__ __forceinline__ void store_bytes(uint8_t* p, int width, u64 v) {
    if (((uintptr_t)p & (width - 1)) == 0) {
        switch (width) {
        case 1: *p = (uint8_t)v; return;
        case 2: *reinterpret_cast<uint16_t*>(p) = (uint16_t)v; return;
        case 4: *reinterpret_cast<uint32_t*>(p) = (uint32_t)v; return;
        default: *reinterpret_cast<u64*>(p) = v; return;
        }
    }
    for (int k = 0; k < width; ++k) p[k] = (uint8_t)(v >> (8 * k));
}

// normalize.rs:85-105: a register word of two limbs (of lb bits where it
// holds accumulated limbs, else nb) carry-extracted into two nb-bit limbs,
// the carry out of the top one dropped.
__device__ __forceinline__ u64 normalized(u64 v, bool accumulated, int nb, int lb) {
    const int bits = accumulated ? lb : nb;
    const u64 mask = (1ull << bits) - 1, nmask = (1ull << nb) - 1;
    const u64 l0 = v & mask, l1 = ((v >> bits) & mask) + (l0 >> nb);
    return (l0 & nmask) | ((l1 & nmask) << nb);
}

// A trace row's scalar columns at element e (row x lanes + lane): the
// packed word carries word | width << 32 | mem_valid << 40 |
// mem_is_write << 41 | rc_valid << 42 | accum_mask << 48.
template <bool DEFERRED>
__device__ __forceinline__ void put_row(const Interp& a, int e, u64 cycle,
                                        u64 pc, u64 addr, u64 value,
                                        u64 rc_value, u64 packed) {
    ptr<uint8_t>(a, T_VALID)[e] = 1;
    ptr<u64>(a, T_CYCLE)[e] = cycle;
    ptr<u64>(a, T_PC)[e] = pc;
    ptr<uint32_t>(a, T_WORD)[e] = (uint32_t)packed;
    ptr<uint8_t>(a, T_MEM_VALID)[e] = (packed >> 40) & 1;
    ptr<u64>(a, T_MEM_ADDR)[e] = addr;
    ptr<u64>(a, T_MEM_VALUE)[e] = value;
    ptr<int>(a, T_MEM_WIDTH)[e] = (int)((packed >> 32) & 0xFF);
    ptr<uint8_t>(a, T_MEM_IS_WRITE)[e] = (packed >> 41) & 1;
    ptr<uint8_t>(a, T_RC_VALID)[e] = (packed >> 42) & 1;
    ptr<u64>(a, T_RC_VALUE)[e] = rc_value;
    if constexpr (DEFERRED) ptr<int>(a, T_ACCUM_MASK)[e] = (int)(packed >> 48);
}

template <bool WARP, bool COLLECT, bool DEFERRED>
__global__ void __launch_bounds__(THREADS) interp_kernel(const Interp a) {
    // The thread layout's register tile (the warp layout keeps registers
    // in registers and leaves this unused).
    __shared__ u64 s_regs[WARP ? 1 : 16][THREADS];
    __shared__ int s_bound[WARP ? 1 : 16][THREADS];
    // The warp layout's last 32 trace rows (put_row's six words), written
    // by every thread of the warp alike and stored by thread j for row j.
    __shared__ u64 s_rows[WARP && COLLECT ? THREADS / 32 : 1][32][6];

    const int tx = threadIdx.x;
    const int j = tx & 31;              // warp layout: the thread's register j & 15
    const long long lane = WARP ? (long long)blockIdx.x * (THREADS / 32) + tx / 32
                                : (long long)blockIdx.x * THREADS + tx;
    const long long lanes = a.d[D_LANES];
    if (lane >= lanes) return;          // whole warps in the warp layout
    int halted = ptr<int>(a, D_HALTED)[lane];
    int* lane_chunk = ptr<int>(a, D_LANE_CHUNK);
    const int seg_lo = (int)a.d[D_SEG_LO], seg_hi = (int)a.d[D_SEG_HI];
    int k = lane_chunk ? lane_chunk[lane] : seg_lo;
    if (halted != HALT_NONE || k >= seg_hi) return;
    // Stores a lane's outputs and state once.  Data memory is stored by
    // every thread of the warp alike, so that each thread's later loads
    // see it.
    const bool leader = !WARP || j == 0;

    const uint4* __restrict__ decoded = ptr<const uint4>(a, D_DECODED);
    const u64 n_words = (u64)a.d[D_N_WORDS];
    const int chunk = (int)a.d[D_CHUNK];
    const bool has_mem = a.d[D_HAS_MEM] != 0;
    const u64 low_bytes = (u64)a.d[D_LOW_BYTES];
    const u64 stack_lo = STACK_TOP - (u64)a.d[D_STACK_BYTES] + 1;
    uint8_t* mem = ptr<uint8_t>(a, D_MEM) + lane * a.d[D_MEM_STRIDE];
    const int max_inputs = (int)a.d[D_MAX_INPUTS];
    const int max_outputs = (int)a.d[D_MAX_OUTPUTS];
    const u64* inputs = ptr<const u64>(a, D_INPUTS) + lane * max_inputs;
    u64* outputs = ptr<u64>(a, D_OUTPUTS) + lane * max_outputs;
    const int n_inputs = ptr<const int>(a, D_N_INPUTS)[lane];

    u64* g_regs = ptr<u64>(a, D_REGS) + lane * 16;
    int* g_bound = ptr<int>(a, D_BOUND) + lane * 16;
    u64 my_reg = 0;                     // warp layout
    int my_bound = 0;
    if constexpr (WARP) {
        my_reg = g_regs[j & 15];
        my_bound = g_bound[j & 15];
    } else {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
            s_regs[r][tx] = g_regs[r];
            s_bound[r][tx] = g_bound[r];
        }
    }
    // The deferred model: bit r of acc is 1 where register r holds
    // accumulated limbs; nb and lb are the limbs' widths.
    unsigned acc = 0;
    int* g_accum = ptr<int>(a, D_ACCUM) + lane * 16;
    const int nb = (int)a.d[D_NORM_BITS], lb = (int)a.d[D_LIMB_BITS];
    const u64 obs_lo = (u64)a.d[D_OBS_LO], obs_hi = (u64)a.d[D_OBS_HI];
    if constexpr (DEFERRED) {
        if constexpr (WARP) {
            acc = __ballot_sync(FULL_MASK, g_accum[j & 15] == 1) & 0xFFFFu;
        } else {
#pragma unroll
            for (int r = 0; r < 16; ++r) acc |= (unsigned)(g_accum[r] == 1) << r;
        }
    }
    // Register r's value and bound; in the warp layout every thread of the
    // warp calls these together (control flow depends only on the lane).
    auto reg = [&](int r) -> u64 {
        if constexpr (WARP) return shfl64(my_reg, r);
        else return s_regs[r][tx];
    };
    auto bound = [&](int r) -> int {
        if constexpr (WARP) return __shfl_sync(FULL_MASK, my_bound, r);
        else return s_bound[r][tx];
    };
    auto set_reg = [&](int r, u64 v) {
        if constexpr (WARP) { if ((j & 15) == r) my_reg = v; }
        else s_regs[r][tx] = v;
    };
    auto set_bound = [&](int r, int b) {
        if constexpr (WARP) { if ((j & 15) == r) my_bound = b; }
        else s_bound[r][tx] = b;
    };

    u64 pc = ptr<u64>(a, D_PC)[lane];
    u64 cycles = ptr<u64>(a, D_CYCLES)[lane];
    u64 exit_code = ptr<u64>(a, D_EXIT)[lane];
    int input_pos = ptr<int>(a, D_INPUT_POS)[lane];
    int out_pos = ptr<int>(a, D_OUT_POS)[lane];

    CLK_BEGIN
    for (; k < seg_hi && halted == HALT_NONE; ++k) {
      const int row0 = (k - seg_lo) * chunk;
      // Warp layout: rows [staged_from, staged_to) of this chunk wait in
      // s_rows, from slot 0 on.
      int staged_from = 0, staged_to = 0;
      auto flush = [&]() {
          if constexpr (WARP && COLLECT) {
              if (j < staged_to - staged_from) {
                  const u64* slot = s_rows[tx / 32][j];
                  put_row<DEFERRED>(a, (row0 + staged_from + j) * (int)lanes + (int)lane,
                                    slot[0], slot[1], slot[2], slot[3], slot[4], slot[5]);
              }
              __syncwarp();
              staged_from = staged_to;
          }
      };
      for (int t = 0; t < chunk; ++t) {
        // ---- fetch, decode, operands ----
        // (pc - CODE_BASE) / 4 wraps past n_words below CODE_BASE.
        u64 word_at = (pc - CODE_BASE) >> 2;
        const bool fetch_fault = word_at >= n_words || (pc & 3);
        if (__builtin_expect(fetch_fault, 0)) {
            if constexpr (!DEFERRED) {
                halted = HALT_ERROR;
                break;
            }
            // The deferred model runs word 0's normalizations before the
            // fault, as the reference's step does for a pc outside the code.
            word_at = 0;
        }
        const uint4 e = decoded[word_at];
        const int cls = F_CLASS(e.x);
        const int rd = F_RD(e.x);
        const u64 imm = (u64)(long long)(int)e.y;
        const bool use_imm = F_IMM(e.x), neg = F_NEG(e.x);
        const int rs1 = F_RS1(e.x), rs2 = F_RS2(e.x);

        u64 a_raw = reg(rs1);
        u64 b_raw = reg(rs2);
        const int a_bound = bound(rs1);
        const int b_bound = bound(rs2);
        // The deferred model: the registers written back normalized at the
        // commit (0: none), and the pre-state's mask for the trace row.  An
        // observation point normalizes rs1 (R0 never) and, unless it is an
        // immediate form, rs2 where it is accumulated: after rs1, so that
        // rs1 == rs2 is normalized once.
        int w1 = 0, w2 = 0;
        u64 v1 = 0, v2 = 0;
        const unsigned acc_pre = acc;
        if constexpr (DEFERRED) {
            const int opc = e.w & 0x7F;
            if ((opc < 64 ? obs_lo >> opc : obs_hi >> (opc - 64)) & 1) {
                if (rs1 != 0) {
                    a_raw = normalized(a_raw, (acc >> rs1) & 1, nb, lb);
                    w1 = rs1; v1 = a_raw; acc &= ~(1u << rs1);
                    if (rs2 == rs1) b_raw = a_raw;
                }
                if (!use_imm && rs2 != 0 && ((acc >> rs2) & 1)) {
                    b_raw = normalized(b_raw, true, nb, lb);
                    w2 = rs2; v2 = b_raw; acc &= ~(1u << rs2);
                }
            }
        }
        // ADD, ADDI and SUB of the deferred model (deferred.rs): the limbs
        // of each source (lb bits where it is accumulated, else nb; an
        // immediate's two nb-bit limbs) added without extracting carries,
        // SUB wrapping each limb at 64 bits.  Where an ADD's limb reaches
        // 2^lb, both sources are normalized (and written back) and added
        // again.  limb0 is OR'd in unmasked (state.rs:184-192).
        auto deferred_add = [&](bool sub) -> u64 {
            const bool acc_a = (acc >> rs1) & 1, acc_b = (acc >> rs2) & 1;
            const int ba = acc_a ? lb : nb, bb = acc_b ? lb : nb;
            const u64 nmask = (1ull << nb) - 1;
            const u64 a0 = a_raw & ((1ull << ba) - 1);
            const u64 a1 = (a_raw >> ba) & ((1ull << ba) - 1);
            const u64 o0 = use_imm ? imm & nmask : b_raw & ((1ull << bb) - 1);
            const u64 o1 = use_imm ? (imm >> nb) & nmask : (b_raw >> bb) & ((1ull << bb) - 1);
            if (sub) return (a0 - o0) | ((a1 - o1) << lb);
            u64 d0 = a0 + o0, d1 = a1 + o1;
            if ((d0 | d1) >> lb) {
                const u64 pa = normalized(a_raw, acc_a, nb, lb);
                const u64 pb = normalized(b_raw, acc_b, nb, lb);
                d0 = (pa & nmask) + (use_imm ? o0 : pb & nmask);
                d1 = ((pa >> nb) & nmask) + (use_imm ? o1 : (pb >> nb) & nmask);
                w1 = rs1; v1 = pa; acc &= ~(1u << rs1);
                if (!use_imm) { w2 = rs2; v2 = pb; acc &= ~(1u << rs2); }
            }
            return d0 | (d1 << lb);
        };
        CLK(0)

        // ---- execute: a jump on the class, then the slow path's switch
        // on the opcode for the rarer instructions ----
        const u64 a40 = a_raw & M40, b40 = b_raw & M40;
        const u64 c40 = use_imm ? imm & M40 : b40;  // the second operand
        const int c_bound = use_imm ? (int)F_IMM_BITS(e.x) : b_bound;
        const u64 add40 = (a40 + b40) & M40;
        const u64 link = pc + 4;
        // An immediate shift's amount, or b's low six bits.
        const int shamt = use_imm ? (int)e.z : (int)(b_raw & 0x3F);
        bool writes = true;        // rd and its bound are written
        u64 result = 0;
        int new_bound = 40;
        u64 next_pc = link;
        u64 rc_value = add40;
        // The memory columns of the trace row: the address is formed for
        // every instruction; width is 0 outside loads and stores.
        const u64 addr = a_raw + imm;
        const int width = F_WIDTH(e.x);
        const int op = e.w & 0x7F;
        const bool is_store = op >= 0x38 && op <= 0x3B;
        u64 loaded = 0;
        u64 off = 0;
        bool err = false;
        int sys = -1;              // ECALL number, where it is one of 0..6
        int halt_to = HALT_NONE;

        switch (cls) {
        case C_ADD:
            if constexpr (DEFERRED) result = deferred_add(false);
            else result = (a40 + c40) & M40;
            new_bound = imax(a_bound, c_bound) + 1; break;
        case C_SUB:
            if constexpr (DEFERRED) result = deferred_add(true);
            else result = (a40 - b40) & M40;
            new_bound = imax(a_bound, b_bound); break;
        case C_MUL:
            result = rc_value = (a40 * b40) & M40; new_bound = a_bound + b_bound; break;
        case C_AND: result = a40 & c40; new_bound = imin(a_bound, c_bound); break;
        case C_OR: result = a40 | c40; new_bound = imax(a_bound, c_bound); break;
        case C_XOR: result = a40 ^ c40; new_bound = imax(a_bound, c_bound); break;
        // Shifts: an amount of 40 or more clears (SLL, SRL) or fills (SRA).
        case C_SLL:
            result = shamt >= 40 ? 0 : (a40 << shamt) & M40;
            new_bound = imin(a_bound + shamt, 40); break;
        case C_SRL:
            result = shamt >= 40 ? 0 : a40 >> shamt;
            new_bound = imax(a_bound - shamt, 0); break;
        case C_SRA: {  // the sign is bit 39
            const u64 srl = shamt >= 40 ? 0 : a40 >> shamt;
            const u64 fill = M40 ^ (M40 >> imin(shamt, 40));
            result = ((a40 >> 39) & 1) ? (srl | fill) : srl;
            new_bound = a_bound >= 40 ? 40 : imax(a_bound - shamt, 0);
            break;
        }
        case C_CMP: case C_BRANCH: {
            // 40-bit signed order: flip bit 39 and compare unsigned; SEQ,
            // SNE, BEQ and BNE compare the raw 64-bit words.
            const int kind = F_KIND(e.x);
            const bool cond = neg != (kind == 0 ? a40 < b40
                                      : kind == 1 ? (a40 ^ (1ull << 39)) < (b40 ^ (1ull << 39))
                                      : a_raw == b_raw);
            if (cls == C_CMP) { result = cond; new_bound = 1; }
            else { writes = false; if (cond) next_pc = pc + imm; }
            break;
        }
        case C_CMOV:  // CMOV CMOVZ CMOVNZ: the raw word moves where b (not) 0
            writes = (b_raw != 0) != neg;
            result = a_raw; new_bound = imax(a_bound, bound(rd)); break;
        case C_JUMP:  // JAL JALR
            result = link; new_bound = 64 - __clzll((long long)link);
            next_pc = neg ? (a_raw + imm) & ~1ull : pc + (u64)(long long)(int)e.z;
            break;
        default:
            writes = false;
            switch (op) {
            case 0x03:  // MULH: bits [40, 80) of the product of the raw words
                result = ((__umul64hi(a_raw, b_raw) << 24) | ((a_raw * b_raw) >> 40)) & M40;
                new_bound = a_bound + b_bound; writes = true; break;
            case 0x04: case 0x05: case 0x06: case 0x07: {  // DIVU REMU DIV REM
                new_bound = a_bound; writes = true;
                if (b_raw == 0) { err = true; break; }
                if (op == 0x04) result = a_raw / b_raw;
                else if (op == 0x05) result = a_raw % b_raw;
                else {
                    // C-style truncation on the raw 64-bit words: divide the
                    // absolute values (a wrapping negate), then fix the sign.
                    const bool neg_a = a_raw >> 63, neg_b = b_raw >> 63;
                    const u64 abs_a = neg_a ? 0 - a_raw : a_raw;
                    const u64 abs_b = neg_b ? 0 - b_raw : b_raw;
                    if (op == 0x06) {
                        const u64 q = abs_a / abs_b;
                        result = (neg_a != neg_b) ? 0 - q : q;
                    } else {
                        const u64 r = abs_a % abs_b;
                        result = neg_a ? 0 - r : r;
                    }
                }
                break;
            }
            case 0x30: case 0x31: case 0x32: case 0x33: case 0x34: case 0x35:
            case 0x38: case 0x39: case 0x3A: case 0x3B: {  // loads, stores
                // Two windows: [0, low_bytes) and [stack_lo, STACK_TOP].
                const bool in_low = addr < low_bytes;
                const bool in_stack = addr >= stack_lo && addr <= STACK_TOP;
                if (!has_mem || !(in_low || in_stack) || (addr & (u64)(width - 1))) {
                    err = true;
                    break;
                }
                off = in_low ? addr : low_bytes + (addr - stack_lo);
                if (!is_store) {
                    loaded = load_bytes(mem + off, width);
                    result = loaded;
                    // LB and LH extend the sign through all 64 bits.
                    if (op == 0x30 && (loaded & 0x80)) result |= ~0xFFull;
                    if (op == 0x32 && (loaded & 0x8000)) result |= ~0xFFFFull;
                    new_bound = width == 8 ? 40 : 8 * width;
                    writes = true;
                }
                break;
            }
            case 0x50: {  // ECALL: the number is r10
                const u64 num = reg(10);
                if (num > 6) err = true;
                else sys = (int)num;
                break;
            }
            case 0x51: halt_to = HALT_EBREAK; break;
            default: err = true; break;  // not an opcode
            }
        }
        CLK(1)
        CLK(2)

        // ---- a fault beats a pause beats a commit ----
        if constexpr (DEFERRED) err = err || fetch_fault;
        if (__builtin_expect(err, 0)) {
            if constexpr (DEFERRED) {  // the normalizations stay
                if (w1) set_reg(w1, v1);
                if (w2) set_reg(w2, v2);
            }
            halted = HALT_ERROR;
            break;
        }
        const bool pause = sys >= 3;
        const bool commit = !pause;

        // ---- the trace row ----
        if constexpr (COLLECT) {
            // The wrapper keeps a segment's rows x lanes x 16 below 2^31.
            const int row = (row0 + t) * (int)lanes + (int)lane;
            // A store's value is cut to its width; a load's is the bytes
            // read.  The range-check witness of a deferred check: an ADD or
            // MUL whose new bound exceeds the data width.
            const u64 wmask = width == 8 ? ~0ull : (1ull << (8 * width)) - 1;
            const u64 value = is_store ? (b_raw & wmask) : loaded;
            const u64 packed = e.w | (u64)width << 32
                | (u64)(commit && width > 0) << 40 | (u64)is_store << 41
                | (u64)(commit && (op == 0x00 || op == 0x02) && new_bound > 40) << 42
                | (DEFERRED ? (u64)acc_pre << 48 : 0);
            if constexpr (WARP) {
                if (j < 16) {
                    ptr<u64>(a, T_REGS)[row * 16 + j] = my_reg;
                    ptr<int>(a, T_BOUNDS)[row * 16 + j] = my_bound;
                }
                u64* slot = s_rows[tx / 32][t & 31];
                slot[0] = cycles; slot[1] = pc; slot[2] = addr;
                slot[3] = value; slot[4] = rc_value; slot[5] = packed;
                staged_to = t + 1;
                if ((t & 31) == 31) flush();
            } else {
                u64* t_regs = ptr<u64>(a, T_REGS) + row * 16;
                int* t_bounds = ptr<int>(a, T_BOUNDS) + row * 16;
#pragma unroll
                for (int r = 0; r < 16; ++r) {
                    t_regs[r] = s_regs[r][tx];
                    t_bounds[r] = s_bound[r][tx];
                }
                put_row<DEFERRED>(a, row, cycles, pc, addr, value, rc_value, packed);
            }
        }
        CLK(3)

        if (__builtin_expect(pause, 0)) {  // the host services the syscall,
            halted = PAUSE_CRYPTO;          // then advances the lane
            break;
        }

        // ---- commit ----
        if constexpr (DEFERRED) {
            if (w1) set_reg(w1, v1);
            if (w2) set_reg(w2, v2);
        }
        if (writes && rd != 0) {
            set_reg(rd, result);
            set_bound(rd, new_bound);
            // Only the deferred writes mark rd; the others leave its mark.
            if constexpr (DEFERRED) if (cls <= C_SUB) acc |= 1u << rd;
        }
        if (__builtin_expect(cls == C_SLOW, 0)) {
            if (is_store) store_bytes(mem + off, width, b_raw);
            if (sys == 0) {
                halt_to = HALT_EXIT;
                exit_code = reg(11);
            } else if (sys == 1) {  // READ -> r10 (0 past the end of the tape)
                set_reg(10, input_pos < n_inputs
                        ? inputs[imin(input_pos, max_inputs - 1)] : 0);
                ++input_pos;
            } else if (sys == 2) {  // WRITE r11
                const u64 v = reg(11);
                if (leader) outputs[imin(out_pos, max_outputs - 1)] = v;
                ++out_pos;
            }
        }
        pc = next_pc;
        ++cycles;
        CLK(4)
        if (__builtin_expect(halt_to != HALT_NONE, 0)) {
            halted = halt_to;
            break;
        }
      }
      flush();
    }
    CLK_END(leader)

    if constexpr (WARP) {
        if (j < 16) {
            g_regs[j] = my_reg;
            g_bound[j] = my_bound;
            if constexpr (DEFERRED) g_accum[j] = (acc >> j) & 1;
        }
    } else {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
            g_regs[r] = s_regs[r][tx];
            g_bound[r] = s_bound[r][tx];
            if constexpr (DEFERRED) g_accum[r] = (acc >> r) & 1;
        }
    }
    if (leader) {
        ptr<u64>(a, D_PC)[lane] = pc;
        ptr<u64>(a, D_CYCLES)[lane] = cycles;
        ptr<u64>(a, D_EXIT)[lane] = exit_code;
        ptr<int>(a, D_HALTED)[lane] = halted;
        ptr<int>(a, D_INPUT_POS)[lane] = input_pos;
        ptr<int>(a, D_OUT_POS)[lane] = out_pos;
        if (lane_chunk) lane_chunk[lane] = k;
    }
}

template <bool WARP, bool COLLECT, bool DEFERRED>
static void launch_layout(const Interp& a, unsigned blocks, cudaStream_t stream) {
    interp_kernel<WARP, COLLECT, DEFERRED><<<blocks, THREADS, 0, stream>>>(a);
}

template <bool DEFERRED>
static void launch_model(const Interp& a, bool warp, bool collect,
                         unsigned blocks, cudaStream_t s) {
    if (warp && collect) launch_layout<true, true, DEFERRED>(a, blocks, s);
    else if (warp) launch_layout<true, false, DEFERRED>(a, blocks, s);
    else if (collect) launch_layout<false, true, DEFERRED>(a, blocks, s);
    else launch_layout<false, false, DEFERRED>(a, blocks, s);
}

static int launch(const long long* desc, void* stream) {
    Interp a;
    for (int k = 0; k < D_COUNT; ++k) a.d[k] = desc[k];
    if (a.d[D_LANES] <= 0 || a.d[D_CHUNK] <= 0 || a.d[D_SEG_HI] <= a.d[D_SEG_LO])
        return 0;
    if (a.d[D_N_WORDS] <= 0 || a.d[D_MAX_INPUTS] <= 0 || a.d[D_MAX_OUTPUTS] <= 0)
        return (int)cudaErrorInvalidValue;
    const bool warp = a.d[D_WARP] != 0, collect = a.d[D_COLLECT] != 0;
    const long long per_block = warp ? THREADS / 32 : THREADS;
    const unsigned blocks = (unsigned)((a.d[D_LANES] + per_block - 1) / per_block);
    cudaStream_t s = (cudaStream_t)stream;
    if (a.d[D_DEFERRED]) launch_model<true>(a, warp, collect, blocks, s);
    else launch_model<false>(a, warp, collect, blocks, s);
    return (int)cudaGetLastError();
}

// desc: D_COUNT 64-bit words on the host (see the enum above).
extern "C" int interp_run(const long long* desc, void* stream) {
    return launch(desc, stream);
}
