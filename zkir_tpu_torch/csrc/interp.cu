// K3: the batched ZK-IR interpreter, `chunk` machine cycles of every lane
// in one launch.
//
// Replaces the jitted `lax.scan` behind `_chunk_fn_for`
// (zkir_tpu/interp/columnar.py, body `step`), which is XLA code shaped by
// the TPU: 64-bit words as pairs of 32-bit limbs (interp/pairs.py), a
// one-hot register file, a one-hot matmul instruction fetch, every opcode
// family computed each cycle and selected by masks, and one compiled step
// per set of opcode families.  Hopper needs none of that.  Here one thread
// owns one lane and loops over the cycles: the word is fetched from the
// read-only code buffer and decoded inline, a `switch` on the opcode runs
// only that instruction, 64-bit values are `unsigned long long`, MULH's
// 128-bit product is `__umul64hi`, the divider is `/` and `%` on unsigned
// values (signs handled around it, because INT64_MIN / -1 is undefined in
// C), and loads and stores touch only the bytes inside their width.  One
// kernel serves every program.
//
// The 16 registers and their bounds live in a [16][blockDim] shared-memory
// tile (a register index is data, so a per-thread array would go to local
// memory; lane-minor rows keep the accesses of a warp in distinct banks).
// The machine state is read once at entry and written once at exit.  With
// a trace, every cycle writes its row into the [chunk, lanes, ...] outputs
// the wrapper allocated (zeroed: a lane that is halted, or halts with an
// error, leaves `valid` 0 in its remaining rows).
//
// Bound on the H100: with a trace, the 244 bytes a row writes; without
// one, the instructions a cycle executes (a dependent chain per lane).
// Per-lane memory rows make the lanes' accesses uncoalesced and a single
// lane uses a single thread of the card.
//
// Written in CUDA C++ rather than Triton: a sequential machine per thread
// with data-dependent control flow, byte-granular gathers and scatters and
// 64- and 128-bit integer arithmetic is not a block of tensors.
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define THREADS 128
#define M40 0xFFFFFFFFFFull
#define CODE_BASE 0x1000ull
#define STACK_TOP 0xFFFFFFFFFFull

#define HALT_NONE 0
#define HALT_EBREAK 1
#define HALT_EXIT 2
#define HALT_ERROR 4
#define PAUSE_CRYPTO 5

// The descriptor's slots (64-bit words; pointers as integers), filled by
// zkir_tpu_torch/interp/columnar.py::_descriptor in this order.
enum {
    D_CODE, D_N_WORDS, D_LANES, D_CHUNK,
    D_PC, D_REGS, D_BOUND, D_HALTED, D_EXIT, D_CYCLES,
    D_MEM, D_MEM_STRIDE, D_LOW_BYTES, D_STACK_BYTES, D_HAS_MEM,
    D_INPUTS, D_N_INPUTS, D_INPUT_POS, D_MAX_INPUTS,
    D_OUTPUTS, D_OUT_POS, D_MAX_OUTPUTS,
    D_COLLECT,
    T_VALID, T_CYCLE, T_PC, T_WORD, T_REGS, T_BOUNDS,
    T_MEM_VALID, T_MEM_ADDR, T_MEM_VALUE, T_MEM_WIDTH, T_MEM_IS_WRITE,
    T_RC_VALID, T_RC_VALUE,
    D_COUNT
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

__global__ void __launch_bounds__(THREADS) interp_kernel(const Interp a) {
    __shared__ u64 s_regs[16][THREADS];
    __shared__ int s_bound[16][THREADS];

    const int tx = threadIdx.x;
    const long long lane = (long long)blockIdx.x * THREADS + tx;
    if (lane >= a.d[D_LANES]) return;
    int halted = ptr<int>(a, D_HALTED)[lane];
    if (halted != HALT_NONE) return;

    const uint32_t* __restrict__ code = ptr<const uint32_t>(a, D_CODE);
    const u64 code_end = CODE_BASE + 4ull * (u64)a.d[D_N_WORDS];
    const long long lanes = a.d[D_LANES];
    const int chunk = (int)a.d[D_CHUNK];
    const bool has_mem = a.d[D_HAS_MEM] != 0;
    const bool collect = a.d[D_COLLECT] != 0;
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
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        s_regs[r][tx] = g_regs[r];
        s_bound[r][tx] = g_bound[r];
    }
    u64 pc = ptr<u64>(a, D_PC)[lane];
    u64 cycles = ptr<u64>(a, D_CYCLES)[lane];
    u64 exit_code = ptr<u64>(a, D_EXIT)[lane];
    int input_pos = ptr<int>(a, D_INPUT_POS)[lane];
    int out_pos = ptr<int>(a, D_OUT_POS)[lane];

    for (int t = 0; t < chunk && halted == HALT_NONE; ++t) {
        // ---- fetch and decode ----
        if (pc < CODE_BASE || pc >= code_end || (pc & 3)) {
            halted = HALT_ERROR;
            break;
        }
        const uint32_t word = code[(pc - CODE_BASE) >> 2];
        const int op = word & 0x7F;
        const int f_rd = (word >> 7) & 0xF;
        const int f_rs1 = (word >> 11) & 0xF;
        const int f_rs2 = (word >> 15) & 0xF;
        const int imm17 = (int)(((word >> 15) & 0x1FFFF) ^ 0x10000) - 0x10000;
        const int imm21 = (int)(((word >> 11) & 0x1FFFFF) ^ 0x100000) - 0x100000;
        const bool is_store = op >= 0x38 && op <= 0x3B;
        const bool is_branch = op >= 0x40 && op <= 0x45;
        const bool is_load = op >= 0x30 && op <= 0x35;
        // S- and B-type words carry rs1 in the rd field and rs2 in rs1's.
        const int rs1 = (is_store || is_branch) ? f_rd : f_rs1;
        const int rs2 = (is_store || is_branch) ? f_rs1 : f_rs2;
        const int rd = (is_store || is_branch) ? 0 : f_rd;
        const u64 imm = (u64)(long long)imm17;
        const int imm_bits = imm17 < 0 ? 64 : 32 - __clz(imm17);

        const u64 a_raw = s_regs[rs1][tx];
        const u64 b_raw = s_regs[rs2][tx];
        const int a_bound = s_bound[rs1][tx];
        const int b_bound = s_bound[rs2][tx];
        const u64 a40 = a_raw & M40, b40 = b_raw & M40, imm40 = imm & M40;
        const u64 add40 = (a40 + b40) & M40;
        const u64 link = pc + 4;
        const bool is_imm_shift = op >= 0x1B && op <= 0x1D;
        const int shamt = is_imm_shift ? (int)((word >> 15) & 0xFF)
                                       : (int)(b_raw & 0x3F);
        // 40-bit signed order: flip bit 39 and compare unsigned.
        const bool slt = (a40 ^ (1ull << 39)) < (b40 ^ (1ull << 39));
        const bool sltu = a40 < b40;
        const bool eq = a_raw == b_raw;

        bool err = false;
        bool writes = false;       // rd and its bound are written
        u64 result = 0;
        int new_bound = 40;
        u64 next_pc = link;
        u64 rc_value = add40;
        // The memory columns of the trace row: the address is formed for
        // every instruction; width is 0 outside loads and stores.
        const u64 addr = a_raw + imm;
        int width = 0;
        u64 loaded = 0;
        u64 off = 0;
        int sys = -1;              // ECALL number, where it is one of 0..6
        int halt_to = HALT_NONE;

        switch (op) {
        case 0x00:  // ADD
            result = add40; new_bound = imax(a_bound, b_bound) + 1; writes = true; break;
        case 0x01:  // SUB
            result = (a40 - b40) & M40; new_bound = imax(a_bound, b_bound); writes = true; break;
        case 0x02:  // MUL
            result = (a40 * b40) & M40; rc_value = result;
            new_bound = a_bound + b_bound; writes = true; break;
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
        case 0x08:  // ADDI
            result = (a40 + imm40) & M40; new_bound = imax(a_bound, imm_bits) + 1;
            writes = true; break;
        case 0x10: result = a40 & b40; new_bound = imin(a_bound, b_bound); writes = true; break;
        case 0x11: result = a40 | b40; new_bound = imax(a_bound, b_bound); writes = true; break;
        case 0x12: result = a40 ^ b40; new_bound = imax(a_bound, b_bound); writes = true; break;
        case 0x13: result = a40 & imm40; new_bound = imin(a_bound, imm_bits); writes = true; break;
        case 0x14: result = a40 | imm40; new_bound = imax(a_bound, imm_bits); writes = true; break;
        case 0x15: result = a40 ^ imm40; new_bound = imax(a_bound, imm_bits); writes = true; break;
        case 0x18: case 0x1B:  // SLL SLLI: an amount of 40 or more clears
            result = shamt >= 40 ? 0 : (a40 << shamt) & M40;
            new_bound = imin(a_bound + shamt, 40); writes = true; break;
        case 0x19: case 0x1C:  // SRL SRLI
            result = shamt >= 40 ? 0 : a40 >> shamt;
            new_bound = imax(a_bound - shamt, 0); writes = true; break;
        case 0x1A: case 0x1D: {  // SRA SRAI: the sign is bit 39
            const u64 srl = shamt >= 40 ? 0 : a40 >> shamt;
            const u64 fill = M40 ^ (M40 >> imin(shamt, 40));
            result = ((a40 >> 39) & 1) ? (srl | fill) : srl;
            new_bound = a_bound >= 40 ? 40 : imax(a_bound - shamt, 0);
            writes = true; break;
        }
        case 0x20: result = sltu; new_bound = 1; writes = true; break;
        case 0x21: result = !sltu; new_bound = 1; writes = true; break;
        case 0x22: result = slt; new_bound = 1; writes = true; break;
        case 0x23: result = !slt; new_bound = 1; writes = true; break;
        case 0x24: result = eq; new_bound = 1; writes = true; break;  // raw 64 bits
        case 0x25: result = !eq; new_bound = 1; writes = true; break;
        case 0x26: case 0x27: case 0x28:  // CMOV CMOVZ CMOVNZ: the raw word moves
            writes = (op == 0x27) ? (b_raw == 0) : (b_raw != 0);
            result = a_raw; new_bound = imax(a_bound, s_bound[rd][tx]); break;
        case 0x30: case 0x31: width = 1; new_bound = 8; break;    // LB LBU
        case 0x32: case 0x33: width = 2; new_bound = 16; break;   // LH LHU
        case 0x34: width = 4; new_bound = 32; break;              // LW
        case 0x35: width = 8; new_bound = 40; break;              // LD
        case 0x38: width = 1; break;                              // SB
        case 0x39: width = 2; break;                              // SH
        case 0x3A: width = 4; break;                              // SW
        case 0x3B: width = 8; break;                              // SD
        case 0x40: if (eq) next_pc = pc + imm; break;             // BEQ (raw)
        case 0x41: if (!eq) next_pc = pc + imm; break;
        case 0x42: if (slt) next_pc = pc + imm; break;
        case 0x43: if (!slt) next_pc = pc + imm; break;
        case 0x44: if (sltu) next_pc = pc + imm; break;
        case 0x45: if (!sltu) next_pc = pc + imm; break;
        case 0x48:  // JAL
            result = link; new_bound = 64 - __clzll((long long)link); writes = true;
            next_pc = pc + (u64)(long long)imm21; break;
        case 0x49:  // JALR
            result = link; new_bound = 64 - __clzll((long long)link); writes = true;
            next_pc = (a_raw + imm) & ~1ull; break;
        case 0x50: {  // ECALL: the number is r10
            const u64 num = s_regs[10][tx];
            if (num > 6) err = true;
            else sys = (int)num;
            break;
        }
        case 0x51: halt_to = HALT_EBREAK; break;
        default: err = true; break;  // not an opcode
        }

        if (width) {
            // Two windows: [0, low_bytes) and [stack_lo, STACK_TOP].
            const bool in_low = addr < low_bytes;
            const bool in_stack = addr >= stack_lo && addr <= STACK_TOP;
            if (!has_mem || !(in_low || in_stack) || (addr & (u64)(width - 1))) {
                err = true;
            } else {
                off = in_low ? addr : low_bytes + (addr - stack_lo);
                if (is_load) {
                    for (int k = 0; k < width; ++k)
                        loaded |= (u64)mem[off + k] << (8 * k);
                    result = loaded;
                    // LB and LH extend the sign through all 64 bits.
                    if (op == 0x30 && (loaded & 0x80)) result |= ~0xFFull;
                    if (op == 0x32 && (loaded & 0x8000)) result |= ~0xFFFFull;
                    writes = true;
                }
            }
        }

        // ---- a fault beats a pause beats a commit ----
        if (err) {
            halted = HALT_ERROR;
            break;
        }
        const bool pause = sys >= 3;
        const bool commit = !pause;

        if (collect) {
            const long long row = (long long)t * lanes + lane;
            ptr<uint8_t>(a, T_VALID)[row] = 1;
            ptr<u64>(a, T_CYCLE)[row] = cycles;
            ptr<u64>(a, T_PC)[row] = pc;
            ptr<uint32_t>(a, T_WORD)[row] = word;
            u64* t_regs = ptr<u64>(a, T_REGS) + row * 16;
            int* t_bounds = ptr<int>(a, T_BOUNDS) + row * 16;
#pragma unroll
            for (int r = 0; r < 16; ++r) {
                t_regs[r] = s_regs[r][tx];
                t_bounds[r] = s_bound[r][tx];
            }
            // A store's value is cut to its width; a load's is the bytes read.
            const u64 wmask = width == 8 ? ~0ull : (1ull << (8 * width)) - 1;
            ptr<uint8_t>(a, T_MEM_VALID)[row] = commit && width > 0;
            ptr<u64>(a, T_MEM_ADDR)[row] = addr;
            ptr<u64>(a, T_MEM_VALUE)[row] = is_store ? (b_raw & wmask) : loaded;
            ptr<int>(a, T_MEM_WIDTH)[row] = width;
            ptr<uint8_t>(a, T_MEM_IS_WRITE)[row] = is_store;
            ptr<uint8_t>(a, T_RC_VALID)[row] =
                commit && (op == 0x00 || op == 0x02) && new_bound > 40;
            ptr<u64>(a, T_RC_VALUE)[row] = rc_value;
        }

        if (pause) {  // the host services the syscall, then advances the lane
            halted = PAUSE_CRYPTO;
            break;
        }

        // ---- commit ----
        if (writes && rd != 0) {
            s_regs[rd][tx] = result;
            s_bound[rd][tx] = new_bound;
        }
        if (is_store) {
            for (int k = 0; k < width; ++k) mem[off + k] = (uint8_t)(b_raw >> (8 * k));
        }
        if (sys == 0) {
            halt_to = HALT_EXIT;
            exit_code = s_regs[11][tx];
        } else if (sys == 1) {  // READ -> r10 (0 past the end of the tape)
            s_regs[10][tx] = input_pos < n_inputs
                ? inputs[imin(input_pos, max_inputs - 1)] : 0;
            ++input_pos;
        } else if (sys == 2) {  // WRITE r11
            outputs[imin(out_pos, max_outputs - 1)] = s_regs[11][tx];
            ++out_pos;
        }
        pc = next_pc;
        ++cycles;
        halted = halt_to;
    }

#pragma unroll
    for (int r = 0; r < 16; ++r) {
        g_regs[r] = s_regs[r][tx];
        g_bound[r] = s_bound[r][tx];
    }
    ptr<u64>(a, D_PC)[lane] = pc;
    ptr<u64>(a, D_CYCLES)[lane] = cycles;
    ptr<u64>(a, D_EXIT)[lane] = exit_code;
    ptr<int>(a, D_HALTED)[lane] = halted;
    ptr<int>(a, D_INPUT_POS)[lane] = input_pos;
    ptr<int>(a, D_OUT_POS)[lane] = out_pos;
}

// desc: D_COUNT 64-bit words on the host (see the enum above).
extern "C" int interp_chunk(const long long* desc, void* stream) {
    Interp a;
    for (int k = 0; k < D_COUNT; ++k) a.d[k] = desc[k];
    if (a.d[D_LANES] <= 0 || a.d[D_CHUNK] <= 0) return 0;
    if (a.d[D_N_WORDS] <= 0 || a.d[D_MAX_INPUTS] <= 0 || a.d[D_MAX_OUTPUTS] <= 0)
        return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((a.d[D_LANES] + THREADS - 1) / THREADS);
    interp_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
