// The port's copy of native/zkir_vm.cpp, kept word for word below this
// note; zkir_tpu_torch/runtime/native_vm.py builds it into
// zkir_tpu_torch/_build/ at first use.
//
// Fast native ZK-IR v3.4 interpreter (plain execution, no witnesses).
//
// The reference's execution-speed target is >50M cycles/sec on CPU
// (README.md:278); the Python oracle is the semantic source of truth but is
// ~1000x slower.  This C++ core executes the identical plain semantics
// (zkir-runtime/src/execute.rs:35-673, vm.rs:208-358) at native speed and is
// differential-tested against the oracle.  Witness generation (traces,
// range checks, deferred model) stays in the Python/TPU paths where the
// data is produced columnar; this core serves fast host-side execution:
// input preparation, debugging, differential fuzzing.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -o libzkir_vm.so zkir_vm.cpp

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t M40 = (1ull << 40) - 1;
constexpr uint64_t SIGN40 = 1ull << 39;
constexpr uint64_t CODE_BASE = 0x1000;

// Halt codes shared with the Python wrapper.
enum HaltCode : int {
  HALT_NONE = 0,
  HALT_EBREAK = 1,
  HALT_EXIT = 2,
  HALT_CYCLE_LIMIT = 3,
  HALT_ERROR = 4,
  HALT_UNSUPPORTED_SYSCALL = 6,  // crypto syscalls -> use Python/TPU path
};

// Sparse paged memory with a flat fast path for the low region
// (replaces the reference's HashMap-of-pages, memory.rs:86-110).
struct Memory {
  static constexpr uint64_t kLowSize = 1ull << 24;  // 16 MB flat window
  std::vector<uint8_t> low;
  std::unordered_map<uint64_t, std::vector<uint8_t>> pages;

  Memory() : low(kLowSize, 0) {}

  inline uint8_t* slot(uint64_t addr) {
    if (addr < kLowSize) return &low[addr];
    auto& page = pages[addr >> 12];
    if (page.empty()) page.resize(4096, 0);
    return &page[addr & 0xFFF];
  }

  inline uint8_t read_u8(uint64_t addr) { return *slot(addr); }
  inline void write_u8(uint64_t addr, uint8_t v) { *slot(addr) = v; }

  template <typename T>
  inline bool read(uint64_t addr, T* out) {
    if (addr % sizeof(T) != 0) return false;
    if (addr + sizeof(T) <= kLowSize) {
      std::memcpy(out, &low[addr], sizeof(T));
      return true;
    }
    uint64_t v = 0;
    for (size_t i = 0; i < sizeof(T); i++)
      v |= static_cast<uint64_t>(read_u8(addr + i)) << (8 * i);
    *out = static_cast<T>(v);
    return true;
  }

  template <typename T>
  inline bool write(uint64_t addr, T value) {
    if (addr % sizeof(T) != 0) return false;
    if (addr + sizeof(T) <= kLowSize) {
      std::memcpy(&low[addr], &value, sizeof(T));
      return true;
    }
    for (size_t i = 0; i < sizeof(T); i++)
      write_u8(addr + i, static_cast<uint8_t>(value >> (8 * i)));
    return true;
  }
};

inline uint64_t sra40(uint64_t val, uint64_t shift) {
  bool neg = (val & SIGN40) != 0;
  if (shift >= 40) return neg ? M40 : 0;
  uint64_t shifted = val >> shift;
  if (neg) shifted |= (((1ull << shift) - 1) << (40 - shift));
  return shifted & M40;
}

inline bool signed_lt40(uint64_t a, uint64_t b) {
  return (a ^ SIGN40) < (b ^ SIGN40);
}

}  // namespace

extern "C" {

// Returns the halt code.  regs/outputs/cycles/exit_code are out-params.
int zkir_run(const uint32_t* code, uint64_t n_words,
             const uint8_t* data, uint64_t data_len,
             uint64_t entry_point,
             const uint64_t* inputs, uint64_t n_inputs,
             uint64_t max_cycles,
             uint64_t* out_regs /*16*/,
             uint64_t* out_outputs, uint64_t max_outputs,
             uint64_t* out_n_outputs,
             uint64_t* out_cycles, uint64_t* out_exit_code) {
  Memory mem;
  for (uint64_t i = 0; i < n_words; i++) {
    mem.write<uint32_t>(CODE_BASE + 4 * i, code[i]);
  }
  for (uint64_t i = 0; i < data_len; i++) {
    mem.write_u8(CODE_BASE + 4 * n_words + i, data[i]);
  }

  uint64_t regs[16] = {0};
  uint64_t pc = entry_point;
  uint64_t cycles = 0;
  uint64_t input_pos = 0;
  uint64_t n_out = 0;
  int halt = HALT_NONE;
  uint64_t exit_code = 0;

  const uint64_t code_end = CODE_BASE + 4 * n_words;

  while (halt == HALT_NONE) {
    if (cycles >= max_cycles) {
      halt = HALT_CYCLE_LIMIT;
      break;
    }
    if (pc % 4 != 0 || pc < CODE_BASE || pc >= code_end) {
      halt = HALT_ERROR;
      break;
    }
    const uint32_t word = code[(pc - CODE_BASE) >> 2];
    const uint32_t op = word & 0x7F;
    const uint32_t f_rd = (word >> 7) & 0xF;
    const uint32_t f_rs1 = (word >> 11) & 0xF;
    const uint32_t f_rs2 = (word >> 15) & 0xF;
    // 17-bit sign-extended immediate (encoding.rs:103-112).
    const int64_t imm17 =
        (static_cast<int64_t>((word >> 15) & 0x1FFFF) ^ 0x10000) - 0x10000;
    // 21-bit sign-extended J offset (encoding.rs:127-136).
    const int64_t imm21 =
        (static_cast<int64_t>((word >> 11) & 0x1FFFFF) ^ 0x100000) - 0x100000;

    uint64_t next_pc = pc + 4;
    bool err = false;

#define RD regs[f_rd]
#define RS1 regs[f_rs1]
#define RS2 regs[f_rs2]
#define WR(v)                \
  do {                       \
    if (f_rd != 0) RD = (v); \
  } while (0)

    switch (op) {
      // ===== Arithmetic =====
      case 0x00: WR(((RS1 & M40) + (RS2 & M40)) & M40); break;  // ADD
      case 0x01: WR(((RS1 & M40) - (RS2 & M40)) & M40); break;  // SUB
      case 0x02: WR(((RS1 & M40) * (RS2 & M40)) & M40); break;  // MUL
      case 0x03: {  // MULH: bits [40,80) of the raw u64 product
        __uint128_t prod = static_cast<__uint128_t>(RS1) * RS2;
        WR(static_cast<uint64_t>(prod >> 40) & M40);
        break;
      }
      case 0x04: {  // DIVU
        if (RS2 == 0) { err = true; break; }
        WR(RS1 / RS2);
        break;
      }
      case 0x05: {  // REMU
        if (RS2 == 0) { err = true; break; }
        WR(RS1 % RS2);
        break;
      }
      case 0x06: {  // DIV (raw i64, execute.rs:117-132)
        if (RS2 == 0) { err = true; break; }
        int64_t a = static_cast<int64_t>(RS1);
        int64_t b = static_cast<int64_t>(RS2);
        // Wrapping semantics for INT64_MIN / -1 (Rust wrapping_div).
        WR(b == -1 ? (0ull - static_cast<uint64_t>(a))
                   : static_cast<uint64_t>(a / b));
        break;
      }
      case 0x07: {  // REM
        if (RS2 == 0) { err = true; break; }
        int64_t a = static_cast<int64_t>(RS1);
        int64_t b = static_cast<int64_t>(RS2);
        WR(static_cast<uint64_t>(b == -1 ? 0 : a % b));
        break;
      }
      case 0x08:  // ADDI
        WR(((RS1 & M40) + (static_cast<uint64_t>(imm17) & M40)) & M40);
        break;

      // ===== Logical =====
      case 0x10: WR((RS1 & M40) & (RS2 & M40)); break;  // AND
      case 0x11: WR((RS1 & M40) | (RS2 & M40)); break;  // OR
      case 0x12: WR((RS1 & M40) ^ (RS2 & M40)); break;  // XOR
      case 0x13: WR((RS1 & M40) & (static_cast<uint64_t>(imm17) & M40)); break;
      case 0x14: WR((RS1 & M40) | (static_cast<uint64_t>(imm17) & M40)); break;
      case 0x15: WR((RS1 & M40) ^ (static_cast<uint64_t>(imm17) & M40)); break;

      // ===== Shifts =====
      case 0x18: {  // SLL
        uint64_t sh = RS2 & 0x3F;
        WR(sh >= 40 ? 0 : ((RS1 & M40) << sh) & M40);
        break;
      }
      case 0x19: {  // SRL
        uint64_t sh = RS2 & 0x3F;
        WR(sh >= 40 ? 0 : (RS1 & M40) >> sh);
        break;
      }
      case 0x1A: WR(sra40(RS1 & M40, RS2 & 0x3F)); break;  // SRA
      case 0x1B: {  // SLLI: 8-bit shamt field (decoder.rs:134-142)
        uint64_t sh = (word >> 15) & 0xFF;
        WR(sh >= 40 ? 0 : ((RS1 & M40) << (sh & 63)) & M40);
        break;
      }
      case 0x1C: {  // SRLI
        uint64_t sh = (word >> 15) & 0xFF;
        WR(sh >= 40 ? 0 : (RS1 & M40) >> (sh & 63));
        break;
      }
      case 0x1D: WR(sra40(RS1 & M40, (word >> 15) & 0xFF)); break;  // SRAI

      // ===== Compare =====
      case 0x20: WR((RS1 & M40) < (RS2 & M40) ? 1 : 0); break;   // SLTU
      case 0x21: WR((RS1 & M40) >= (RS2 & M40) ? 1 : 0); break;  // SGEU
      case 0x22: WR(signed_lt40(RS1 & M40, RS2 & M40) ? 1 : 0); break;
      case 0x23: WR(!signed_lt40(RS1 & M40, RS2 & M40) ? 1 : 0); break;
      case 0x24: WR(RS1 == RS2 ? 1 : 0); break;  // SEQ (raw u64)
      case 0x25: WR(RS1 != RS2 ? 1 : 0); break;  // SNE

      // ===== Conditional move =====
      case 0x26:  // CMOV
      case 0x28:  // CMOVNZ
        if (RS2 != 0) WR(RS1);
        break;
      case 0x27:  // CMOVZ
        if (RS2 == 0) WR(RS1);
        break;

      // ===== Loads (S-type register layout does not apply) =====
      case 0x30: {  // LB (sign-extend through 64 bits)
        uint64_t addr = RS1 + static_cast<uint64_t>(imm17);
        WR(static_cast<uint64_t>(
            static_cast<int64_t>(static_cast<int8_t>(mem.read_u8(addr)))));
        break;
      }
      case 0x31: {  // LBU
        uint64_t addr = RS1 + static_cast<uint64_t>(imm17);
        WR(mem.read_u8(addr));
        break;
      }
      case 0x32: {  // LH
        uint64_t addr = RS1 + static_cast<uint64_t>(imm17);
        uint16_t v;
        if (!mem.read(addr, &v)) { err = true; break; }
        WR(static_cast<uint64_t>(
            static_cast<int64_t>(static_cast<int16_t>(v))));
        break;
      }
      case 0x33: {  // LHU
        uint64_t addr = RS1 + static_cast<uint64_t>(imm17);
        uint16_t v;
        if (!mem.read(addr, &v)) { err = true; break; }
        WR(v);
        break;
      }
      case 0x34: {  // LW (zero-extends, execute.rs:525-535)
        uint64_t addr = RS1 + static_cast<uint64_t>(imm17);
        uint32_t v;
        if (!mem.read(addr, &v)) { err = true; break; }
        WR(v);
        break;
      }
      case 0x35: {  // LD
        uint64_t addr = RS1 + static_cast<uint64_t>(imm17);
        uint64_t v;
        if (!mem.read(addr, &v)) { err = true; break; }
        WR(v);
        break;
      }

      // ===== Stores (rs1 at rd position, encoding.rs:142-159) =====
      case 0x38: {  // SB
        uint64_t addr = regs[f_rd] + static_cast<uint64_t>(imm17);
        mem.write_u8(addr, static_cast<uint8_t>(regs[f_rs1]));
        break;
      }
      case 0x39: {  // SH
        uint64_t addr = regs[f_rd] + static_cast<uint64_t>(imm17);
        if (!mem.write(addr, static_cast<uint16_t>(regs[f_rs1]))) err = true;
        break;
      }
      case 0x3A: {  // SW
        uint64_t addr = regs[f_rd] + static_cast<uint64_t>(imm17);
        if (!mem.write(addr, static_cast<uint32_t>(regs[f_rs1]))) err = true;
        break;
      }
      case 0x3B: {  // SD
        uint64_t addr = regs[f_rd] + static_cast<uint64_t>(imm17);
        if (!mem.write(addr, regs[f_rs1])) err = true;
        break;
      }

      // ===== Branches (rs1/rs2 at rd/rs1 positions) =====
      case 0x40:  // BEQ (raw u64)
        if (regs[f_rd] == regs[f_rs1]) next_pc = pc + imm17;
        break;
      case 0x41:  // BNE
        if (regs[f_rd] != regs[f_rs1]) next_pc = pc + imm17;
        break;
      case 0x42:  // BLT (40-bit signed)
        if (signed_lt40(regs[f_rd] & M40, regs[f_rs1] & M40))
          next_pc = pc + imm17;
        break;
      case 0x43:  // BGE
        if (!signed_lt40(regs[f_rd] & M40, regs[f_rs1] & M40))
          next_pc = pc + imm17;
        break;
      case 0x44:  // BLTU
        if ((regs[f_rd] & M40) < (regs[f_rs1] & M40)) next_pc = pc + imm17;
        break;
      case 0x45:  // BGEU
        if ((regs[f_rd] & M40) >= (regs[f_rs1] & M40)) next_pc = pc + imm17;
        break;

      // ===== Jumps =====
      case 0x48:  // JAL
        WR(pc + 4);
        next_pc = pc + imm21;
        break;
      case 0x49:  // JALR
        WR(pc + 4);
        next_pc = (RS1 + static_cast<uint64_t>(imm17)) & ~1ull;
        break;

      // ===== System =====
      case 0x50: {  // ECALL (syscall.rs:94-177)
        uint64_t num = regs[10];
        if (num == 0) {  // EXIT
          halt = HALT_EXIT;
          exit_code = regs[11];
        } else if (num == 1) {  // READ
          regs[10] = input_pos < n_inputs ? inputs[input_pos++] : 0;
        } else if (num == 2) {  // WRITE
          if (n_out < max_outputs) out_outputs[n_out] = regs[11];
          n_out++;
        } else if (num <= 6) {
          halt = HALT_UNSUPPORTED_SYSCALL;  // crypto: use Python/TPU path
        } else {
          err = true;
        }
        break;
      }
      case 0x51:  // EBREAK
        halt = HALT_EBREAK;
        break;

      default:
        err = true;
    }
#undef RD
#undef RS1
#undef RS2
#undef WR

    if (err) {
      halt = HALT_ERROR;
      break;
    }
    if (halt == HALT_UNSUPPORTED_SYSCALL) break;
    pc = next_pc;
    cycles++;
  }

  std::memcpy(out_regs, regs, sizeof(regs));
  *out_n_outputs = n_out < max_outputs ? n_out : max_outputs;
  *out_cycles = cycles;
  *out_exit_code = exit_code;
  return halt;
}

}  // extern "C"
