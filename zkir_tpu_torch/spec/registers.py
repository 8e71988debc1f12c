"""Register model: 16 registers r0-r15, 4-bit encoding, R0 hardwired zero.

Host copy of ``zkir_tpu/spec/registers.py``.

Parity target: reference ``zkir-spec/src/register.rs``.

NOTE on ABI alias maps: the reference carries *three mutually inconsistent*
alias tables (spec register.rs:14-61 vs assembler parser.rs:11-54 vs the
runtime's syscall comments).  Raw ``r0``-``r15`` numbering plus the runtime
syscall convention (R10=num, R11..R13=args, result→R10,
``zkir-runtime/src/syscall.rs:94-97``) is canonical; alias tables exist only
for text display/parsing and we keep both reference tables verbatim:

- ``REG_NAMES``   — the *spec* display map (register.rs:86-105), used by the
  disassembler formatter so listing text is byte-identical to the reference.
- ``REG_ALIASES`` — the *assembler* parse map (parser.rs:11-54), used when
  assembling text so encodings are bit-identical to the reference assembler.
"""

from __future__ import annotations

NUM_REGISTERS = 16

# Display names used by the reference disassembler formatter
# (zkir-spec/src/register.rs:86-105, via zkir-disassembler/src/formatter.rs:170-172).
REG_NAMES = (
    "zero", "ra", "sp", "fp",
    "a0", "a1", "a2", "a3",
    "a4", "a5", "s0", "s1",
    "s2", "s3", "t0", "t1",
)

# Parse map used by the reference assembler (zkir-assembler/src/parser.rs:11-54).
# Note this maps a0 -> r11 (NOT r4) — deliberately inconsistent with REG_NAMES,
# matching the reference bit-for-bit.
REG_ALIASES = {
    "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4, "fp": 5,
    "s0": 6, "s1": 7,
    "t0": 8, "t1": 9, "t2": 10,
    "a0": 11, "a1": 12, "a2": 13, "a3": 14, "a4": 15,
}
for _i in range(NUM_REGISTERS):
    REG_ALIASES[f"r{_i}"] = _i


def reg_from_name(name: str) -> int:
    """Parse a register name with the assembler's alias map (parser.rs:11-54)."""
    key = name.strip().lower()
    if key not in REG_ALIASES:
        raise KeyError(f"invalid register: {name}")
    return REG_ALIASES[key]


def reg_name(index: int) -> str:
    """Spec display name for a register index (register.rs:86-105)."""
    return REG_NAMES[index]
