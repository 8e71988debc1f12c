"""Disassembler: Program -> annotated assembly listing.

Host copy of ``zkir_tpu/asm/disassembler.py``.

Parity target: reference ``zkir-disassembler`` — ``decode`` inverts the
encoder (decoder.rs:20-180), ``format_instruction`` matches the formatter
text exactly (formatter.rs:6-167, using the *spec* register display names),
and ``disassemble`` reproduces the listing layout byte-for-byte
(disassembler.rs:9-56).
"""

from __future__ import annotations

from ..spec.isa import DecodeError, Instruction
from ..spec.program import Program


def decode(word: int) -> Instruction:
    """Decode a 32-bit instruction word."""
    return Instruction.decode(word)


def format_instruction(inst: Instruction) -> str:
    """Format an instruction as assembly text."""
    return inst.format()


def disassemble(program: Program) -> str:
    """Disassemble a program into an annotated listing.

    Byte-identical to the reference listing (disassembler.rs:13-52):
    config header comments, then ``0xADDR:  WORD  mnemonic`` lines.
    """
    config = program.config()
    lines = [
        "; ZKIR v3.4 Disassembly",
        ";",
        "; Configuration:",
        f";   Limb bits:  {config.limb_bits}",
        f";   Data limbs: {config.data_limbs} ({config.data_bits}-bit values)",
        f";   Addr limbs: {config.addr_limbs} ({config.addr_bits}-bit addresses)",
        ";",
        f"; Entry point: 0x{program.header.entry_point:08X}",
        f"; Code size:   {program.header.code_size} bytes "
        f"({len(program.code)} instructions)",
        f"; Data size:   {program.header.data_size} bytes",
        "",
    ]

    addr = program.header.entry_point
    for word in program.code:
        prefix = f"0x{addr:08X}:  {word:08X}  "
        try:
            body = format_instruction(decode(word))
        except DecodeError as e:
            body = f"; ERROR: {e}"
        lines.append(prefix + body)
        addr += 4

    return "\n".join(lines) + "\n"
