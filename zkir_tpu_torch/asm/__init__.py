"""Host-side toolchain: assembler and disassembler.

Bit-compatible with the reference ``zkir-assembler`` / ``zkir-disassembler``
crates: identical grammar (including ``.config`` directives and numeric
branch offsets), identical 32-bit encodings, and byte-identical disassembly
listing text.
"""

from .assembler import assemble, AssemblerError
from .disassembler import disassemble, decode, format_instruction
