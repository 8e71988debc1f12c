"""Memory layout constants for the default 40-bit address space.

Host copy of ``zkir_tpu/spec/memlayout.py``.

Parity target: reference ``zkir-spec/src/lib.rs:48-70`` (the ``memory``
module constants).
"""

RESERVED_BASE = 0x00_0000_0000
RESERVED_SIZE = 0x1000  # 4 KB

CODE_BASE = 0x00_0000_1000
CODE_SIZE = 0x10_0000_000  # 256 MB

DATA_BASE = 0x10_0000_000
DATA_SIZE = 0x10_0000_000  # 256 MB

HEAP_BASE = 0x20_0000_000

STACK_TOP = 0xFF_FFFF_FFFF

DEFAULT_STACK_SIZE = 1 << 20  # 1 MB
DEFAULT_HEAP_SIZE = 1 << 20  # 1 MB

# ABI constants (reference zkir-spec/src/lib.rs:76-99).
REGISTER_SIZE_BYTES = 4
PARAM_ALIGNMENT = 4
FRAME_ALIGNMENT = 16

INSTRUCTION_SIZE = 4
