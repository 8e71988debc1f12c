"""Memory layout constants for the default 40-bit address space.

Parity target: reference ``zkir-spec/src/lib.rs:48-70`` (the ``memory``
module constants).  Host copy of the part of ``zkir_tpu/spec/memlayout.py``
that the trace builder needs.
"""

CODE_BASE = 0x00_0000_1000
