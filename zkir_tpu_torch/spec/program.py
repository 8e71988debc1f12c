"""Program binary format: 32-byte little-endian header + code + data.

Host copy of ``zkir_tpu/spec/program.py`` (the prover binds proofs to a
program's code, data and entry point; fixtures carry ``Program.to_bytes()``).

Parity target: reference ``zkir-spec/src/program.rs`` — identical byte
layout (program.rs:36-95), serialize/deserialize (program.rs:170-213,
:300-346), validation, and the release/debug FormatMode heuristic
(program.rs:355-401).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import List, Optional

from .config import Config

MAGIC = 0x52494B5A  # "ZKIR" little-endian
VERSION = 0x00030004  # v3.4
HEADER_SIZE = 32

_HEADER_FMT = "<IIBBBBIIIII"  # magic, version, limb/data/addr/flags, entry, 4 sizes


class ZkIrError(ValueError):
    """Binary-format error (magic/version/size mismatch)."""


@dataclass
class ProgramHeader:
    magic: int = MAGIC
    version: int = VERSION
    limb_bits: int = 20
    data_limbs: int = 2
    addr_limbs: int = 2
    flags: int = 0
    entry_point: int = 0x1000  # CODE_BASE
    code_size: int = 0
    data_size: int = 0
    bss_size: int = 0
    stack_size: int = 1 << 20

    @staticmethod
    def with_config(config: Config) -> "ProgramHeader":
        config.validate()
        return ProgramHeader(
            limb_bits=config.limb_bits,
            data_limbs=config.data_limbs,
            addr_limbs=config.addr_limbs,
        )

    def config(self) -> Config:
        return Config(self.limb_bits, self.data_limbs, self.addr_limbs)

    def validate(self) -> None:
        if self.magic != MAGIC:
            raise ZkIrError(f"invalid magic: {self.magic:#010x}")
        if self.version != VERSION:
            raise ZkIrError(
                f"invalid version: expected {VERSION:#010x}, found {self.version:#010x}"
            )
        self.config()  # raises ConfigError on bad limb config

    def to_bytes(self) -> bytes:
        return struct.pack(
            _HEADER_FMT,
            self.magic, self.version,
            self.limb_bits, self.data_limbs, self.addr_limbs, self.flags,
            self.entry_point, self.code_size, self.data_size,
            self.bss_size, self.stack_size,
        )

    @staticmethod
    def from_bytes(data: bytes) -> "ProgramHeader":
        if len(data) < HEADER_SIZE:
            raise ZkIrError(
                f"invalid header size: expected {HEADER_SIZE}, found {len(data)}"
            )
        fields = struct.unpack(_HEADER_FMT, data[:HEADER_SIZE])
        header = ProgramHeader(*fields)
        header.validate()
        return header


@dataclass
class Program:
    header: ProgramHeader = field(default_factory=ProgramHeader)
    code: List[int] = field(default_factory=list)  # u32 instruction words
    data: bytes = b""

    @staticmethod
    def with_config(config: Config) -> "Program":
        return Program(header=ProgramHeader.with_config(config))

    @staticmethod
    def from_instructions(instrs, config: Optional[Config] = None) -> "Program":
        """Build a program from decoded instructions (test-vector helper,
        mirroring reference tests/stress_tests.rs:9-18)."""
        program = Program.with_config(config) if config else Program()
        program.code = [inst.encode() for inst in instrs]
        program.header.code_size = len(program.code) * 4
        return program

    def config(self) -> Config:
        return self.header.config()

    def validate(self) -> None:
        self.header.validate()
        if len(self.code) * 4 != self.header.code_size:
            raise ZkIrError(
                f"invalid code size: expected {self.header.code_size}, "
                f"found {len(self.code) * 4}"
            )
        if len(self.data) != self.header.data_size:
            raise ZkIrError(
                f"invalid data size: expected {self.header.data_size}, "
                f"found {len(self.data)}"
            )

    def to_bytes(self) -> bytes:
        out = bytearray(self.header.to_bytes())
        for word in self.code:
            out += struct.pack("<I", word & 0xFFFFFFFF)
        out += self.data
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "Program":
        header = ProgramHeader.from_bytes(data)
        code_start = HEADER_SIZE
        code_end = code_start + header.code_size
        data_end = code_end + header.data_size
        if len(data) < data_end:
            raise ZkIrError(
                f"invalid program size: expected {data_end}, found {len(data)}"
            )
        code_bytes = data[code_start:code_end]
        code = [
            struct.unpack("<I", code_bytes[i:i + 4])[0]
            for i in range(0, len(code_bytes) - len(code_bytes) % 4, 4)
        ]
        program = Program(header=header, code=code, data=data[code_end:data_end])
        program.validate()
        return program


class FormatMode(enum.Enum):
    """Release vs debug bytecode layout (reference program.rs:355-401)."""

    RELEASE = "release"
    DEBUG = "debug"

    @staticmethod
    def detect(data: bytes) -> Optional["FormatMode"]:
        if len(data) < HEADER_SIZE:
            return None
        magic = struct.unpack("<I", data[0:4])[0]
        if magic != MAGIC:
            return None
        entry_point = struct.unpack("<I", data[12:16])[0]
        # Release: entry_point >= CODE_BASE (0x1000); debug: a file offset.
        return FormatMode.RELEASE if entry_point >= 0x1000 else FormatMode.DEBUG

    @property
    def is_release(self) -> bool:
        return self is FormatMode.RELEASE

    @property
    def is_debug(self) -> bool:
        return self is FormatMode.DEBUG
