"""Variable-limb configuration for ZK-IR v3.4.

Host copy of ``zkir_tpu/spec/config.py`` (``Program`` headers carry it).

Parity target: reference ``zkir-spec/src/config.rs`` — same validation rules
(limb_bits in [16, 30] even, data_limbs in [1, 4], addr_limbs in [1, 2];
``config.rs:34-56``) and the same derived quantities (``config.rs:58-151``).

The config is a frozen dataclass of static Python values.
"""

from __future__ import annotations

from dataclasses import dataclass


class ConfigError(ValueError):
    """Invalid limb configuration."""


@dataclass(frozen=True)
class Config:
    """Program limb configuration.

    Default 20-bit x 2 limbs = 40-bit values and addresses
    (reference ``config.rs:27-31``).
    """

    limb_bits: int = 20
    data_limbs: int = 2
    addr_limbs: int = 2

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        if not (16 <= self.limb_bits <= 30):
            raise ConfigError("limb_bits must be in range [16, 30]")
        if self.limb_bits % 2 != 0:
            raise ConfigError("limb_bits must be even")
        if not (1 <= self.data_limbs <= 4):
            raise ConfigError("data_limbs must be in range [1, 4]")
        if not (1 <= self.addr_limbs <= 2):
            raise ConfigError("addr_limbs must be in range [1, 2]")

    # Derived quantities (reference config.rs:58-151)

    @property
    def data_bits(self) -> int:
        return self.limb_bits * self.data_limbs

    @property
    def addr_bits(self) -> int:
        return self.limb_bits * self.addr_limbs

    @property
    def chunk_bits(self) -> int:
        return self.limb_bits // 2

    @property
    def table_size(self) -> int:
        return 1 << self.chunk_bits

    @property
    def table_bytes(self) -> int:
        return self.table_size * 4

    @property
    def limb_mask(self) -> int:
        return (1 << self.limb_bits) - 1

    @property
    def chunk_mask(self) -> int:
        return (1 << self.chunk_bits) - 1

    @property
    def headroom(self) -> int:
        return max(self.data_bits - 32, 0)

    @property
    def max_deferred_adds(self) -> int:
        h = self.headroom
        return 1 if h == 0 else 1 << h

    @property
    def max_deferred_muls(self) -> int:
        h = self.headroom
        return 0 if h <= 1 else (h - 1) // 2

    @property
    def chunks_per_limb(self) -> int:
        return 2

    @property
    def chunks_per_value(self) -> int:
        return self.data_limbs * 2

    @property
    def chunks_per_addr(self) -> int:
        return self.addr_limbs * 2

    def __str__(self) -> str:
        return (
            f"Config {{ limb_bits: {self.limb_bits}, "
            f"data: {self.data_limbs}×{self.limb_bits}={self.data_bits} bits, "
            f"addr: {self.addr_limbs}×{self.limb_bits}={self.addr_bits} bits, "
            f"chunks: {self.chunk_bits}-bit, "
            f"table: {self.table_size} ({self.table_bytes // 1024} KB) }}"
        )


DEFAULT_CONFIG = Config()
