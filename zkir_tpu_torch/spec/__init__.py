"""Host-side data model (copies of the ``zkir_tpu.spec`` modules the
prover needs)."""

from .config import Config
from .program import Program, ProgramHeader
