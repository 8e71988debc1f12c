"""Host-side data model (copies of the ``zkir_tpu.spec`` modules the
prover needs)."""
