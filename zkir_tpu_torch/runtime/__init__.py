"""Host runtime pieces the prover needs (crypto syscall digests)."""
