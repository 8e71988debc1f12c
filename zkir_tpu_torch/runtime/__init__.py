"""Host runtime pieces: crypto syscall digests (the interpreter and the
prover) and the native engine (``native_vm``, ``run --engine native``)."""
