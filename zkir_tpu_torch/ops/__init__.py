"""Device arithmetic on torch tensors: M31/CM31/QM31 fields, Poseidon2,
NTT, Merkle trees, and the crypto syscalls' batched hashes (SHA-256,
Keccak-256, BLAKE3 over rows of bytes, ``byte_rows``)."""
