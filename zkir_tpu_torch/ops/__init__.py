"""Device arithmetic on torch tensors: M31/CM31/QM31 fields, Poseidon2,
NTT, Merkle trees."""
