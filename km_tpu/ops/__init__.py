"""Compute ops: 2-bit k-mer encoding, count-table build/lookup, NNLS,
batched shortest paths. Host (numpy) and device (JAX) variants."""
