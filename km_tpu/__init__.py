"""km_tpu — targeted RNA-seq variant detection in JAX.

Capabilities mirror iric-soft/km (see /root/reference): given small FASTA
targets around suspected mutations and k-mer counts derived from RNA-seq
reads, discover and quantify SNVs, insertions, deletions, ITDs and I&I
events by walking a local de Bruijn graph seeded from the target.

Unlike km (pure Python over the external C++ Jellyfish counter), km_tpu is
built JAX/XLA-first:

- k-mers are 2-bit packed uint64 words; counting runs on-device via
  sort + segment-reduction (``km_tpu.ops.count``), with a host C++
  FASTQ/packing fast path (``km_tpu.native``).
- the count table is a sorted key array + prefix index with batched
  binary-search lookups (``km_tpu.ops.device_table``), shardable across a
  ``jax.sharding.Mesh`` by key prefix (``km_tpu.parallel``).
- graph walks over hundreds of catalog targets run as batched, masked
  frontier expansions instead of per-k-mer Python calls.

A host "exact" engine (``km_tpu.models``) reproduces km's outputs
byte-for-byte (reference: km/tools/find_mutation.py, km/tools/find_report.py)
and is the semantic spec the batched device path is validated against.
"""

__version__ = "0.1.0"

__all__ = ["io", "ops", "models", "parallel", "utils"]
