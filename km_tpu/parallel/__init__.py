"""Multi-device / multi-host execution: count-table sharding over a
jax.sharding.Mesh, all-to-all k-mer exchange during counting, and
replicated-query + psum lookups. Cross-device communication is expressed
exclusively through XLA collectives (shard_map + psum / all_to_all /
all_gather) — there is no hand-rolled communication runtime."""
