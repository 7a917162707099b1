"""The full multi-device pipeline step, as one jitted program over a 2-D
mesh — the 'training step' analog of this framework.

Mesh axes:
- ``reads`` (data-parallel): independent read chunks / query batches —
  the analog of batch DP; samples of a cohort fan out here.
- ``shard`` (tensor-parallel): the count table's key space — the analog
  of TP; each device holds one slice of the sorted table.

One step does, entirely inside shard_map with XLA collectives:
1. count the local read chunk (sort + segment-reduce);
2. route (key, count) runs to their owner shard with ``all_to_all``
   over the shard axis (the counting exchange);
3. merge received runs locally (the owner's table delta);
4. look up a batch of walk queries against the persistent sharded
   table, **owner-routed**: each device holds a (reads, shard)-sharded
   slice of the query batch, buckets it by owner shard against the
   boundary keys, one ``all_to_all`` out, local binary search at the
   owner only, one ``all_to_all`` back (SURVEY §2.3's "all-to-all
   routed gather keyed by hash prefix"; sharded_table._route_and_lookup
   is the shared kernel). Interconnect traffic O(Q) instead of the
   old replicate+psum broadcast's O(Q x n_shards);
5. expand each query's 4 children and threshold them (one walk step) —
   child lookups ride the same routed exchange.

Outputs stay sharded: table deltas over (reads, shard), query counts
and child masks over (reads, shard). Routed-bucket overflow counts are
returned (qdropped) so callers can rebuild with a larger query_cap or
fall back to broadcast — results are never silently wrong.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import count as count_mod
from ..ops.count import count_chunk_device
from ..ops.device_table import child_keys_split, canonical_kernel
from .sharded_table import SENTINEL, _route_and_lookup


def build_full_step(mesh: Mesh, k: int, chunk: int, bucket_cap: int,
                    rounds: int, query_cap: int,
                    canonical: bool = True,
                    reads_axis: str = "reads", shard_axis: str = "shard"):
    n_shards = mesh.shape[shard_axis]
    shard_bits = max(1, int(np.ceil(np.log2(max(n_shards, 2)))))

    def kernel(codes, valid, keys_hi, keys_lo, counts, qhi, qlo,
               b_hi, b_lo, ratio, n_cutoff):
        # ---- 1. local count (codes arrive [1, 1, chunk] per device) ----
        hi, lo, cnt = count_chunk_device(codes[0, 0], valid[0, 0], k,
                                         canonical=canonical)

        # ---- 2./3. counting exchange over the shard axis ----
        owner = (hi >> jnp.uint32(32 - shard_bits)).astype(jnp.int32)
        owner = jnp.minimum(owner * n_shards >> shard_bits, n_shards - 1)
        owner = jnp.where(cnt > 0, owner, n_shards)
        order = jnp.argsort(owner, stable=True)
        owner_s, hi_s, lo_s, cnt_s = (owner[order], hi[order], lo[order],
                                      cnt[order])
        idx = jnp.arange(owner.shape[0])
        group_start = jnp.searchsorted(owner_s, jnp.arange(n_shards + 1))
        rank = idx - group_start[jnp.minimum(owner_s, n_shards)]
        keep = (owner_s < n_shards) & (rank < bucket_cap)
        slot = jnp.where(keep, owner_s * bucket_cap + rank,
                         n_shards * bucket_cap)
        dropped = jnp.sum((owner_s < n_shards) & (rank >= bucket_cap))
        bhi = jnp.full((n_shards * bucket_cap + 1,), SENTINEL, jnp.uint32) \
            .at[slot].set(hi_s)[:-1].reshape(n_shards, bucket_cap)
        blo = jnp.full((n_shards * bucket_cap + 1,), SENTINEL, jnp.uint32) \
            .at[slot].set(lo_s)[:-1].reshape(n_shards, bucket_cap)
        bcnt = jnp.zeros((n_shards * bucket_cap + 1,), jnp.int32) \
            .at[slot].set(cnt_s)[:-1].reshape(n_shards, bucket_cap)
        rhi = jax.lax.all_to_all(bhi, shard_axis, 0, 0).reshape(-1)
        rlo = jax.lax.all_to_all(blo, shard_axis, 0, 0).reshape(-1)
        rcnt = jax.lax.all_to_all(bcnt, shard_axis, 0, 0).reshape(-1)
        # a key arrives at most once from each sender (one nonzero entry
        # per globally sorted chunk; zero-count entries stay home)
        delta_hi, delta_lo, delta_cnt = count_mod.sum_runs_device(
            rhi, rlo, rcnt, max_run=n_shards)

        # ---- 4. owner-routed lookup on the persistent table ----
        qh = qhi[0]  # local slice [1, Q/S] -> [Q/S]
        ql = qlo[0]
        bh = jax.lax.pcast(b_hi, (reads_axis, shard_axis), to="varying")
        bl = jax.lax.pcast(b_lo, (reads_axis, shard_axis), to="varying")
        qh_c, ql_c = (canonical_kernel(qh, ql, k=k) if canonical
                      else (qh, ql))
        tip_counts, qdrop = _route_and_lookup(
            keys_hi[0], keys_lo[0], counts[0], qh_c, ql_c, bh, bl,
            shard_axis, n_shards, query_cap, rounds)

        # ---- 5. one walk step: thresholded child expansion (children
        # of the raw tips; lookups ride the same routed exchange) ----
        chi, clo = child_keys_split(qh, ql, k, forward=True)
        ch, cl = (canonical_kernel(chi, clo, k=k) if canonical
                  else (chi, clo))
        cc, cdrop = _route_and_lookup(
            keys_hi[0], keys_lo[0], counts[0],
            ch.reshape(-1), cl.reshape(-1), bh, bl,
            shard_axis, n_shards, 4 * query_cap, rounds)
        child_counts = cc.reshape(ch.shape)
        sums = child_counts.sum(axis=-1, keepdims=True)
        thr = jnp.maximum(sums.astype(jnp.float32) * ratio,
                          n_cutoff.astype(jnp.float32))
        child_mask = child_counts.astype(jnp.float32) >= thr

        return (delta_hi[None, None], delta_lo[None, None],
                delta_cnt[None, None], tip_counts[None],
                child_mask[None], dropped[None, None],
                (qdrop + cdrop)[None, None])

    mapped = jax.shard_map(
        kernel, mesh=mesh,
        in_specs=(P(reads_axis, shard_axis),        # codes [R, S, chunk]
                  P(reads_axis, shard_axis),        # valid
                  P(None, shard_axis),              # table keys_hi [1, N]
                  P(None, shard_axis),              # table keys_lo
                  P(None, shard_axis),              # table counts
                  P(reads_axis, shard_axis),        # qhi [R, Q]
                  P(reads_axis, shard_axis),        # qlo
                  P(), P(),                         # boundaries [S]
                  P(), P()),                        # ratio, n_cutoff
        out_specs=(P(reads_axis, shard_axis), P(reads_axis, shard_axis),
                   P(reads_axis, shard_axis),
                   P(reads_axis, shard_axis),       # tip_counts [R, Q]
                   P(reads_axis, shard_axis, None),  # child_mask [R, Q, 4]
                   P(reads_axis, shard_axis),
                   P(reads_axis, shard_axis)),      # qdropped
    )
    return jax.jit(mapped)


def demo_step(mesh: Mesh, k: int = 31, chunk: int = 4096,
              queries_per_row: int = 256):
    """Build tiny sharded inputs and run one full step on ``mesh``.
    Used by the multichip dry-run and the parallel tests."""
    R = mesh.shape["reads"]
    S = mesh.shape["shard"]
    rng = np.random.default_rng(0)

    codes = rng.integers(0, 4, (R, S, chunk), dtype=np.uint8)
    valid = np.ones((R, S, chunk), dtype=bool)

    # persistent table: random sorted keys, padded per shard
    n_keys = 1 << 12
    keys = np.unique(rng.integers(0, 1 << 62, n_keys, dtype=np.uint64))
    per = -(-len(keys) // S)
    pad = per * S - len(keys)
    hi = ((keys >> np.uint64(32)).astype(np.uint32))
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = np.concatenate([hi, np.full(pad, SENTINEL, np.uint32)])[None]
    lo = np.concatenate([lo, np.full(pad, SENTINEL, np.uint32)])[None]
    cnts = np.concatenate([rng.integers(1, 100, len(keys)),
                           np.zeros(pad)]).astype(np.int32)[None]
    rounds = max(1, int(np.ceil(np.log2(max(per, 2)))) + 1)
    # routing boundaries: first key of each shard (all shards nonempty
    # here, so no max-key placeholders)
    starts = np.minimum(np.arange(S) * per, len(keys) - 1)
    b_hi = (keys[starts] >> np.uint64(32)).astype(np.uint32)
    b_lo = (keys[starts] & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    assert queries_per_row % S == 0, "queries must split over shards"
    q = rng.integers(0, 1 << 62, (R, queries_per_row), dtype=np.uint64)
    qhi = (q >> np.uint64(32)).astype(np.uint32)
    qlo = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    bucket_cap = chunk            # safe bound
    query_cap = queries_per_row // S  # safe bound: no routed drop possible
    step = build_full_step(mesh, k, chunk, bucket_cap, rounds, query_cap)
    out = step(jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(hi),
               jnp.asarray(lo), jnp.asarray(cnts), jnp.asarray(qhi),
               jnp.asarray(qlo), jnp.asarray(b_hi), jnp.asarray(b_lo),
               jnp.float32(0.05), jnp.int32(5))
    return jax.tree.map(lambda x: np.asarray(x), out)
