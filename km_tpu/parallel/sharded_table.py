"""Count table sharded across a device mesh.

Sharding model (the scaling-book recipe, applied to k-mer tables):

- the sorted key space is cut into ``n_shards`` contiguous ranges of
  equal record count; shard s holds keys[range_s] padded with sentinel
  keys to a common length. Memory per device = N / n_shards records, so
  a mesh holds tables beyond one device's memory (a whole RNA-seq
  sample is ~1e9 records = 12 GB);
- **lookup (routed, the default)**: queries arrive *sharded* over the
  mesh; each device buckets its local queries by owner shard (a
  searchsorted against the shard-boundary keys), one ``all_to_all``
  delivers every query to the single shard that can answer it, the
  owner binary-searches only what it received, and a second
  ``all_to_all`` returns the answers. Interconnect traffic is O(Q) each
  way and
  search work is Q total — vs O(Q x n_shards) for both under the
  replicate+psum broadcast (SURVEY §2.3: "lookups = all-to-all routed
  gather keyed by hash prefix"). Bucket capacity is sized for the
  near-uniform key mix sliding windows produce; if adversarial skew
  overflows it, the dropped count is reported and the caller falls
  back to the broadcast path below — never a wrong answer;
- **lookup (broadcast fallback)**: queries replicated over the shard
  axis, every shard searches all of them, ``psum`` combines the
  disjoint hit-or-0 answers. More traffic, but capacity-free;
- **counting**: each device counts its own read chunk locally
  (sort + segment-reduce, km_tpu.ops.count), buckets the resulting
  (key, count) runs by owner shard (a hash of the key, so shards load
  evenly), and a fixed-size ``all_to_all`` routes every bucket to its
  owner, which sums what it received into one sorted run.

km has no distributed runtime to mirror (the reference is a
single-process tool over one mmapped file); this layer is what makes the
same workload span several devices.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.device_table import split_keys

SENTINEL = np.uint32(0xFFFFFFFF)


def make_mesh(n_devices: int | None = None, axis: str = "shard",
              devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.array(devices), (axis,))


# ---------------------------------------------------------------------------
# local (per-shard) primitives


def _local_lookup(keys_hi, keys_lo, counts, qhi, qlo, rounds: int):
    """Lower-bound binary search of (qhi, qlo) in the local sorted slice."""
    n = keys_hi.shape[0]
    # derive bounds from the query values (not just their shape) so that
    # inside shard_map they inherit the queries' varying-axis type
    low = (qhi & jnp.uint32(0)).astype(jnp.int32)
    high = low + jnp.int32(n)

    def body(_, lh):
        low, high = lh
        mid = (low + high) >> 1
        midc = jnp.minimum(mid, n - 1)
        mhi = keys_hi[midc]
        mlo = keys_lo[midc]
        less = (mhi < qhi) | ((mhi == qhi) & (mlo < qlo))
        return jnp.where(less, mid + 1, low), jnp.where(less, high, mid)

    low, _ = jax.lax.fori_loop(0, rounds, body, (low, high))
    pos = jnp.minimum(low, n - 1)
    hit = (keys_hi[pos] == qhi) & (keys_lo[pos] == qlo)
    return jnp.where(hit, counts[pos], 0)


def _route_and_lookup(keys_hi, keys_lo, counts, qhi, qlo, b_hi, b_lo,
                      axis: str, n_shards: int, cap: int, rounds: int):
    """Inside shard_map: local query slice [Qloc] -> counts [Qloc] by
    routing each query to its owner shard (see module note). Returns
    (counts, n_dropped_local); dropped queries (bucket overflow under
    adversarial skew) answer 0 and must be retried via the broadcast
    path by the caller."""
    Qloc = qhi.shape[0]
    # owner = rightmost shard whose first key <= q (queries below the
    # global minimum go to shard 0 and miss there, which is correct)
    le = ((b_hi[None, :] < qhi[:, None])
          | ((b_hi[None, :] == qhi[:, None])
             & (b_lo[None, :] <= qlo[:, None])))
    owner = jnp.maximum(le.astype(jnp.int32).sum(axis=1) - 1, 0)

    # bucket queries by owner: stable sort + rank within owner group
    order = jnp.argsort(owner, stable=True)
    owner_s = owner[order]
    qhi_s, qlo_s = qhi[order], qlo[order]
    idx = jnp.arange(Qloc, dtype=jnp.int32)
    group_start = jnp.searchsorted(owner_s, jnp.arange(n_shards + 1))
    rank = idx - group_start[owner_s].astype(jnp.int32)
    keep = rank < cap
    slot = jnp.where(keep, owner_s * cap + rank, n_shards * cap)
    dropped = jnp.sum(~keep)

    sent = jnp.uint32(SENTINEL)
    buck_hi = jnp.full((n_shards * cap + 1,), sent) \
        .at[slot].set(qhi_s)[:-1].reshape(n_shards, cap)
    buck_lo = jnp.full((n_shards * cap + 1,), sent) \
        .at[slot].set(qlo_s)[:-1].reshape(n_shards, cap)

    # bucket s -> shard s; received row j = queries shard j asks of us
    rq_hi = jax.lax.all_to_all(buck_hi, axis, 0, 0).reshape(-1)
    rq_lo = jax.lax.all_to_all(buck_lo, axis, 0, 0).reshape(-1)
    ans = _local_lookup(keys_hi, keys_lo, counts, rq_hi, rq_lo, rounds)
    # (sentinel fill queries can only match sentinel table padding,
    # whose count is 0 — harmless)

    # answers for sender j ride back on row j; received row o = owner
    # o's answers to our bucket o
    back = jax.lax.all_to_all(ans.reshape(n_shards, cap), axis, 0, 0)
    flat = back.reshape(-1)
    res_sorted = jnp.where(
        keep, flat[jnp.minimum(slot, n_shards * cap - 1)], 0)
    out = jnp.zeros(Qloc, dtype=ans.dtype).at[order].set(res_sorted)
    return out, dropped


class ShardedCountTable:
    """Count table partitioned into equal key ranges across a mesh."""

    def __init__(self, host_table, mesh: Mesh, axis: str = "shard"):
        self.mesh = mesh
        self.axis = axis
        self.k = host_table.k
        self.canonical = host_table.canonical
        self.name = host_table.name
        n_shards = mesh.shape[axis]

        keys = np.asarray(host_table.keys, np.uint64)
        counts = np.asarray(host_table.counts, np.int64)
        per = -(-max(len(keys), 1) // n_shards)  # ceil, >= 1
        pad = per * n_shards - len(keys)
        hi, lo = split_keys(keys)
        hi = np.concatenate([hi, np.full(pad, SENTINEL, np.uint32)])
        lo = np.concatenate([lo, np.full(pad, SENTINEL, np.uint32)])
        cnts = np.concatenate([counts, np.zeros(pad, np.int64)]).astype(np.int32)

        sharding = NamedSharding(mesh, P(axis))
        self.keys_hi = jax.device_put(hi, sharding)
        self.keys_lo = jax.device_put(lo, sharding)
        self.counts = jax.device_put(cnts, sharding)
        self.per_shard = per
        self.n_shards = n_shards
        self.rounds = max(1, int(np.ceil(np.log2(max(per, 2)))) + 1)
        # boundary = first key of each shard, the routing table. Shards
        # that are pure padding get the max key so the rightmost-<=
        # owner search can never route a real query to them.
        starts = np.arange(n_shards) * per
        if len(keys):
            bounds = keys[np.minimum(starts, len(keys) - 1)].copy()
            bounds[starts >= len(keys)] = np.uint64(0xFFFFFFFFFFFFFFFF)
        else:
            bounds = np.full(n_shards, np.uint64(0xFFFFFFFFFFFFFFFF))
        self.boundaries = bounds
        b_hi, b_lo = split_keys(bounds)
        repl = NamedSharding(mesh, P())
        self.b_hi = jax.device_put(b_hi, repl)
        self.b_lo = jax.device_put(b_lo, repl)

        self._lookup = self._build_lookup()
        self._routed_cache: dict[tuple[int, int], object] = {}

    def _build_lookup(self):
        axis = self.axis
        rounds = self.rounds

        def kernel(keys_hi, keys_lo, counts, qhi, qlo):
            # queries arrive replicated; mark them device-varying so the
            # search loop carry (which mixes in local table data) typechecks
            qhi = jax.lax.pcast(qhi, (axis,), to="varying")
            qlo = jax.lax.pcast(qlo, (axis,), to="varying")
            local = _local_lookup(keys_hi, keys_lo, counts, qhi, qlo, rounds)
            return jax.lax.psum(local, axis)

        mapped = jax.shard_map(
            kernel, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis), P(), P()),
            out_specs=P(),
        )
        return jax.jit(mapped)

    def lookup(self, qhi, qlo):
        """Replicated-query broadcast lookup; returns counts
        (replicated). Capacity-free fallback for lookup_routed."""
        if self.canonical:
            from ..ops.device_table import canonical_kernel

            qhi, qlo = canonical_kernel(qhi, qlo, k=self.k)
        return self._lookup(self.keys_hi, self.keys_lo, self.counts,
                            qhi, qlo)

    def _build_routed(self, q_local: int, cap: int):
        axis, S, rounds = self.axis, self.n_shards, self.rounds

        def kernel(keys_hi, keys_lo, counts, qhi, qlo, b_hi, b_lo):
            b_hi = jax.lax.pcast(b_hi, (axis,), to="varying")
            b_lo = jax.lax.pcast(b_lo, (axis,), to="varying")
            out, dropped = _route_and_lookup(
                keys_hi, keys_lo, counts, qhi, qlo, b_hi, b_lo,
                axis, S, cap, rounds)
            return out, dropped[None]

        mapped = jax.shard_map(
            kernel, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis),
                      P(), P()),
            out_specs=(P(axis), P(axis)),
        )
        return jax.jit(mapped)

    def routed_cap(self, q_local: int) -> int:
        """Per-owner bucket capacity for Qloc local queries: uniform
        expectation + 4 sigma + slack (sliding-window k-mer keys mix
        near-uniformly over the key space, so bucket loads concentrate
        binomially; overflow falls back to broadcast, never corrupts)."""
        mu = -(-q_local // self.n_shards)
        return min(q_local, int(mu + 4 * mu ** 0.5) + 16)

    def lookup_routed(self, qhi, qlo, cap: int | None = None):
        """Owner-routed lookup (module note): queries are split over
        the mesh, each travels to exactly one shard and back. Falls
        back to the broadcast path on bucket overflow (adversarial key
        skew), so results always equal :meth:`lookup`'s."""
        if self.canonical:
            from ..ops.device_table import canonical_kernel

            qhi, qlo = canonical_kernel(qhi, qlo, k=self.k)
        S = self.n_shards
        n = qhi.shape[0]
        # pad to a pow2 multiple of S: bounds compile classes AND makes
        # the per-device slice static
        per = max(64, 1 << (int(np.ceil(n / S)) - 1).bit_length())
        tot = per * S
        if tot > n:
            pad_hi = jnp.full(tot - n, SENTINEL, jnp.uint32)
            qhi = jnp.concatenate([jnp.asarray(qhi), pad_hi])
            qlo = jnp.concatenate([jnp.asarray(qlo), pad_hi])
        if cap is None:
            cap = self.routed_cap(per)
        key = (per, cap)
        fn = self._routed_cache.get(key)
        if fn is None:
            fn = self._routed_cache[key] = self._build_routed(per, cap)
        sharding = NamedSharding(self.mesh, P(self.axis))
        out, dropped = fn(self.keys_hi, self.keys_lo, self.counts,
                          jax.device_put(qhi, sharding),
                          jax.device_put(qlo, sharding),
                          self.b_hi, self.b_lo)
        if int(np.asarray(dropped).sum()):
            return self.lookup(qhi, qlo)[:n]
        return out[:n]

    def query_packed(self, keys: np.ndarray, routed: bool = True) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64)
        hi, lo = split_keys(keys.reshape(-1))
        look = self.lookup_routed if routed else self.lookup
        out = look(jnp.asarray(hi), jnp.asarray(lo))
        return np.asarray(out).astype(np.int64).reshape(keys.shape)

    # -- persistence: the "checkpoint" of the expensive counting phase --
    # (the reference has no analog — its .jf file is produced offline by
    # Jellyfish; here the sharded table itself is the reloadable artifact
    # so walks can rerun without recounting, SURVEY.md §5)

    def save(self, path: str) -> None:
        """Persist the sharded table (gathers shards to host memory)."""
        hi = np.asarray(self.keys_hi).astype(np.uint64)
        lo = np.asarray(self.keys_lo).astype(np.uint64)
        keys = (hi << np.uint64(32)) | lo
        counts = np.asarray(self.counts)
        real = counts > 0  # sentinel padding carries count 0
        np.savez(path, keys=keys[real], counts=counts[real].astype(np.uint32),
                 k=self.k, canonical=self.canonical)

    @classmethod
    def load(cls, path: str, mesh: Mesh,
             axis: str = "shard") -> "ShardedCountTable":
        """Reload a table saved by save() (or by CountTable.save — the
        on-disk format is shared) onto a mesh."""
        from ..models.table import CountTable

        host = CountTable.load(path)
        host.name = path
        return cls(host, mesh, axis=axis)


# ---------------------------------------------------------------------------
# sharded counting: local count -> all_to_all by owner -> local merge


def build_count_exchange(mesh: Mesh, axis: str, chunk: int, k: int,
                         canonical: bool, bucket_cap: int):
    """Jitted step: per-device read chunks -> per-device sorted (key,
    count) runs routed to their owner shard.

    Each device counts its chunk, buckets runs by owner (a multiplicative
    hash of the key's low word: the high word of a k=31 key uses only
    its low 30 bits, and canonical form skews its top bases, so neither
    can pick a balanced owner), pads each bucket to ``bucket_cap`` and
    exchanges bucket i to device i with one all_to_all. Returns (hi, lo,
    count) arrays of shape [n_shards * bucket_cap] per device, sorted,
    each key's total at one position (count 0 elsewhere), plus
    dropped-run accounting so callers can detect bucket_cap overflow
    (raise and retry with a larger cap).
    """
    from ..ops.count import count_chunk_device, sum_runs_device

    n_shards = mesh.shape[axis]

    def kernel(codes, valid):
        hi, lo, counts = count_chunk_device(codes[0], valid[0], k,
                                            canonical=canonical)
        h = (lo * jnp.uint32(0x9E3779B1)) >> jnp.uint32(16)
        owner = (h.astype(jnp.int32) * n_shards) >> 16
        owner = jnp.where(counts > 0, owner, n_shards)  # drop empty runs

        # stable-sort runs by owner, then slot each owner's runs into its
        # fixed-size bucket
        order = jnp.argsort(owner, stable=True)
        owner_s = owner[order]
        hi_s, lo_s, cnt_s = hi[order], lo[order], counts[order]
        # rank within owner group
        idx = jnp.arange(owner.shape[0])
        group_start = jnp.searchsorted(owner_s, jnp.arange(n_shards + 1))
        rank = idx - group_start[jnp.minimum(owner_s, n_shards)]
        keep = (owner_s < n_shards) & (rank < bucket_cap)
        slot = jnp.where(keep, owner_s * bucket_cap + rank, n_shards * bucket_cap)
        dropped = jnp.sum((owner_s < n_shards) & (rank >= bucket_cap))

        out_hi = jnp.full((n_shards * bucket_cap + 1,), SENTINEL, jnp.uint32)
        out_lo = jnp.full((n_shards * bucket_cap + 1,), SENTINEL, jnp.uint32)
        out_cnt = jnp.zeros((n_shards * bucket_cap + 1,), jnp.int32)
        out_hi = out_hi.at[slot].set(hi_s)
        out_lo = out_lo.at[slot].set(lo_s)
        out_cnt = out_cnt.at[slot].set(cnt_s)
        bhi = out_hi[:-1].reshape(n_shards, bucket_cap)
        blo = out_lo[:-1].reshape(n_shards, bucket_cap)
        bcnt = out_cnt[:-1].reshape(n_shards, bucket_cap)

        # route bucket s to device s (split local axis 0, concat received)
        rhi = jax.lax.all_to_all(bhi, axis, 0, 0).reshape(-1)
        rlo = jax.lax.all_to_all(blo, axis, 0, 0).reshape(-1)
        rcnt = jax.lax.all_to_all(bcnt, axis, 0, 0).reshape(-1)

        # local merge: scatter-free segmented sum of received runs. Each
        # sender's globally sorted chunk carries a real key at most once
        # (zero-count records were dropped above), so a key arrives at
        # most n_shards times; the sentinel padding's longer run sums
        # only zeros, where any bound is exact
        merged_hi, merged_lo, merged_cnt = sum_runs_device(
            rhi, rlo, rcnt, max_run=n_shards)
        return (merged_hi[None], merged_lo[None], merged_cnt[None],
                dropped[None])

    mapped = jax.shard_map(
        kernel, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )
    return jax.jit(mapped)


def sharded_count(batches, mesh: Mesh, k: int, axis: str = "shard",
                  canonical: bool = True, min_count: int = 1,
                  chunk: int = 1 << 18, bucket_cap: int | None = None):
    """Count k-mers across the mesh: reads split over devices, each
    device sums the runs of the keys it owns. Every device's result of
    every step is one sorted run; all runs combine in a single native
    k-way merge at the end (numpy pairwise merge as fallback). Returns
    host (keys, counts)."""
    from .. import native
    from ..ops.count import chunk_stream, merge_runs

    n_shards = mesh.shape[axis]
    if bucket_cap is None:
        # expected bucket load is chunk / n_shards runs; 2x + slack
        # covers ordinary skew, and the overflow retry below covers
        # adversarial inputs
        bucket_cap = min(chunk, 2 * chunk // n_shards + 1024)
    step = build_count_exchange(mesh, axis, chunk, k, canonical, bucket_cap)

    def device_groups():
        """Group overlapping chunks n_shards at a time (pad with empties)."""
        group = []
        for c, v in chunk_stream(batches, chunk, k):
            group.append((c, v))
            if len(group) == n_shards:
                yield group
                group = []
        if group:
            while len(group) < n_shards:
                group.append((np.zeros(chunk, np.uint8),
                              np.zeros(chunk, bool)))
            yield group

    runs: list[tuple[np.ndarray, np.ndarray]] = []
    for group in device_groups():
        c = np.stack([g[0] for g in group])
        v = np.stack([g[1] for g in group])
        while True:
            hi, lo, cnt, dropped = step(jnp.asarray(c), jnp.asarray(v))
            if not int(np.asarray(dropped).sum()):
                break
            # overflow: some device's runs for one owner exceeded the
            # bucket; re-dispatch this group with a doubled cap (the
            # overflowing dispatch only dropped runs, so its outputs are
            # discarded wholesale). chunk runs is the hard upper bound.
            bucket_cap = min(chunk, bucket_cap * 2)
            step = build_count_exchange(mesh, axis, chunk, k, canonical,
                                        bucket_cap)
        hi = np.asarray(hi).astype(np.uint64)
        lo = np.asarray(lo).astype(np.uint64)
        cnt = np.asarray(cnt)
        for d in range(n_shards):
            keep = cnt[d] > 0
            if keep.any():
                runs.append(((hi[d][keep] << np.uint64(32)) | lo[d][keep],
                             cnt[d][keep].astype(np.int64)))

    if not runs:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    if native.available():
        acc_keys, acc_counts = native.merge_sorted_runs(runs)
    else:
        acc_keys, acc_counts = runs[0]
        for rk, rc in runs[1:]:
            acc_keys, acc_counts = merge_runs(acc_keys, acc_counts, rk, rc)
    keep = acc_counts >= min_count
    return acc_keys[keep], acc_counts[keep].astype(np.uint32)
