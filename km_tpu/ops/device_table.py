"""Device-resident count table with batched lookups (JAX).

Layout: keys as (hi, lo) uint32 pairs (the 64-bit packed k-mer split in
half, since JAX runs with 32-bit types by default), sorted
lexicographically,
plus a 2^P-entry *prefix index* mapping the top P bits of the key to the
start offset of that prefix's range. A batched query then runs a short
masked binary search inside its bucket (~log2(max_bucket) gather rounds
instead of log2(N)) — a two-level scheme that keeps random HBM reads per
lookup small.

Replaces the per-k-mer Python->C++ Jellyfish query calls of km
(reference: km/utils/Jellyfish.py:47-72) with O(10^5..10^6) lookups per
device dispatch. All queries are fixed-shape and jitted; absent keys
return 0, exactly like Jellyfish. Table arrays are passed to the jitted
kernels as arguments (never closed over), so one compilation serves
every table of the same padded size class.

The multi-host sharded variant (keys partitioned by leading bits across
a Mesh) lives in km_tpu.parallel.sharded_table.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

PREFIX_BITS = 16


def split_keys(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 host keys -> (hi, lo) uint32."""
    keys = np.asarray(keys, dtype=np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def join_keys(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


# ---------------------------------------------------------------------------
# jitted kernels (table arrays are arguments)


@partial(jax.jit, static_argnames=("prefix_bits", "rounds"))
def lookup_kernel(keys_hi, keys_lo, counts, bucket_starts, qhi, qlo,
                  *, prefix_bits: int, rounds: int):
    """Counts for (hi, lo) query keys (already canonical).

    Lower-bound binary search inside each query's prefix bucket; all
    queries advance in lockstep for ``rounds`` iterations (enough for the
    largest bucket), inactive lanes converge harmlessly.
    """
    n = keys_hi.shape[0]
    prefix = (qhi >> jnp.uint32(32 - prefix_bits)).astype(jnp.int32)
    low = bucket_starts[prefix]
    high = bucket_starts[prefix + 1]

    def body(_, lh):
        low, high = lh
        mid = (low + high) >> 1
        mhi = keys_hi[mid]
        mlo = keys_lo[mid]
        less = (mhi < qhi) | ((mhi == qhi) & (mlo < qlo))
        return jnp.where(less, mid + 1, low), jnp.where(less, high, mid)

    low, _high = jax.lax.fori_loop(0, rounds, body, (low, high))
    pos = jnp.minimum(low, n - 1)
    hit = (keys_hi[pos] == qhi) & (keys_lo[pos] == qlo)
    return jnp.where(hit, counts[pos], 0)


@partial(jax.jit, static_argnames=("k",))
def canonical_kernel(qhi, qlo, *, k: int):
    rhi, rlo = revcomp_split(qhi, qlo, k)
    take = (rhi < qhi) | ((rhi == qhi) & (rlo < qlo))
    return jnp.where(take, rhi, qhi), jnp.where(take, rlo, qlo)


@partial(jax.jit,
         static_argnames=("prefix_bits", "rounds", "k", "canonical",
                          "forward"))
def children_kernel(keys_hi, keys_lo, counts, bucket_starts, qhi, qlo,
                    ratio, n_cutoff, *, prefix_bits: int, rounds: int,
                    k: int, canonical: bool, forward: bool):
    """Thresholded 4-way extension of a batch of k-mers.

    Returns (child_hi, child_lo, child_counts, mask), shapes (..., 4) in
    A,C,G,T order; mask marks children passing
    max(sum_of_4_counts * ratio, n_cutoff) — km's per-parent grouped
    threshold (km/utils/Jellyfish.py:55-72).
    """
    chi, clo = child_keys_split(qhi, qlo, k, forward=forward)
    lhi, llo = (canonical_kernel(chi, clo, k=k) if canonical else (chi, clo))
    cnt = lookup_kernel(keys_hi, keys_lo, counts, bucket_starts, lhi, llo,
                        prefix_bits=prefix_bits, rounds=rounds)
    sums = cnt.sum(axis=-1, keepdims=True)
    thr = jnp.maximum(sums.astype(jnp.float32) * ratio,
                      n_cutoff.astype(jnp.float32))
    mask = cnt.astype(jnp.float32) >= thr
    return chi, clo, cnt, mask


class DeviceCountTable:
    """Immutable sorted count table on device."""

    def __init__(self, keys: np.ndarray, counts: np.ndarray, k: int,
                 canonical: bool, name: str = "",
                 prefix_bits: int = PREFIX_BITS):
        order = np.argsort(keys, kind="stable")
        keys = np.asarray(keys, np.uint64)[order]
        counts = np.asarray(counts)[order]
        self.k = int(k)
        self.canonical = bool(canonical)
        self.name = name
        self.n = len(keys)
        self.prefix_bits = prefix_bits

        # pad to a power of two (min 4096) with sentinel keys so tables of
        # similar size share compiled programs. Sentinel keys live in the
        # top prefix bucket, unreachable by real k<=31 queries, so the
        # search-round count stays driven by real buckets.
        cap = max(4096, 1 << max(int(np.ceil(np.log2(max(self.n, 2)))), 1))
        pad = cap - self.n
        keys_p = np.concatenate([keys, np.full(pad, ~np.uint64(0))])
        counts_p = np.concatenate(
            [counts.astype(np.int64), np.zeros(pad, np.int64)])

        hi, lo = split_keys(keys_p)
        self.keys_hi = jnp.asarray(hi)
        self.keys_lo = jnp.asarray(lo)
        self.counts = jnp.asarray(counts_p.astype(np.int32))

        shift = np.uint64(64 - prefix_bits)
        prefixes = (keys_p >> shift).astype(np.int64)
        starts = np.searchsorted(prefixes, np.arange((1 << prefix_bits) + 1))
        self.bucket_starts = jnp.asarray(starts.astype(np.int32))
        real = (keys >> shift).astype(np.int64)
        real_starts = np.searchsorted(real, np.arange((1 << prefix_bits) + 1))
        max_bucket = int((real_starts[1:] - real_starts[:-1]).max()) \
            if self.n else 1
        # small floor only: every extra lockstep round costs a full set
        # of gathers in the walk's hot loop, so the round count tracks
        # the actual largest bucket instead of a one-size-fits-all floor
        self.rounds = max(4, int(np.ceil(np.log2(max(max_bucket, 2)))) + 1)

    @classmethod
    def from_host(cls, table, **kw) -> "DeviceCountTable":
        return cls(np.asarray(table.keys), np.asarray(table.counts),
                   table.k, table.canonical, name=table.name, **kw)

    def _args(self):
        return (self.keys_hi, self.keys_lo, self.counts, self.bucket_starts)

    def lookup(self, qhi, qlo):
        """Counts for packed (possibly non-canonical) split queries."""
        if self.canonical:
            qhi, qlo = canonical_kernel(qhi, qlo, k=self.k)
        return lookup_kernel(*self._args(), qhi, qlo,
                             prefix_bits=self.prefix_bits,
                             rounds=self.rounds)

    def query_packed(self, keys: np.ndarray) -> np.ndarray:
        """Host-convenience: uint64 queries -> int64 counts (numpy).
        Pads to a power of two so compilations are shared across sizes."""
        keys = np.asarray(keys, dtype=np.uint64)
        flat = keys.reshape(-1)
        n = len(flat)
        if n == 0:
            return np.zeros(keys.shape, dtype=np.int64)
        padded = max(64, 1 << (n - 1).bit_length())
        buf = np.zeros(padded, dtype=np.uint64)
        buf[:n] = flat
        hi, lo = split_keys(buf)
        out = self.lookup(jnp.asarray(hi), jnp.asarray(lo))
        return np.asarray(out)[:n].astype(np.int64).reshape(keys.shape)

    def children(self, qhi, qlo, ratio: float, n_cutoff: int,
                 forward: bool = True):
        """Batched thresholded child expansion (device)."""
        return children_kernel(
            *self._args(), qhi, qlo, jnp.float32(ratio),
            jnp.asarray(n_cutoff, jnp.int32),
            prefix_bits=self.prefix_bits, rounds=self.rounds, k=self.k,
            canonical=self.canonical, forward=forward)


# ---------------------------------------------------------------------------
# split-key bit manipulation (device)

# NB: numpy scalars, NOT jnp — module-level jax Arrays captured as jaxpr
# consts become runtime parameter buffers, and this jax build's dispatch
# fastpath drops const buffers on a function's second invocation
# ("Execution supplied 2 buffers but compiled program expected 5").
# numpy scalars inline as HLO literals instead.
_M2 = np.uint32(0x33333333)
_M4 = np.uint32(0x0F0F0F0F)
_M8 = np.uint32(0x00FF00FF)


def _revpairs32(v):
    """Reverse the 16 2-bit lanes of a uint32."""
    v = ((v >> jnp.uint32(2)) & _M2) | ((v & _M2) << jnp.uint32(2))
    v = ((v >> jnp.uint32(4)) & _M4) | ((v & _M4) << jnp.uint32(4))
    v = ((v >> jnp.uint32(8)) & _M8) | ((v & _M8) << jnp.uint32(8))
    v = (v >> jnp.uint32(16)) | (v << jnp.uint32(16))
    return v


def revcomp_split(hi, lo, k: int):
    """Reverse complement on (hi, lo) split keys."""
    rhi = _revpairs32(~lo)  # reversed+complemented low word -> high word
    rlo = _revpairs32(~hi)
    s = 64 - 2 * k  # right-align the k used base pairs
    if s == 0:
        return rhi, rlo
    if s < 32:
        sh = jnp.uint32(s)
        lo_out = (rlo >> sh) | (rhi << jnp.uint32(32 - s))
        hi_out = rhi >> sh
    else:
        sh = jnp.uint32(s - 32)
        lo_out = rhi >> sh
        hi_out = jnp.zeros_like(rhi)
    return hi_out, lo_out


def child_keys_split(hi, lo, k: int, forward: bool = True):
    """(hi, lo) -> the 4 extension candidate keys, shape (..., 4)."""
    ext = jnp.arange(4, dtype=jnp.uint32)
    if forward:
        if k <= 16:
            mask = jnp.uint32((1 << (2 * (k - 1))) - 1)
            nlo = ((lo & mask) << jnp.uint32(2))[..., None] | ext
            nhi = jnp.zeros_like(nlo)
        else:
            hi_mask = jnp.uint32((1 << (2 * (k - 16) - 2)) - 1)
            nhi = ((hi & hi_mask) << jnp.uint32(2)) | (lo >> jnp.uint32(30))
            nlo = (lo << jnp.uint32(2))[..., None] | ext
            nhi = jnp.broadcast_to(nhi[..., None], nlo.shape)
    else:
        base_lo = (lo >> jnp.uint32(2)) | (hi << jnp.uint32(30))
        base_hi = hi >> jnp.uint32(2)
        if k <= 16:
            nlo = base_lo[..., None] | (ext << jnp.uint32(2 * (k - 1)))
            nhi = jnp.broadcast_to(base_hi[..., None], nlo.shape)
        else:
            nhi = base_hi[..., None] | (ext << jnp.uint32(2 * (k - 1) - 32))
            nlo = jnp.broadcast_to(base_lo[..., None], nhi.shape)
    return nhi, nlo
