"""K-mer counting kernels.

The device replacement for ``jellyfish count``'s lock-free hash table:
counting is a *sort + segment-reduce* — a deterministic formulation for
XLA (no scatter contention, no atomics, bit-reproducible regardless of
batch order within a chunk).

Device pipeline per fixed-size batch of concatenated read bases:
  codes (uint8) + validity mask
  -> sliding-window pack into (hi, lo) uint32 key pairs (k fused
     shift/or vector ops on the two 32-bit halves of the 64-bit key)
  -> reverse-complement by bit manipulation on the packed keys,
     lexicographic min for canonical form
  -> invalid windows forced to a sentinel key that sorts last with
     weight 0
  -> lax.sort (2 keys, lexicographic) + run-boundary detection
Host code merges per-batch (uint64 key, count) runs.

Counts per batch are exact; merging is associative, so multi-batch /
multi-device results are independent of partitioning. The sharded
variant (all-to-all by key prefix) lives in km_tpu.parallel.
"""

from __future__ import annotations

import numpy as np

from . import encode


# ---------------------------------------------------------------------------
# host (numpy) reference implementation


def window_valid(valid: np.ndarray, k: int) -> np.ndarray:
    """valid[i:i+k].all() for every window, via prefix sums."""
    cnt = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
    return (cnt[k:] - cnt[:-k]) == k


def count_batches_host(batches, k: int, canonical: bool = True,
                       min_count: int = 1):
    """Count k-mers over (codes, valid) batches on the host."""
    acc_keys = np.empty(0, dtype=np.uint64)
    acc_counts = np.empty(0, dtype=np.int64)
    for codes, valid in batches:
        if codes.size < k:
            continue
        keys = encode.pack_code_windows(codes, k)
        keys = keys[window_valid(valid, k)]
        if canonical:
            keys = encode.canonical(keys, k)
        uk, uc = np.unique(keys, return_counts=True)
        acc_keys, acc_counts = merge_runs(acc_keys, acc_counts, uk, uc)
    keep = acc_counts >= min_count
    return acc_keys[keep], acc_counts[keep].astype(np.uint32)


def merge_runs(k1, c1, k2, c2):
    """Merge two sorted (key, count) runs, summing duplicate keys.
    Duplicates *within* either run are collapsed too."""
    keys = np.concatenate([k1, k2])
    counts = np.concatenate([c1.astype(np.int64), c2.astype(np.int64)])
    if not len(keys):
        return keys, counts
    order = np.argsort(keys, kind="stable")
    keys, counts = keys[order], counts[order]
    new_run = np.empty(len(keys), dtype=bool)
    new_run[0] = True
    new_run[1:] = keys[1:] != keys[:-1]
    run_id = np.cumsum(new_run) - 1
    out_keys = keys[new_run]
    out_counts = np.zeros(len(out_keys), dtype=np.int64)
    np.add.at(out_counts, run_id, counts)
    return out_keys, out_counts


def chunk_stream(batches, chunk: int, k: int):
    """Re-chunk (codes, valid) batches into fixed ``chunk``-length pieces
    overlapping by k-1 bases, so the pieces' windows exactly tile the
    stream's windows (no boundary k-mer lost, none double-counted).
    Batches are first joined into slabs of at least four chunks
    (_coalesce_batches), so short batches do not each pad a whole chunk.
    Trailing space is padded with invalid positions."""
    stride = chunk - k + 1
    assert stride > 0, "chunk must exceed k"
    for codes, valid in _coalesce_batches(batches, k, 4 * chunk):
        n_windows = codes.size - k + 1
        if n_windows <= 0:
            continue
        for off in range(0, n_windows, stride):
            c = codes[off:off + chunk]
            v = valid[off:off + chunk]
            if c.size < chunk:
                pad = chunk - c.size
                c = np.concatenate([c, np.zeros(pad, np.uint8)])
                v = np.concatenate([v, np.zeros(pad, bool)])
            yield c, v


# ---------------------------------------------------------------------------
# device (JAX) implementation


def _jnp():
    import jax.numpy as jnp

    return jnp


def pack_windows_device(codes, k: int):
    """codes (uint32, int-valued 0..3) -> (hi, lo) uint32 key pairs for all
    n-k+1 windows. hi holds the first k-16 bases (0 if k <= 16), lo the
    last min(k,16) bases."""
    jnp = _jnp()
    n = codes.shape[0] - k + 1
    lo_bases = min(k, 16)
    hi_bases = k - lo_bases
    lo = jnp.zeros((n,), jnp.uint32)
    for j in range(lo_bases):  # bases hi_bases .. k-1
        lo = (lo << jnp.uint32(2)) | codes[hi_bases + j : hi_bases + j + n]
    hi = jnp.zeros((n,), jnp.uint32)
    for j in range(hi_bases):
        hi = (hi << jnp.uint32(2)) | codes[j : j + n]
    return hi, lo


def canonical_device(hi, lo, rc_hi, rc_lo):
    jnp = _jnp()
    take_rc = (rc_hi < hi) | ((rc_hi == hi) & (rc_lo < lo))
    return jnp.where(take_rc, rc_hi, hi), jnp.where(take_rc, rc_lo, lo)


SENTINEL32 = 0xFFFFFFFF


def runs_from_sorted(shi, slo):
    """Sorted key pairs -> (shi, slo, run_lengths) with each run's length
    stored *in place* at its start position (zeros elsewhere).

    Fully scan-based — no second sort, no scatter, no gather: the next
    run start after every position is a reverse cummin over start
    indices, and a run's length is the difference. Consumers filter on
    ``length > 0`` (they already must, for the padding), so no
    compaction pass (an extra sort plus random gathers) is needed.
    """
    import jax
    jnp = _jnp()

    n = shi.shape[0]
    new_run = jnp.concatenate([
        jnp.ones(1, dtype=bool),
        (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1]),
    ])
    idx = jnp.where(new_run, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
    # next start strictly after i = suffix-min of idx shifted left by one
    nxt = jax.lax.cummin(
        jnp.concatenate([idx[1:], jnp.full((1,), n, jnp.int32)]),
        reverse=True)
    lengths = jnp.where(new_run, nxt - jnp.arange(n, dtype=jnp.int32), 0)
    return shi, slo, lengths


def sum_runs_device(rhi, rlo, rcnt, max_run: int):
    """Unsorted (key, count) records -> sorted keys with each unique
    key's summed count stored in place at its run start (zeros
    elsewhere; consumers filter on ``count > 0``).

    ``max_run`` is an upper bound on how many input records can share
    one key (zero-count records included; only the all-zero sentinel
    run may exceed it). Run totals come from a *bounded*
    segmented doubling scan: ceil(log2(max_run)) rounds of static-slice
    shifts + masked adds, no gathers. Callers derive the bound
    structurally from their inputs (see MERGE_MAX_RUN and the sharded
    exchange): a bound SMALLER than a real run silently undercounts, so
    it is never guessed."""
    import jax
    jnp = _jnp()

    shi, slo, scnt = jax.lax.sort((rhi, rlo, rcnt), num_keys=2)
    new_run = jnp.concatenate([
        jnp.ones(1, dtype=bool),
        (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1]),
    ])
    rid = jnp.cumsum(new_run.astype(jnp.int32))
    s = scnt
    d = 1
    while d < max_run:
        rid_s = jnp.concatenate([rid[d:], jnp.full(d, -1, rid.dtype)])
        s_s = jnp.concatenate([s[d:], jnp.zeros(d, s.dtype)])
        s = s + jnp.where(rid_s == rid, s_s, 0)
        d *= 2
    return shi, slo, jnp.where(new_run, s, 0)


def pack_keys_device(codes, valid, k: int, canonical: bool = True):
    """Jittable: uint8 code chunk of length n + validity mask -> (hi, lo)
    uint32 keys of its n-k+1 windows, canonical if asked; windows with
    an invalid base are the sentinel pair."""
    jnp = _jnp()

    sentinel = jnp.uint32(SENTINEL32)
    codes = codes.astype(jnp.uint32)
    n = codes.shape[0] - k + 1
    hi, lo = pack_windows_device(codes, k)
    if canonical:
        # reverse-complement via bit manipulation on the packed keys —
        # no second pack over reversed codes needed
        from .device_table import revcomp_split

        rhi, rlo = revcomp_split(hi, lo, k)
        hi, lo = canonical_device(hi, lo, rhi, rlo)

    cnt = jnp.cumsum(valid.astype(jnp.int32))
    wv = (cnt[k - 1:] -
          jnp.concatenate([jnp.zeros(1, jnp.int32), cnt[: n - 1]])) == k
    return jnp.where(wv, hi, sentinel), jnp.where(wv, lo, sentinel)


def count_chunk_device(codes, valid, k: int, canonical: bool = True):
    """Jittable: fixed-size uint8 code chunk -> globally sorted (hi, lo)
    keys with each unique key's count stored at its run start (zeros
    elsewhere; callers filter on count > 0). Every key therefore carries
    a nonzero count at exactly one position. Invalid or off-the-end
    windows collapse onto a sentinel key whose run is zeroed here. The
    three stages carry stable names (pack, sort, runs) for traces."""
    import jax
    jnp = _jnp()

    with jax.named_scope("pack"):
        hi, lo = pack_keys_device(codes, valid, k, canonical=canonical)
    with jax.named_scope("sort"):
        shi, slo = jax.lax.sort((hi, lo), num_keys=2)
    with jax.named_scope("runs"):
        rhi, rlo, lengths = runs_from_sorted(shi, slo)
        # kill the sentinel runs (invalid windows / end padding)
        sentinel = jnp.uint32(SENTINEL32)
        is_sent = (rhi == sentinel) & (rlo == sentinel)
        return rhi, rlo, jnp.where(is_sent, 0, lengths)


# ---------------------------------------------------------------------------
# streaming device accumulation: counts build up ON DEVICE, one readback
# at the end


def pack2_host(codes: np.ndarray, valid: np.ndarray):
    """Host-side 2-bit packing: (codes uint8, valid bool) of length n
    (n % 4 == 0) -> (packed uint8 [n/4], validbits uint8 [n/8]). Cuts
    the per-chunk host->device upload 5.3x (1 byte/base + 1 byte/flag
    -> 0.375 byte/base)."""
    n = codes.shape[0]
    assert n % 8 == 0
    c = codes.astype(np.uint8)
    packed = (c[0::4] | (c[1::4] << 2) | (c[2::4] << 4)
              | (c[3::4] << 6))
    validbits = np.packbits(valid, bitorder="little")
    return packed, validbits


def unpack2_device(packed, validbits, n: int):
    """Device-side inverse of pack2_host (pure elementwise + reshape —
    no gathers)."""
    jnp = _jnp()

    p = packed.astype(jnp.int32)
    codes = jnp.stack(
        [(p >> (2 * i)) & 3 for i in range(4)], axis=1).reshape(n)
    v = validbits.astype(jnp.int32)
    valid = jnp.stack(
        [(v >> i) & 1 for i in range(8)], axis=1).reshape(n) == 1
    return codes.astype(jnp.uint8), valid


# Records that can share one key in merge_accum_device: the chunk's
# count_chunk_device output carries each key at exactly one nonzero
# position (its run start in a globally sorted chunk), plus the
# accumulator's single compacted entry. Zero-count entries are keyed to
# the sentinel before the sum, so they never join a real key's run.
MERGE_MAX_RUN = 2


def merge_accum_device(acc_hi, acc_lo, acc_cnt, rhi, rlo, rcnt, C: int):
    """Merge a chunk's (key, count) runs into the device accumulator.

    The accumulator holds up to C unique keys (padding entries carry the
    sentinel key and count 0). Merge = concatenate, key entries with
    count 0 to the sentinel, sort + bounded run sum (sum_runs_device),
    then one stable flag-sort compacts the survivors to the front in
    key order. The chunk runs must come from :func:`count_chunk_device`
    (see MERGE_MAX_RUN). Returns (hi, lo, cnt, n_unique) at capacity C;
    n_unique > C means the capacity overflowed and the result is
    truncated (callers grow C and retry)."""
    import jax
    jnp = _jnp()

    sent = jnp.uint32(SENTINEL32)
    hi = jnp.concatenate([acc_hi, rhi])
    lo = jnp.concatenate([acc_lo, rlo])
    cnt = jnp.concatenate([acc_cnt, rcnt])
    dead = cnt == 0
    hi = jnp.where(dead, sent, hi)
    lo = jnp.where(dead, sent, lo)
    # the sentinel's own run may exceed the bound — harmlessly, its
    # contributions are all zero
    shi, slo, scnt = sum_runs_device(hi, lo, cnt, max_run=MERGE_MAX_RUN)
    alive = (scnt > 0) & ~((shi == sent) & (slo == sent))
    # stable sort on the dead flag compacts survivors to the front in
    # key order (lax.sort is stable)
    _, chi, clo, ccnt = jax.lax.sort(
        ((~alive).astype(jnp.int32), shi, slo, scnt), num_keys=1)
    n_unique = alive.sum()
    return chi[:C], clo[:C], ccnt[:C], n_unique


def _jitted_count_merge(k: int, canonical: bool, C: int, n: int):
    """One fused dispatch: unpack 2-bit codes, window-pack/canonicalize/
    sort/reduce the chunk, merge its runs into the donated accumulator.
    Also returns the running maximum of n_unique over every merge so
    far: a truncating merge can be followed by merges that fit again,
    so only the maximum tells whether any key was ever dropped."""
    key = ("merge", k, canonical, C, n)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        import jax
        jnp = _jnp()

        def run(packed, validbits, acc_hi, acc_lo, acc_cnt, peak):
            codes, valid = unpack2_device(packed, validbits, n)
            rhi, rlo, rcnt = count_chunk_device(codes, valid, k,
                                                canonical=canonical)
            with jax.named_scope("merge"):
                hi, lo, cnt, n_unique = merge_accum_device(
                    acc_hi, acc_lo, acc_cnt, rhi, rlo,
                    rcnt.astype(acc_cnt.dtype), C)
            return hi, lo, cnt, n_unique, jnp.maximum(peak, n_unique)

        fn = jax.jit(run, donate_argnums=(2, 3, 4))
        _JIT_CACHE[key] = fn
    return fn


def count_batches_device_stream(batches, k: int, canonical: bool = True,
                                min_count: int = 1, chunk: int = 1 << 24,
                                capacity: int = 1 << 22):
    """Streaming file->table counting: per chunk, upload 2-bit-packed
    bases (0.375 B/base) and run ONE fused dispatch (unpack + count +
    merge into a device-resident accumulator); nothing is read back
    until the final table. Replaces `jellyfish count <fastq>`
    (reference: example/run_leucegene.sh:22) end to end.

    On capacity overflow the work so far is DISCARDED: the truncated
    accumulator is unrecoverable (the input is a one-shot generator),
    so a ``CountCapacityOverflow`` is raised and the caller re-reads
    the input with a larger ``capacity`` (counting is stateless, so the
    retry is exact — see tools/count.py for the retry loop).
    Returns (keys uint64, counts uint32) like count_batches_device."""
    import jax.numpy as jnp

    if chunk % 8 != 0:
        raise ValueError(
            "chunk must be a multiple of 8 (the 2-bit host packer works "
            "in whole bytes); got %d" % chunk)

    C = capacity
    fn = None
    acc_hi = acc_lo = acc_cnt = peak = None
    # the running maximum only grows, so the scalar readback that would
    # force a device sync per chunk is only materialized every
    # OVERFLOW_CHECK_EVERY chunks and once at the end
    OVERFLOW_CHECK_EVERY = 16
    n_unique = None

    for i, (codes, valid) in enumerate(chunk_stream(batches, chunk, k)):
        if fn is None:
            fn = _jitted_count_merge(k, canonical, C, chunk)
            acc_hi = jnp.full(C, np.uint32(SENTINEL32))
            acc_lo = jnp.full(C, np.uint32(SENTINEL32))
            acc_cnt = jnp.zeros(C, jnp.int32)
            peak = jnp.zeros((), jnp.int32)
        packed, validbits = pack2_host(codes, valid)
        acc_hi, acc_lo, acc_cnt, n_unique, peak = fn(
            jnp.asarray(packed), jnp.asarray(validbits),
            acc_hi, acc_lo, acc_cnt, peak)
        if i % OVERFLOW_CHECK_EVERY == OVERFLOW_CHECK_EVERY - 1 \
                and int(peak) > C:
            raise CountCapacityOverflow(C)
    if peak is not None and int(peak) > C:
        raise CountCapacityOverflow(C)

    if acc_cnt is None:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    # the merge keeps survivors compacted at the front, so only the
    # first n_unique entries are read back, the slice length quantized
    # to bound the number of slice programs compiled: quarter-octave
    # steps read <= 25% extra at ~4 slice shapes per octave
    nu = int(n_unique)
    b = max(nu - 1, 1).bit_length()
    q = max(1 << max(b - 2, 0), 16)
    m = min(C, max(64, -(-nu // q) * q))
    hi = np.asarray(acc_hi[:m], dtype=np.uint64)[:nu]
    lo = np.asarray(acc_lo[:m], dtype=np.uint64)[:nu]
    cnt = np.asarray(acc_cnt[:m]).astype(np.int64)[:nu]
    keys = (hi << np.uint64(32)) | lo
    keep = (cnt >= min_count) & (cnt > 0)
    return keys[keep], cnt[keep].astype(np.uint32)


class CountCapacityOverflow(RuntimeError):
    """The streaming accumulator's capacity was exceeded; retry with a
    larger `capacity`."""

    def __init__(self, capacity: int):
        super().__init__(f"count accumulator capacity {capacity} "
                         f"exceeded; retry with a larger capacity")
        self.capacity = capacity


_JIT_CACHE: dict[tuple, object] = {}


def _jitted_count_chunk(k: int, canonical: bool):
    """One jit wrapper per static signature, statics closed over so the
    wrapper sees only array arguments (and each wrapper is built once —
    re-wrapping per call would discard jit's compile cache)."""
    key = (k, canonical)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        import functools

        import jax

        fn = jax.jit(functools.partial(
            count_chunk_device, k=k, canonical=canonical))
        _JIT_CACHE[key] = fn
    return fn


def _jitted_count_compact(k: int, canonical: bool, n: int):
    """One dispatch: unpack a 2-bit-packed chunk, count it, and compact
    the surviving runs to the front. Returns (hi, lo, cnt, n_runs); the
    host then transfers ONLY the first n_runs entries, so the readback
    shrinks from the window count to the distinct-run count. The chunk
    is globally sorted, so a stable sort on the dead flag alone keeps
    the survivors in key order, as the host k-way merge requires."""
    key = ("compact", k, canonical, n)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        import jax

        def run(packed, validbits):
            jnp = _jnp()
            codes, valid = unpack2_device(packed, validbits, n)
            hi, lo, cnt = count_chunk_device(codes, valid, k,
                                             canonical=canonical)
            alive = cnt > 0
            _, chi, clo, ccnt = jax.lax.sort(
                ((~alive).astype(jnp.int32), hi, lo, cnt), num_keys=1)
            return chi, clo, ccnt, alive.sum()

        fn = jax.jit(run)
        _JIT_CACHE[key] = fn
    return fn


def count_batches_device_compact(batches, k: int, canonical: bool = True,
                                 min_count: int = 1, chunk: int = 1 << 24):
    """File->table counting with no device-side capacity to size:
    2-bit-packed upload (0.375 B/base), one fused dispatch per chunk,
    device-side run compaction, and a readback of only the distinct
    runs; chunks merge on the host (native k-way merge when available).
    Counts are byte-identical to every other path."""
    import jax.numpy as jnp

    from .. import native

    if chunk % 8 != 0:
        raise ValueError("chunk must be a multiple of 8; got %d" % chunk)

    fn = _jitted_count_compact(k, canonical, chunk)
    runs: list[tuple[np.ndarray, np.ndarray]] = []
    pending = []
    for codes, valid in chunk_stream(batches, chunk, k):
        packed, validbits = pack2_host(codes, valid)
        pending.append(fn(jnp.asarray(packed), jnp.asarray(validbits)))
        # keep a couple of dispatches in flight, then drain in order
        if len(pending) >= 2:
            runs.append(_drain_compact(pending.pop(0)))
    while pending:
        runs.append(_drain_compact(pending.pop(0)))

    runs = [r for r in runs if len(r[0])]
    if not runs:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    if native.available():
        acc_keys, acc_counts = native.merge_sorted_runs(runs)
    else:
        acc_keys = np.empty(0, np.uint64)
        acc_counts = np.empty(0, np.int64)
        for rk, rc in runs:
            acc_keys, acc_counts = merge_runs(acc_keys, acc_counts, rk, rc)
    keep = acc_counts >= min_count
    return acc_keys[keep], acc_counts[keep].astype(np.uint32)


def _coalesce_batches(batches, k: int, min_len: int):
    """Concatenate input batches into >= min_len slabs, separated by
    k-1 invalid positions so no window spans two batches. Without this,
    chunk_stream would pad every (often small) batch to a full chunk and
    the device would count mostly padding."""
    sep_c = np.zeros(k - 1, np.uint8)
    sep_v = np.zeros(k - 1, bool)
    parts: list = []
    total = 0
    for codes, valid in batches:
        if parts:
            parts.append((sep_c, sep_v))
            total += k - 1
        parts.append((codes, valid))
        total += len(codes)
        if total >= min_len:
            yield (np.concatenate([p[0] for p in parts]),
                   np.concatenate([p[1] for p in parts]))
            parts, total = [], 0
    if parts:
        yield (np.concatenate([p[0] for p in parts]),
               np.concatenate([p[1] for p in parts]))


def _drain_compact(out):
    """(hi, lo, cnt, n_runs) device tuple -> host (keys, counts) sliced
    to the real runs. The device-side slice length is padded to a power
    of two: a raw [:n] would compile one slice program PER DISTINCT n;
    the <= 2x extra transfer is cheaper."""
    chi, clo, ccnt, n_runs = out
    n = int(n_runs)
    m = min(chi.shape[0], max(64, 1 << max(n - 1, 1).bit_length()))
    hi = np.asarray(chi[:m], dtype=np.uint64)[:n]
    lo = np.asarray(clo[:m], dtype=np.uint64)[:n]
    cnt = np.asarray(ccnt[:m]).astype(np.int64)[:n]
    return (hi << np.uint64(32)) | lo, cnt


def count_batches_device(batches, k: int, canonical: bool = True,
                         min_count: int = 1, chunk: int = 1 << 22):
    """Count k-mers over (codes, valid) host batches using the device
    kernel. Each device dispatch yields one globally sorted run; all
    runs combine in a single native k-way merge at the end (numpy
    pairwise merge as fallback)."""
    import jax.numpy as jnp

    from .. import native

    fn = _jitted_count_chunk(k, canonical)

    runs: list[tuple[np.ndarray, np.ndarray]] = []
    for codes, valid in chunk_stream(batches, chunk, k):
        hi, lo, counts = fn(jnp.asarray(codes), jnp.asarray(valid))
        hi = np.asarray(hi, dtype=np.uint64)
        lo = np.asarray(lo, dtype=np.uint64)
        counts = np.asarray(counts).astype(np.int64)
        keep = counts > 0
        if keep.any():
            runs.append((((hi << np.uint64(32)) | lo)[keep], counts[keep]))

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
