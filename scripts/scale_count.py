"""GB-scale counting artifact: a billion-base sample counted into one
device-resident table, with the memory envelope reported.

Replicates the scale of the reference's real workload — `jellyfish
count` over one Leucegene RNA-seq sample (~1e9 bases of reads, 8 GB
host RAM, reference: example/README.rst:29) — on one device. The read
stream is synthesized ON DEVICE (reads sampled from a resident
reference with point mutations, like RNA-seq off a transcriptome), so
the measurement exercises the full counting+merge pipeline at GB scale
without host parsing or uploads; the end-to-end file number lives in
bench stage `e2e` alongside.

Pipeline per chunk (all device-resident, one dispatch):
  synthesize 2^24 bases -> window-pack + canonicalize -> sort + run
  detection -> merge into the persistent accumulator (sort + bounded
  run sum + compaction).
Readback happens ONCE at the end (the stream design).

Usage: python scripts/scale_count.py [--chunks N] [--capacity LOG2]
Writes a JSON line.
"""

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from km_tpu.utils.jaxcache import enable  # noqa: E402

enable()

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from km_tpu.ops.count import (SENTINEL32, count_chunk_device,  # noqa: E402
                              merge_accum_device)

K = 31
CHUNK = 1 << 24          # bases per device chunk
REF_LOG2 = 21            # 2 MB reference -> ~2M distinct k-mers + mutations


def build_step(capacity: int):
    """One fused dispatch: derive a distinct read chunk from the
    resident reference (roll + hash-sparse point mutations — pure
    elementwise ops), count it, merge into the donated accumulator."""

    def one_chunk(acc_hi, acc_lo, acc_cnt, base, idx):
        # distinct per chunk: rotation (new window phases) + ~1e-4
        # deterministic point mutations (~50k novel k-mers per chunk,
        # keeping the distinct set inside the accumulator like a real
        # transcriptome sample)
        codes = jnp.roll(base, idx * jnp.int32(99991))
        pos = jax.lax.broadcasted_iota(jnp.uint32, (CHUNK, 1), 0)[:, 0]
        h = (pos * jnp.uint32(2654435761)
             + idx.astype(jnp.uint32) * jnp.uint32(40503))
        mut = h < jnp.uint32(429497)  # ~1e-4 of the u32 range
        codes = jnp.where(mut, ((h >> jnp.uint32(16)) & 3).astype(
            jnp.uint8), codes)
        valid = jnp.ones(CHUNK, bool)
        rhi, rlo, rcnt = count_chunk_device(codes, valid, K,
                                            canonical=True)
        return merge_accum_device(acc_hi, acc_lo, acc_cnt,
                                  rhi, rlo, rcnt.astype(jnp.int32),
                                  capacity)

    def step(acc_hi, acc_lo, acc_cnt, base, idx0):
        # INNER_CHUNKS chunks per dispatch: the per-dispatch overhead
        # amortizes over ~0.25 GB of counted bases
        def body(j, carry):
            a, b, c, _nu = carry
            return one_chunk(a, b, c, base, idx0 * INNER_CHUNKS + j)

        nu0 = jnp.int32(0)
        return jax.lax.fori_loop(0, INNER_CHUNKS, body,
                                 (acc_hi, acc_lo, acc_cnt, nu0))

    return jax.jit(step, donate_argnums=(0, 1, 2))


INNER_CHUNKS = 16


def main():
    chunks = 64
    cap_log2 = 23
    args = sys.argv[1:]
    if "--chunks" in args:
        chunks = int(args[args.index("--chunks") + 1])
    if "--capacity" in args:
        cap_log2 = int(args[args.index("--capacity") + 1])
    C = 1 << cap_log2

    assert chunks % INNER_CHUNKS == 0, (chunks, INNER_CHUNKS)
    print("backend: %s" % jax.default_backend(), file=sys.stderr)
    step = build_step(C)
    # resident reference, uploaded once (2 MB tiled to one chunk)
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 1 << REF_LOG2, dtype=np.uint8)
    base = jnp.asarray(np.tile(ref, CHUNK >> REF_LOG2))
    acc_hi = jnp.full(C, np.uint32(SENTINEL32))
    acc_lo = jnp.full(C, np.uint32(SENTINEL32))
    acc_cnt = jnp.zeros(C, jnp.int32)

    # warm (compile + first exec), outside the timed region
    t_compile = time.perf_counter()
    acc_hi, acc_lo, acc_cnt, n_unique = step(acc_hi, acc_lo, acc_cnt,
                                             base, jnp.int32(0))
    jax.block_until_ready(acc_cnt)
    compile_s = time.perf_counter() - t_compile

    t0 = time.perf_counter()
    for i in range(1, chunks // INNER_CHUNKS):
        acc_hi, acc_lo, acc_cnt, n_unique = step(acc_hi, acc_lo, acc_cnt,
                                                 base, jnp.int32(i))
    # the scalar depends on every chunk's merge: reading it syncs the
    # whole loop
    n_uni = int(np.asarray(n_unique))
    dt = time.perf_counter() - t0
    assert n_uni <= C, "accumulator capacity exceeded: %d > %d" % (n_uni, C)

    # the one-time table readback, timed apart from the counting rate
    # (survivors sit compacted at the front; quarter-octave slice)
    t_rb = time.perf_counter()
    b = max(n_uni - 1, 1).bit_length()
    q = max(1 << max(b - 2, 0), 16)
    m = min(C, max(64, -(-n_uni // q) * q))
    hi = np.asarray(acc_hi[:m], dtype=np.uint64)[:n_uni]
    lo = np.asarray(acc_lo[:m], dtype=np.uint64)[:n_uni]
    cnt = np.asarray(acc_cnt[:m]).astype(np.int64)[:n_uni]
    readback_s = time.perf_counter() - t_rb

    keys = ((hi << np.uint64(32)) | lo)[cnt > 0]
    counts = cnt[cnt > 0]
    total_kmers = int(counts.sum())
    bases = chunks * CHUNK
    windows = chunks * (CHUNK - K + 1)
    assert total_kmers == windows, (total_kmers, windows)

    hbm_bytes = C * 12 + CHUNK * 2 * 16  # accumulator + transient buffers
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    out = {
        "metric": "count_gb_scale_device_kmers_per_s",
        "value": round((chunks - INNER_CHUNKS) * (CHUNK - K + 1) / dt, 1),
        "unit": "kmers/s",
        "bases_counted": bases,
        "gb_of_reads_equiv": round(bases * 2.4 / 1e9, 2),
        "distinct_kmers": len(keys),
        "accumulator_slots": C,
        "hbm_envelope_mb": round(hbm_bytes / 1e6, 1),
        "host_rss_mb": round(rss_mb, 1),
        "first_chunk_incl_compile_s": round(compile_s, 1),
        "steady_wall_s": round(dt, 2),
        "final_readback_s": round(readback_s, 2),
        "final_readback_mb": round(m * 12 / 1e6, 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
