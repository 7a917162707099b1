"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline: k-mers counted per second per chip (the device sort+reduce
counting kernel, steady state, data resident) — the capability that
replaces `jellyfish count`. vs_baseline compares against an estimated
20M k-mers/s for multithreaded Jellyfish on a commodity host (the
reference publishes no numbers; see BASELINE.md).

Survivability design: the parent process never imports jax. Every
stage runs as a subprocess under a hard wall-clock deadline, one at a
time (a JAX process reserves most of the card's memory); a stage that
hangs or dies only loses its own fields. The final JSON line is printed
from whatever completed, always, in bounded time.

Stages (each also runnable alone: `python bench.py --stage NAME`):
  golden    host-only NPM1 report byte-check            (no device)
  hostwalk  400-target catalog on the host batch path   (no device)
  counting  headline device counting throughput
  devwalk   full device pipeline (walk+Dijkstra+NNLS) on 400 targets,
            cold AND warm, rows asserted equal to the host pipeline
  e2e       64 MB FASTQ file -> count table, end to end
  sharded   one realistic-shape sharded pipeline step on a virtual
            8-device CPU mesh (reads-DP x table-TP), bytes exchanged
  scale     4000-target catalog, host and device paths
"""

import json
import os
import subprocess
import sys
import time

JELLYFISH_BASELINE_KMERS_PER_SEC = 20e6
K = 31


# ---------------------------------------------------------------------------
# stage implementations (run in subprocesses; each prints one JSON line)


def stage_golden():
    """NPM1 find_mutation|find_report golden check (host only)."""
    import contextlib
    import io as _io
    from argparse import Namespace
    from io import StringIO

    from km_tpu.tools.find_mutation import main_find_mut
    from km_tpu.tools.find_report import main_find_report

    from km_tpu.refdata import catalog_fa, jf_path

    target = catalog_fa("NPM1_4ins_exons_10-11utr")
    args = Namespace(count=5, graphical=False,
                     jellyfish_fn=jf_path("02H025_NPM1"),
                     ratio=0.05, steps=500, branchs=10, nodes=10000,
                     target_fn=[target], verbose=False, debug=False)
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        main_find_mut(args, None)
    fm = out.getvalue()
    rargs = Namespace(target=target, infile=StringIO(fm), info="vs_ref",
                      min_cov=1, exclu="", format=None)
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        main_find_report(rargs, None)
    rep = out.getvalue().split("\n")[2].split("\t")
    ok = (rep[3] == "ITD" and rep[5] == "4 | 1" and rep[8] == "0.484"
          and rep[9] == "2428")
    return {"golden_npm1_report_ok": bool(ok)}


def _make_catalog_targets(n_targets, k):
    from km_tpu.io.fasta import read_target
    from km_tpu.models.sequence import TargetSeq

    from km_tpu.refdata import catalog_dir

    cat = catalog_dir("GRCh38")
    base = []
    for fn in sorted(os.listdir(cat)):
        seqs, _ = read_target(os.path.join(cat, fn))
        base.append(("".join(seqs), os.path.splitext(fn)[0]))
    targets = []
    i = 0
    while len(targets) < n_targets:
        seq, name = base[i % len(base)]
        targets.append(TargetSeq(seq, f"{name}_{i}", k))
        i += 1
    return targets


def stage_hostwalk(n_targets: int = 400):
    """400-target batched catalog analysis, host table (pure numpy; the
    reference takes seconds *per target*)."""
    from km_tpu.models.batch import run_catalog
    from km_tpu.models.table import CountTable
    from km_tpu.refdata import jf_path

    host = CountTable.from_jf(jf_path("03H116_ITD"))
    targets = _make_catalog_targets(n_targets, host.k)
    t0 = time.perf_counter()
    rows = run_catalog(targets, host, walk="host")
    dt = time.perf_counter() - t0
    assert len(rows) == n_targets
    return {"catalog_walk_400_targets_s": round(dt, 3)}


def stage_counting(iters: int = 8, chunk: int = 1 << 24,
                   scan_chunks: int = 64):
    """Sustained device counting throughput.

    One dispatch = an in-program fori_loop over ``scan_chunks``
    independent chunks — the GB-scale streaming shape (one program
    invocation per ~0.5 GB of resident reads), which amortizes the
    per-dispatch overhead. Every chunk processes *distinct* data (rolled
    on device by a per-iteration offset).
    """
    import numpy as np

    import jax
    import jax.numpy as jnp

    from km_tpu.ops.count import count_chunk_device

    @jax.jit
    def step(codes, valid, salt):
        def body(i, acc):
            c = jnp.roll(codes, salt + i * jnp.int32(9973))
            _hi, _lo, cnt = count_chunk_device(c, valid, K,
                                               canonical=True)
            return acc + cnt.sum()

        return jax.lax.fori_loop(0, scan_chunks, body, jnp.int32(0))

    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 4, chunk, dtype=np.uint8))
    valid = jnp.ones(chunk, dtype=bool)

    compiled = step.lower(codes, valid, jnp.int32(0)).compile()
    out = compiled(codes, valid, jnp.int32(0))  # warm up + load
    _ = int(out)

    n_windows = (chunk - K + 1) * scan_chunks  # per dispatch
    # best of a few multi-iteration groups (every group executes
    # distinct salted data and reads every result back)
    group = 2
    best_dt = float("inf")
    salt = 100
    for _g in range(max(1, iters // group)):
        t0 = time.perf_counter()
        outs = [compiled(codes, valid, jnp.int32(salt + i))
                for i in range(group)]
        total = sum(int(o) for o in outs)  # forces every execution
        dt = time.perf_counter() - t0
        assert total == n_windows * group
        salt += group
        best_dt = min(best_dt, dt)
    rate = n_windows * group / best_dt
    result = {"value": round(rate, 1)}
    # device-memory traffic per k-mer from XLA's own cost model
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    bytes_accessed = float(ca.get("bytes accessed", 0.0))
    if bytes_accessed > 0:
        # the cost model reports the fori_loop body's accesses once, so
        # normalize per loop-iteration windows, not per dispatch
        result["count_hbm_bytes_per_kmer"] = round(
            bytes_accessed / (chunk - K + 1), 1)
    return result


def stage_devwalk(n_targets: int = 400):
    """Full device pipeline (single-dispatch walk, batched Dijkstra
    sweeps, batched float64 NNLS): cold (first run this process; XLA
    compiles ride the persistent cache) and warm timings, rows asserted
    equal to the host pipeline's (device correctness evidence)."""
    from km_tpu.models.batch import run_catalog
    from km_tpu.models.table import CountTable
    from km_tpu.ops.device_table import DeviceCountTable
    from km_tpu.refdata import jf_path

    host = CountTable.from_jf(jf_path("03H116_ITD"))
    targets = _make_catalog_targets(n_targets, host.k)
    host_rows = run_catalog(targets, host, walk="host")

    dev = DeviceCountTable.from_host(host)
    t0 = time.perf_counter()
    rows = run_catalog(targets, dev, walk="device")
    cold = time.perf_counter() - t0
    match = ([[str(r) for r in rs] for rs in rows]
             == [[str(r) for r in rs] for rs in host_rows])

    targets2 = _make_catalog_targets(n_targets, host.k)
    t0 = time.perf_counter()
    rows2 = run_catalog(targets2, dev, walk="device")
    warm = time.perf_counter() - t0
    assert len(rows2) == n_targets
    return {"catalog_walk_400_device_warm_s": round(warm, 3),
            "catalog_walk_400_device_cold_s": round(cold, 3),
            "device_rows_match_host": bool(match)}


def stage_e2e(target_mb: int = 64):
    """End-to-end counting on a real file: FASTQ bytes on disk -> parse
    (native C++) -> 2-bit packed upload -> one fused device dispatch per
    chunk (unpack + count + merge into a device-resident accumulator) ->
    single final readback (the capability of `jellyfish count <fastq>`,
    reference: example/run_leucegene.sh:22). Reads are sampled from a
    2 MB reference so the table stays small like a real transcriptome's.
    KM_TPU_E2E_MODE=chunked selects the per-chunk-readback path."""
    import tempfile

    import numpy as np

    from km_tpu.io.fastq import read_batches
    from km_tpu.ops import count as opcount

    override = os.environ.get("KM_TPU_BENCH_FASTQ")
    if override:
        path = override  # user-provided: never validated, never deleted
    else:
        path = os.path.join(tempfile.gettempdir(),
                            "km_tpu_bench_ref_%dmb.fastq" % target_mb)
        _ensure_synthetic_fastq(path, target_mb)

    mode = os.environ.get("KM_TPU_E2E_MODE", "stream")
    t0 = time.perf_counter()
    batches = read_batches([path], min_quality="+")
    if mode == "chunked":
        keys, counts = opcount.count_batches_device_compact(
            batches, K, canonical=True, min_count=1, chunk=1 << 24)
    else:
        try:
            keys, counts = opcount.count_batches_device_stream(
                batches, K, canonical=True, min_count=1)
        except opcount.CountCapacityOverflow:
            # stateless retry with room to spare (the fixture's 2 MB
            # reference yields ~2M distinct k-mers; default capacity
            # covers it, this guards KM_TPU_BENCH_FASTQ overrides)
            batches = read_batches([path], min_quality="+")
            keys, counts = opcount.count_batches_device_stream(
                batches, K, canonical=True, min_count=1,
                capacity=1 << 26)
    dt = time.perf_counter() - t0
    assert len(keys) > 0
    n_windows = int(np.asarray(counts, dtype=np.int64).sum())
    return {"count_e2e_file_kmers_per_s": round(n_windows / dt, 1),
            "count_e2e_file_mb": target_mb, "count_e2e_mode": mode}


def _ensure_synthetic_fastq(path: str, target_mb: int,
                            read_len: int = 100,
                            ref_mb: float = 2.0) -> None:
    """FASTQ of roughly target_mb megabytes sampled from a random
    ``ref_mb``-MB reference, like RNA-seq reads off a transcriptome:
    k-mers repeat with the coverage, so the count table is orders of
    magnitude smaller than the read volume (random unanchored reads
    would make every 31-mer unique and the benchmark unrealistically
    readback-bound).

    Written to a temp name then renamed, and size-validated, so a
    half-written file from a killed earlier run is never reused."""
    import numpy as np

    per_rec = 2 * read_len + 40
    n_reads = (target_mb << 20) // per_rec
    if os.path.exists(path):
        # quick validity check: expected byte size within 1%, and the
        # final record terminator in place
        want = None
        try:
            sz = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                tail_ok = f.read(1) == b"\n"
            want = sz > 0.99 * (target_mb << 20) and tail_ok
        except OSError:
            want = False
        if want:
            return
        os.unlink(path)

    rng = np.random.default_rng(0)
    ref_len = int(ref_mb * (1 << 20))
    ref = rng.integers(0, 4, ref_len, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)
    qual = b"I" * read_len
    block = 1 << 14
    offs_all = rng.integers(0, ref_len - read_len, n_reads)
    tmp = path + ".tmp.%d" % os.getpid()
    with open(tmp, "wb") as f:
        for lo in range(0, n_reads, block):
            offs = offs_all[lo:lo + block]
            idx = offs[:, None] + np.arange(read_len)[None, :]
            seqs = bases[ref[idx]]
            recs = []
            for i in range(len(offs)):
                recs.append(b"@r%d\n%s\n+\n%s\n" % (
                    lo + i, seqs[i].tobytes(), qual))
            f.write(b"".join(recs))
    os.replace(tmp, path)


def stage_sharded():
    """One full sharded pipeline step (count -> all_to_all exchange ->
    merge -> owner-routed lookups -> child expansion) at realistic
    shapes on the virtual 8-device CPU mesh: wall time + bytes
    exchanged, with the routed lookup's payload compared against
    the replicate+psum broadcast it replaced. CPU-mesh scale evidence
    for the multi-device path."""
    import numpy as np

    import jax

    jax.config.update("jax_platforms", "cpu")  # virtual 8-device mesh

    from km_tpu.parallel.pipeline_step import build_full_step
    from km_tpu.parallel.sharded_table import SENTINEL

    from jax.sharding import Mesh
    import jax.numpy as jnp

    devices = np.array(jax.devices("cpu")[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("reads", "shard"))
    R, S = 2, 4
    chunk = 1 << 18           # codes per device per step
    queries_per_row = 1 << 14  # walk-tip batch per reads-row
    bucket_cap = 2 * chunk // S + 1024

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (R, S, chunk), dtype=np.uint8)
    valid = np.ones((R, S, chunk), dtype=bool)
    from km_tpu.ops import encode as _encode

    n_keys = 1 << 20  # 1M-record persistent table
    # canonical keys, like any real counted table: the shard boundaries
    # are then quantiles of the same distribution canonicalized walk
    # queries follow, which is what keeps the routed buckets balanced
    keys = np.unique(_encode.canonical(
        rng.integers(0, 1 << 62, n_keys, dtype=np.uint64), K))
    per = -(-len(keys) // S)
    pad = per * S - len(keys)
    hi = np.concatenate([(keys >> np.uint64(32)).astype(np.uint32),
                         np.full(pad, SENTINEL, np.uint32)])[None]
    lo = np.concatenate([(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                         np.full(pad, SENTINEL, np.uint32)])[None]
    cnts = np.concatenate([rng.integers(1, 100, len(keys)),
                           np.zeros(pad)]).astype(np.int32)[None]
    rounds = max(1, int(np.ceil(np.log2(max(per, 2)))) + 1)
    starts = np.minimum(np.arange(S) * per, len(keys) - 1)
    b_hi = (keys[starts] >> np.uint64(32)).astype(np.uint32)
    b_lo = (keys[starts] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    q = rng.integers(0, 1 << 62, (R, queries_per_row), dtype=np.uint64)
    qhi = (q >> np.uint64(32)).astype(np.uint32)
    qlo = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    # routed-lookup bucket: uniform per-owner expectation + 4 sigma
    q_local = queries_per_row // S
    mu = q_local // S
    query_cap = int(mu + 4 * mu ** 0.5) + 16
    step = build_full_step(mesh, K, chunk, bucket_cap, rounds, query_cap)
    args = (jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(hi),
            jnp.asarray(lo), jnp.asarray(cnts), jnp.asarray(qhi),
            jnp.asarray(qlo), jnp.asarray(b_hi), jnp.asarray(b_lo),
            jnp.float32(0.05), jnp.int32(5))
    out = step(*args)  # compile + first step
    jax.block_until_ready(out)
    qdropped = int(np.asarray(out[6]).sum())
    assert qdropped == 0, f"routed lookup dropped {qdropped} queries"
    t0 = time.perf_counter()
    out = step(*args)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    # all_to_all payload per device: n_shards buckets x bucket_cap x
    # (4+4+4) bytes, for each of R*S devices
    exchanged = R * S * S * bucket_cap * 12
    # query routing: tips (8B out + 4B back per slot) + 4x children,
    # per device S buckets x query_cap slots
    routed_bytes = R * S * S * query_cap * 12 * (1 + 4)
    # the replicate+psum broadcast this replaced: every device receives
    # all Q queries (8B) and contributes a Q-long psum partial (4B),
    # tips + 4x children
    broadcast_bytes = R * S * queries_per_row * 12 * (1 + 4)
    return {"sharded_step_8dev_warm_s": round(dt, 3),
            "sharded_step_exchanged_bytes": int(exchanged),
            "sharded_lookup_routed_bytes": int(routed_bytes),
            "sharded_lookup_broadcast_bytes": int(broadcast_bytes),
            "sharded_lookup_traffic_ratio": round(
                broadcast_bytes / routed_bytes, 2),
            "sharded_step_shapes": "R2xS4 chunk=%d queries=%d table=%d"
                                   % (chunk, queries_per_row, len(keys))}


def stage_scale(n_targets: int = 4000):
    """Catalog-scaling headroom: the same batched pipeline carries 10x
    the 400 targets (the reference runs ONE target in seconds,
    reference: km/tools/README.rst:91-92). Both the host and the device
    path are timed, against the bundled 03H116_ITD fixture table
    (scripts/bigtable_walk.py repeats the walk against a table of a
    real sample's size)."""
    from km_tpu.models.batch import run_catalog
    from km_tpu.models.table import CountTable
    from km_tpu.ops.device_table import DeviceCountTable
    from km_tpu.refdata import jf_path

    host = CountTable.from_jf(jf_path("03H116_ITD"))
    targets = _make_catalog_targets(n_targets, host.k)
    t0 = time.perf_counter()
    rows = run_catalog(targets, host, walk="host")
    host_dt = time.perf_counter() - t0
    assert len(rows) == n_targets

    dev = DeviceCountTable.from_host(host)
    targets = _make_catalog_targets(n_targets, host.k)
    run_catalog(targets, dev, walk="device")  # loads + warms
    targets = _make_catalog_targets(n_targets, host.k)
    t0 = time.perf_counter()
    rows = run_catalog(targets, dev, walk="device")
    dev_dt = time.perf_counter() - t0
    assert len(rows) == n_targets
    return {"catalog_walk_4000_host_s": round(host_dt, 3),
            "catalog_walk_4000_device_warm_s": round(dev_dt, 3),
            "catalog_walk_4000_host_targets_per_s":
                round(n_targets / host_dt, 1)}


STAGES = {
    "golden": stage_golden,
    "hostwalk": stage_hostwalk,
    "counting": stage_counting,
    "devwalk": stage_devwalk,
    "e2e": stage_e2e,
    "sharded": stage_sharded,
    "scale": stage_scale,
}

# (name, deadline_s, needs_device)
STAGE_PLAN = [
    ("golden", 90, False),
    ("hostwalk", 90, False),
    ("counting", 200, True),
    ("devwalk", 230, True),
    ("sharded", 150, False),
    ("scale", 150, True),
    ("e2e", 200, True),
]


def run_stage_subprocess(name: str, deadline: float):
    """Run one stage in a subprocess with a hard wall-clock kill.
    Returns (dict | None, error | None)."""
    env = dict(os.environ)
    if not _NEEDS_DEVICE[name]:
        # host-only stages stay off the card
        env["JAX_PLATFORMS"] = "cpu"
    if name == "sharded":
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--stage", name],
            capture_output=True, text=True, timeout=deadline, env=env,
            start_new_session=True)
    except subprocess.TimeoutExpired:
        return None, "timeout after %ds" % deadline
    if proc.returncode != 0:
        tail = (proc.stderr or "").strip().split("\n")[-3:]
        return None, "rc=%d: %s" % (proc.returncode, " | ".join(tail))
    for line in reversed((proc.stdout or "").strip().split("\n")):
        try:
            d = json.loads(line)
            if isinstance(d, dict):
                return d, None
        except (ValueError, TypeError):
            continue
    return None, "no JSON line in stage output"


_NEEDS_DEVICE = {n: t for n, _, t in STAGE_PLAN}


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        name = sys.argv[2]
        from km_tpu.utils.jaxcache import enable

        enable()
        result = STAGES[name]()
        print(json.dumps(result), flush=True)
        return

    # keeps the whole run (stages + one retry pass + process overheads)
    # safely inside a plausible external driver timeout
    budget = float(os.environ.get("KM_TPU_BENCH_BUDGET", "420"))
    t_start = time.perf_counter()
    extra = {"baseline_assumption": "jellyfish ~20e6 kmers/s/host"}
    errors = {}
    value = None

    def emit():
        """Cumulative JSON line; printed after every stage so a driver
        timeout kill can never erase completed stages — the LAST line
        on stdout is always the most complete result."""
        ex = dict(extra)
        if errors:
            ex["stage_errors"] = dict(errors)
        print(json.dumps({
            "metric": "kmers_counted_per_sec_per_chip",
            "value": round(value, 1) if value else 0.0,
            "unit": "kmers/s",
            "vs_baseline": (round(value / JELLYFISH_BASELINE_KMERS_PER_SEC,
                                  3) if value else 0.0),
            "extra": ex,
        }), flush=True)

    def attempt(name, deadline):
        nonlocal value
        result, err = run_stage_subprocess(name, deadline)
        if err:
            errors[name] = err
            print("bench stage %s failed: %s" % (name, err),
                  file=sys.stderr, flush=True)
            emit()
            return False
        errors.pop(name, None)
        if name == "counting":
            value = result.pop("value", None)
        extra.update(result)
        emit()
        return True

    # the first pass leaves RESERVE seconds for the retry pass
    RESERVE = min(120, budget / 4)
    for name, deadline, _ in STAGE_PLAN:
        remaining = (budget - RESERVE) - (time.perf_counter() - t_start)
        if remaining < 20:
            errors[name] = "skipped: global budget exhausted"
            continue
        attempt(name, min(deadline, remaining - 10))

    # spend any leftover budget retrying failed or budget-skipped
    # stages once, in plan order
    for name, deadline, _ in STAGE_PLAN:
        if name not in errors:
            continue
        remaining = budget - (time.perf_counter() - t_start)
        if remaining < min(90, RESERVE):
            break
        print("bench: retrying stage %s" % name, file=sys.stderr,
              flush=True)
        attempt(name, min(deadline, remaining - 10))

    emit()  # the final, authoritative line


if __name__ == "__main__":
    main()
