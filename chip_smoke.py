"""chip_smoke.py — km's main path on the GPU, end to end, at a size users run.

Usage: python chip_smoke.py [--seed N] [--cards 4] [--trace-out DIR]

Runs from the repository root, on a machine whose JAX default backend is
the GPU; anywhere else it exits non-zero before any phase. One process
imports JAX and runs the CLI phases as child processes, one at a time
(a JAX process reserves most of a card's memory when it starts; this
parent keeps its own reservation off with XLA_PYTHON_CLIENT_PREALLOCATE
and runs its in-process phases only after the children have ended).
The parent also turns XLA's command buffers off, so that its profiler
trace shows the count step's kernels one by one.

One card (the default), data made from ``--seed``:

1. count           ``km-tpu count -k 31 -L 2 -Q + --device gpu`` (the
                   upstream ``jellyfish count -m 31 -C -L 2 -Q+`` recipe,
                   example/run_leucegene.sh:22) over a synthetic FASTQ of
                   >= 1 GB: 100 bp reads from a 48 Mbase
                   transcriptome-like reference, Zipf expression over
                   transcripts, 0.1% substitution errors, both strands,
                   the bundled GRCh38 catalog targets at 300x and the NPM1
                   4-bp insertion at 40% VAF of 500x. The table must
                   equal the host counter's.
2. walk-counted    ``find_mutation --batch data/catalog/GRCh38`` on that
                   table at km's defaults; rows equal the host engine's
                   and include the planted NPM1 insertion.
3. catalog-fixtures the same against each bundled table in data/jf/;
                   rows equal the sequential host rows and the goldens.
4. count-kernel    one ``count_chunk_device`` step at 2^24 windows
                   against the host counter, timed, with the pack / sort
                   / runs split from one profiler trace.
5. catalog-bigtable 400 catalog targets through the ``--batch`` code
                   path (tools.batchmode.emit_batched) against the
                   03H116_ITD fixture plus 1e8 random keys whose counts
                   are below ``-c 5``; rows equal the fixture-only host
                   rows.

``--cards 4`` runs the multi-card path and nothing else: ``km-tpu
count`` on the phase-1 FASTQ with four cards visible (sharded_count,
an all_to_all between the cards) against the host counter,
ShardedCountTable lookups on the big table against host lookups, and
``__graft_entry__.dryrun_multichip(4)``.

Every phase prints one line with its sizes, wall time and
``peak_bytes_in_use``; the last line of stdout is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from argparse import Namespace
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
K = 31
READ_LEN = 100
FIND_MUTATION_DEFAULTS = dict(count=5, ratio=0.05, steps=500, branchs=10,
                              nodes=10000)
# tests/golden/<name>.find_mutation.tsv -> (catalog target, bundled table)
GOLDENS = {
    "NPM1": ("NPM1_4ins_exons_10-11utr", "02H025_NPM1"),
    "FLT3_ITD": ("FLT3-ITD_exons_13-15", "03H116_ITD"),
    "FLT3_IandI": ("FLT3-ITD_exons_13-15", "03H112_IandI"),
    "FLT3_TKD": ("FLT3-TKD_exon_20", "05H094_FLT3-TKD_del"),
    "DNMT3A": ("DNMT3A_R882_exon_23", "02H033_DNMT3A_sub"),
}
NPM1 = "NPM1_4ins_exons_10-11utr"
NPM1_INSERTION = "45:/TCTG:45"
# the synthetic sample (module docstring)
CATALOG_COV = 300
NPM1_COV = 500
NPM1_VAF = 0.4
ERROR_RATE = 0.001
LOWQUAL_RATE = 0.002  # bases below -Q + (quality '#')
CHILD_TIMEOUT_S = 900

# Runs as ``python -c CHILD <km-tpu arguments>``: exactly ``python -m
# km_tpu <arguments>``, then the peak device memory of every card.
CHILD = r"""
import runpy, sys
try:
    runpy.run_module("km_tpu", run_name="__main__", alter_sys=True)
finally:
    import jax
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", -1)
             for d in jax.devices()]
    sys.stderr.write("CHIP_SMOKE_PEAK_BYTES=%s\n"
                     % ",".join(str(p) for p in peaks))
"""


@dataclasses.dataclass
class Config:
    """Sizes of one run. The defaults are the ones the script runs at;
    smaller ones rehearse the phases on the CPU (``device="cpu"``). The
    ``min_*`` fields hold the sample and the count phase to the sizes
    the defaults promise."""
    seed: int = 0
    cards: int = 1
    device: str = "gpu"
    n_reads: int = 5_100_000            # x 216 B/record = 1.1 GB of FASTQ
    ref_bases: int = 50_331_648         # transcriptome-like reference
    big_extra: int = 100_000_000        # random below-threshold keys
    n_targets: int = 400
    kernel_windows: int = 1 << 24
    min_fastq_bytes: int = 1 << 30
    min_slots: int = 1 << 26
    min_distinct: int = 40_000_000
    trace_out: str | None = None


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# synthetic sample


def catalog_targets():
    from km_tpu.io.fasta import read_target
    from km_tpu.refdata import catalog_dir

    cat = catalog_dir("GRCh38")
    out = []
    for fn in sorted(os.listdir(cat)):
        seqs, _ = read_target(os.path.join(cat, fn))
        out.append((os.path.splitext(fn)[0], "".join(seqs)))
    return out


def write_sample_fastq(path: str, cfg: Config) -> dict:
    """A FASTQ like one RNA-seq sample: see the module docstring. Each
    catalog target sits inside 300 random flanking bases on either side
    (reads are longer than the targets); the NPM1 alternative allele is
    the target with TCTG duplicated after base 44."""
    import numpy as np

    from km_tpu.ops.encode import seq_to_codes

    rng = np.random.default_rng(cfg.seed)
    R = READ_LEN
    lens = []
    while sum(lens) < cfg.ref_bases:
        lens.extend(rng.integers(500, 3500, 1024).tolist())
    lens = np.array(lens, np.int64)
    lens = lens[:np.searchsorted(np.cumsum(lens), cfg.ref_bases) + 1]
    n_bg = len(lens)
    pieces = [rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)]
    seq_lens = list(lens)
    expected = list((1.0 / (rng.permutation(n_bg) + 1)) * (lens - R + 1))
    cat_expected = []
    for name, seq in catalog_targets():
        alleles = [(seq, 1.0)]
        cov = CATALOG_COV
        if name == NPM1:
            alleles = [(seq, 1 - NPM1_VAF),
                       (seq[:44] + "TCTG" + seq[44:], NPM1_VAF)]
            cov = NPM1_COV
        left = rng.integers(0, 4, 300, dtype=np.uint8)
        right = rng.integers(0, 4, 300, dtype=np.uint8)
        for allele, frac in alleles:
            t = np.concatenate([left, seq_to_codes(allele), right])
            pieces.append(t)
            seq_lens.append(len(t))
            cat_expected.append(frac * cov * len(t) / R)
    n_cat = sum(cat_expected)
    bg = np.array(expected)
    bg *= (cfg.n_reads - n_cat) / bg.sum()
    weights = np.concatenate([bg, cat_expected])
    pool = np.concatenate(pieces)
    seq_lens = np.array(seq_lens, np.int64)
    starts = np.concatenate([[0], np.cumsum(seq_lens)[:-1]])
    cum = np.cumsum(weights)

    # fixed-width records: "@r%09d\n" + read + "\n+\n" + quality + "\n"
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seq0 = 12
    qual0 = seq0 + R + 3
    width = qual0 + R + 1
    block = 1 << 18
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        for lo in range(0, cfg.n_reads, block):
            b = min(block, cfg.n_reads - lo)
            t = np.searchsorted(cum, rng.random(b) * cum[-1], side="right")
            off = starts[t] + (rng.random(b) * (seq_lens[t] - R + 1)
                               ).astype(np.int64)
            codes = pool[off[:, None] + np.arange(R)]
            err = rng.random((b, R)) < ERROR_RATE
            codes[err] = (codes[err] + rng.integers(1, 4, int(err.sum()),
                                                    dtype=np.uint8)) & 3
            flip = rng.random(b) < 0.5
            codes[flip] = 3 - codes[flip, ::-1]
            rec = np.empty((b, width), np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            ids = np.arange(lo, lo + b)
            for j in range(9):
                rec[:, 10 - j] = (ids // 10 ** j) % 10 + ord("0")
            rec[:, 11] = ord("\n")
            rec[:, seq0:seq0 + R] = acgt[codes]
            rec[:, seq0 + R] = ord("\n")
            rec[:, seq0 + R + 1] = ord("+")
            rec[:, seq0 + R + 2] = ord("\n")
            rec[:, qual0:qual0 + R] = np.where(
                rng.random((b, R)) < LOWQUAL_RATE, ord("#"), ord("I"))
            rec[:, qual0 + R] = ord("\n")
            f.write(rec.tobytes())
    os.replace(tmp, path)
    return {"fastq_bytes": os.path.getsize(path), "reads": cfg.n_reads,
            "ref_bases": int(lens.sum()), "transcripts": n_bg}


def host_count(fastq: str, min_quality: str):
    """The host counter on the same reads: read batches counted in
    parallel (native counter, or numpy without the native library),
    then one k-way merge. Returns (keys, counts) before any -L filter."""
    import numpy as np

    from km_tpu import native
    from km_tpu.io.fastq import read_batches
    from km_tpu.ops import count as opcount

    def one(batch):
        codes, valid = batch
        if native.available():
            return native.count_host(codes, valid, K, canonical=True)
        return opcount.count_batches_host([batch], K, canonical=True)

    with ThreadPoolExecutor(8) as pool:
        runs = [(k, c.astype(np.int64)) for k, c in pool.map(
            one, read_batches([fastq], batch_bases=1 << 26,
                              min_quality=min_quality))]
    if native.available():
        return native.merge_sorted_runs(runs)
    keys = np.concatenate([r[0] for r in runs])
    counts = np.concatenate([r[1] for r in runs])
    uk, inv = np.unique(keys, return_inverse=True)
    return uk, np.bincount(inv, weights=counts).astype(np.int64)


# ---------------------------------------------------------------------------
# child processes and rows


def run_cli(cfg: Config, args: list[str], env: dict) -> tuple[str, str, list]:
    """``python -m km_tpu <args>`` as a child process (one at a time);
    returns (stdout, stderr, per-card peak_bytes_in_use)."""
    proc = subprocess.run([sys.executable, "-c", CHILD, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise PhaseFailed("km-tpu %s exited %d:\n%s" % (
            " ".join(args), proc.returncode, proc.stderr[-4000:]))
    m = re.search(r"CHIP_SMOKE_PEAK_BYTES=([-\d,]+)", proc.stderr)
    peaks = [int(x) for x in m.group(1).split(",")] if m else []
    return proc.stdout, proc.stderr, peaks


def rows_of(find_mutation_stdout: str) -> list[str]:
    """The variant rows of find_mutation output: no '#' lines, no
    header."""
    return [line for line in find_mutation_stdout.splitlines()
            if line and not line.startswith("#")
            and not line.startswith("Database\t")]


def host_rows(target_dir: str, table_path: str) -> list[str]:
    """The sequential host engine's rows (find_mutation without
    --batch), in process."""
    from km_tpu.tools.find_mutation import main_find_mut

    args = Namespace(**FIND_MUTATION_DEFAULTS, graphical=False,
                     verbose=False, debug=False, target_fn=[target_dir],
                     jellyfish_fn=table_path, batch=False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main_find_mut(args, None)
    return rows_of(out.getvalue())


def compare_rows(got: list[str], want: list[str], what: str):
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            fields = ["Database", "Query", "Type", "Variant_name", "rVAF",
                      "Expression", "Min_coverage", "Start_offset",
                      "Sequence", "Reference_expression",
                      "Reference_sequence", "Info"]
            diff = [f"{n}: {a!r} != {b!r}" for n, a, b in
                    zip(fields, g.split("\t"), w.split("\t")) if a != b]
            raise PhaseFailed("%s: row %d differs (%s)" % (
                what, i, "; ".join(diff)))
    check(len(got) == len(want),
          "%s: %d rows, expected %d" % (what, len(got), len(want)))


def fmt_peaks(peaks) -> str:
    return ",".join(str(p) for p in peaks) if peaks else "not measured"


def device_peaks() -> list[int]:
    import jax

    return [(d.memory_stats() or {}).get("peak_bytes_in_use", -1)
            for d in jax.devices()]


# ---------------------------------------------------------------------------
# phases


def phase_count(cfg: Config, env: dict, fastq: str, tmp: str) -> str:
    """km-tpu count at the upstream recipe's settings, against the host
    counter. Returns the table's path."""
    import numpy as np

    from km_tpu.models.table import CountTable

    npz = os.path.join(tmp, "sample.npz")
    t0 = time.perf_counter()
    _out, err, peaks = run_cli(cfg, ["count", "-k", str(K), "-L", "2",
                                     "-Q", "+", "--device", cfg.device,
                                     "-o", npz, fastq], env)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    hk, hc = host_count(fastq, "+")
    host_s = time.perf_counter() - t0
    keep = hc >= 2
    table = CountTable.load(npz)
    check(np.array_equal(np.asarray(table.keys), hk[keep]),
          "count: keys differ from the host counter's")
    check(np.array_equal(np.asarray(table.counts, np.int64), hc[keep]),
          "count: counts differ from the host counter's")
    mesh = re.search(r"counting on a (\d+)-device mesh", err)
    if cfg.cards > 1:
        check(mesh and int(mesh.group(1)) == cfg.cards,
              "count: not sharded over %d cards:\n%s" % (cfg.cards,
                                                         err[-2000:]))
        layout = "mesh=%s" % mesh.group(1)
    else:
        check(mesh is None, "count: sharded on one card?")
        grown = [int(x) for x in re.findall(r"retrying with (\d+) slots",
                                            err)]
        slots = grown[-1] if grown else 1 << 22
        check(slots >= cfg.min_slots,
              "count: accumulator stayed at %d slots" % slots)
        layout = "accumulator_slots=%d (grown %d times)" % (slots,
                                                            len(grown))
    check(len(hk) >= cfg.min_distinct,
          "count: only %d distinct k-mers" % len(hk))
    fastq_bytes = os.path.getsize(fastq)
    log("phase count: fastq_bytes=%d distinct_kmers=%d kept_kmers_L2=%d "
        "%s wall_s=%.3f host_counter_s=%.3f peak_bytes_in_use=%s"
        % (fastq_bytes, len(hk), int(keep.sum()), layout, wall, host_s,
           fmt_peaks(peaks)))
    log("  cut from a real sample (example/README.rst:29): %.2f GB of "
        "~46 GB of FASTQ; %.3g distinct k-mers of 1e8-1e9"
        % (fastq_bytes / 1e9, len(hk)))
    return npz


def phase_walk_counted(cfg: Config, env: dict, npz: str):
    from km_tpu.refdata import catalog_dir

    cat = catalog_dir("GRCh38")
    t0 = time.perf_counter()
    out, _err, peaks = run_cli(cfg, ["find_mutation", "--batch", cat, npz],
                               env)
    wall = time.perf_counter() - t0
    got = rows_of(out)
    compare_rows(got, host_rows(cat, npz), "walk-counted")
    npm1 = [r.split("\t") for r in got]
    npm1 = [f for f in npm1 if f[1] == NPM1 and f[2] == "Insertion"
            and f[3] == NPM1_INSERTION]
    check(npm1, "walk-counted: the planted NPM1 insertion was not found")
    log("phase walk-counted: targets=%d rows=%d npm1_insertion_rVAF=%s "
        "wall_s=%.3f peak_bytes_in_use=%s"
        % (len(os.listdir(cat)), len(got), npm1[0][4], wall,
           fmt_peaks(peaks)))


def phase_catalog_fixtures(cfg: Config, env: dict):
    from km_tpu.refdata import DATA_DIR, catalog_dir

    cat = catalog_dir("GRCh38")
    golden_dir = os.path.join(REPO, "tests", "golden")
    walls, peaks, n_rows, n_golden = [], [], 0, 0
    for fn in sorted(os.listdir(os.path.join(DATA_DIR, "jf"))):
        jf = os.path.join(DATA_DIR, "jf", fn)
        t0 = time.perf_counter()
        out, _err, pk = run_cli(cfg, ["find_mutation", "--batch", cat, jf],
                                env)
        walls.append(time.perf_counter() - t0)
        peaks.extend(pk)
        got = rows_of(out)
        compare_rows(got, host_rows(cat, jf), "catalog-fixtures " + fn)
        n_rows += len(got)
        for name, (target, table) in GOLDENS.items():
            if table + ".jf" != fn:
                continue
            with open(os.path.join(golden_dir,
                                   name + ".find_mutation.tsv")) as f:
                gold = [r.split("\t")[1:] for r in rows_of(f.read())]
            mine = [r.split("\t")[1:] for r in got
                    if r.split("\t")[1] == target]
            check(mine == gold, "catalog-fixtures: %s rows differ from "
                  "tests/golden/%s.find_mutation.tsv" % (fn, name))
            n_golden += 1
    log("phase catalog-fixtures: tables=%d targets=%d rows=%d "
        "goldens_matched=%d wall_s=%s peak_bytes_in_use=%s"
        % (len(walls), len(os.listdir(cat)), n_rows, n_golden,
           ",".join("%.3f" % w for w in walls), fmt_peaks(peaks)))


def reads_prefix(fastq: str, n: int):
    """The first n bases of the read stream as the counter sees it:
    concatenated reads with their invalid separators."""
    import numpy as np

    from km_tpu.io.fastq import read_batches

    codes, valid, have = [], [], 0
    for c, v in read_batches([fastq], batch_bases=1 << 26,
                             min_quality="+"):
        codes.append(c)
        valid.append(v)
        have += len(c)
        if have >= n:
            break
    check(have >= n, "count-kernel: FASTQ holds fewer than %d bases" % n)
    return np.concatenate(codes)[:n], np.concatenate(valid)[:n]


def scope_of_ops(hlo_text: str, scopes=("pack", "sort", "runs")) -> dict:
    """HLO instruction name -> the named scope (jax.named_scope) its
    operations came from, read from the op_name metadata of the
    instruction and of every computation it calls."""
    comp_tags: dict[str, set] = {}
    comp_calls: dict[str, list] = {}
    instr_tags: dict[str, set] = {}
    instr_calls: dict[str, list] = {}
    comp = None
    for line in hlo_text.splitlines():
        head = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if head and "=" not in line.split("{")[0]:
            comp = head.group(1)
            comp_tags.setdefault(comp, set())
            comp_calls.setdefault(comp, [])
            continue
        m = re.match(r"\s*(?:ROOT\s+)?%([\w.\-]+)\s*=", line)
        if not m or comp is None:
            continue
        tags = {s for s in scopes
                if re.search(r'op_name="[^"]*/%s/' % s, line)}
        calls = re.findall(
            r"(?:calls|to_apply|body|condition)=%([\w.\-]+)", line)
        instr_tags[m.group(1)] = tags
        instr_calls[m.group(1)] = calls
        comp_tags[comp] |= tags
        comp_calls[comp] += calls

    def tags_of_comp(c, seen):
        if c in seen:
            return set()
        seen.add(c)
        out = set(comp_tags.get(c, ()))
        for callee in comp_calls.get(c, ()):
            out |= tags_of_comp(callee, seen)
        return out

    labels = {}
    for name, tags in instr_tags.items():
        tags = set(tags)
        for c in instr_calls[name]:
            tags |= tags_of_comp(c, set())
        labels[name] = "+".join(s for s in scopes if s in tags) or "other"
    return labels


def device_op_times(trace_dir: str, labels: dict, module: str):
    """Sum the device time of one jitted module's kernels per label from
    a jax.profiler trace. Returns ({label: ns}, [(ns, op, label)...])."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    check(paths, "count-kernel: the profiler wrote no trace")
    data = ProfileData.from_file(sorted(paths)[-1])
    per_label: dict[str, float] = {}
    per_op: dict[str, float] = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU") \
                and not plane.name.startswith("/host:CPU"):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if stats.get("hlo_module", "").find(module) < 0:
                    continue
                op = stats.get("hlo_op", ev.name)
                per_op[op] = per_op.get(op, 0.0) + ev.duration_ns
    for op, ns in per_op.items():
        label = labels.get(op, "other")
        per_label[label] = per_label.get(label, 0.0) + ns
    top = sorted(((ns, op, labels.get(op, "other"))
                  for op, ns in per_op.items()), reverse=True)
    return per_label, top


def phase_count_kernel(cfg: Config, fastq: str):
    """One count_chunk_device step at the real counting shape: compile,
    check against the host counter, time warm calls, and split the
    device time into pack, sort and runs from one trace."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from km_tpu import native
    from km_tpu.ops import count as opcount

    n = cfg.kernel_windows + K - 1
    codes, valid = reads_prefix(fastq, n)
    c, v = jnp.asarray(codes), jnp.asarray(valid)
    fn = jax.jit(opcount.count_chunk_device,
                 static_argnames=("k", "canonical"))
    t0 = time.perf_counter()
    compiled = fn.lower(c, v, k=K, canonical=True).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    hi, lo, cnt = jax.block_until_ready(compiled(c, v))
    hi = np.asarray(hi).astype(np.uint64)
    lo = np.asarray(lo).astype(np.uint64)
    cnt = np.asarray(cnt).astype(np.int64)
    keep = cnt > 0
    if native.available():
        hk, hc = native.count_host(codes, valid, K, canonical=True)
    else:
        hk, hc = opcount.count_batches_host([(codes, valid)], K)
    check(np.array_equal((hi[keep] << np.uint64(32)) | lo[keep], hk)
          and np.array_equal(cnt[keep], hc.astype(np.int64)),
          "count-kernel: the step's table differs from the host counter's")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(c, v))
        times.append(time.perf_counter() - t0)
    trace_dir = tempfile.mkdtemp(prefix="km_chip_smoke_trace_")
    try:
        reps = 3
        with jax.profiler.trace(trace_dir):
            for _ in range(reps):
                jax.block_until_ready(compiled(c, v))
        labels = scope_of_ops(compiled.as_text())
        per_label, top = device_op_times(trace_dir, labels,
                                         "count_chunk_device")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    total = sum(per_label.values()) or 1.0
    split = " ".join("%s_ms=%.3f(%.1f%%)" % (lb, ns / reps / 1e6,
                                              100 * ns / total)
                     for lb, ns in sorted(per_label.items()))
    log("phase count-kernel: windows=%d distinct=%d compile_s=%.3f "
        "warm_best_ms=%.3f warm_median_ms=%.3f device_ms_per_step=%.3f "
        "%s temp_bytes=%s peak_bytes_in_use=%s"
        % (cfg.kernel_windows, int(keep.sum()), compile_s,
           min(times) * 1e3, sorted(times)[len(times) // 2] * 1e3,
           total / reps / 1e6, split,
           getattr(mem, "temp_size_in_bytes", "not measured"),
           fmt_peaks(device_peaks())))
    if cfg.trace_out:
        os.makedirs(cfg.trace_out, exist_ok=True)
        with open(os.path.join(cfg.trace_out, "count_kernel_ops.json"),
                  "w") as f:
            json.dump({"reps": reps, "per_label_ns": per_label,
                       "ops": [[ns, op, lb] for ns, op, lb in top]}, f,
                      indent=1)


def build_bigtable(cfg: Config):
    """03H116_ITD plus cfg.big_extra random keys counted 1..4, all below
    the -c 5 child threshold: every row equals the fixture-only run while
    every lookup searches the whole table (scripts/bigtable_walk.py)."""
    import numpy as np

    from km_tpu.models.table import CountTable
    from km_tpu.refdata import jf_path

    fixture = CountTable.from_jf(jf_path("03H116_ITD"))
    rng = np.random.default_rng(cfg.seed + 2)
    extra = np.sort(rng.integers(0, 1 << 62, cfg.big_extra,
                                 dtype=np.uint64))
    extra_counts = rng.integers(1, 5, cfg.big_extra).astype(np.uint32)
    fk = np.asarray(fixture.keys, np.uint64)
    fc = np.asarray(fixture.counts, np.uint32)
    keep = np.concatenate([[True], extra[1:] != extra[:-1]])
    pos = np.minimum(np.searchsorted(extra, fk), len(extra) - 1)
    keep[pos[extra[pos] == fk]] = False  # a fixture key's count wins
    extra, extra_counts = extra[keep], extra_counts[keep]
    pos = np.searchsorted(extra, fk)
    keys = np.insert(extra, pos, fk)
    counts = np.insert(extra_counts, pos, fc)
    big = CountTable.from_arrays(keys, counts, fixture.k, fixture.canonical,
                                 name=fixture.name, presorted=True)
    return fixture, big


def phase_bigtable(cfg: Config):
    import bench
    from km_tpu.models.batch import run_catalog
    from km_tpu.tools import batchmode

    t0 = time.perf_counter()
    fixture, big = build_bigtable(cfg)
    build_s = time.perf_counter() - t0
    want = [str(r) for rows in run_catalog(
        bench._make_catalog_targets(cfg.n_targets, fixture.k), fixture,
        walk="host") for r in rows]
    if cfg.device == "gpu":
        check(batchmode._device_backend(),
              "catalog-bigtable: --batch would not use the GPU")
    args = Namespace(**FIND_MUTATION_DEFAULTS, graphical=False)
    walls = []
    for _ in range(2):  # first call compiles, the second is warm
        targets = bench._make_catalog_targets(cfg.n_targets, fixture.k)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            batchmode.emit_batched(targets, big, args)
        walls.append(time.perf_counter() - t0)
        compare_rows(out.getvalue().splitlines(), want, "catalog-bigtable")
    log("phase catalog-bigtable: table_records=%d device_table_slots=%d "
        "targets=%d rows=%d build_s=%.3f first_s=%.3f warm_s=%.3f "
        "(each incl. the table upload) peak_bytes_in_use=%s"
        % (big.n_kmers, 1 << (big.n_kmers - 1).bit_length(),
           cfg.n_targets, len(want), build_s, walls[0], walls[1],
           fmt_peaks(device_peaks())))


def phase_sharded_lookup(cfg: Config):
    import jax
    import numpy as np

    from km_tpu.parallel.sharded_table import ShardedCountTable, make_mesh

    _fixture, big = build_bigtable(cfg)
    t0 = time.perf_counter()
    table = ShardedCountTable(big, make_mesh())
    shard_devices = {s.device for s in table.keys_hi.addressable_shards}
    check(len(shard_devices) == len(jax.devices()) == cfg.cards,
          "sharded-lookup: shards on %d devices" % len(shard_devices))
    rng = np.random.default_rng(cfg.seed + 3)
    q = np.concatenate([
        np.asarray(big.keys)[rng.integers(0, big.n_kmers, 1 << 21)],
        rng.integers(0, 1 << 62, 1 << 21, dtype=np.uint64)])
    want = big.query_packed(q)
    got = table.query_packed(q)
    first = time.perf_counter() - t0
    check(np.array_equal(got, want),
          "sharded-lookup: routed lookups differ from the host's")
    t0 = time.perf_counter()
    got = table.query_packed(q)
    warm = time.perf_counter() - t0
    check(np.array_equal(got, want), "sharded-lookup: warm lookups differ")
    got_b = table.query_packed(q[:1 << 16], routed=False)
    check(np.array_equal(got_b, want[:1 << 16]),
          "sharded-lookup: broadcast lookups differ from the host's")
    log("phase sharded-lookup: table_records=%d shards=%d per_shard=%d "
        "queries=%d hits=%d first_s=%.3f warm_s=%.3f "
        "peak_bytes_in_use=%s"
        % (big.n_kmers, len(shard_devices), table.per_shard, len(q),
           int((want > 0).sum()), first, warm, fmt_peaks(device_peaks())))


def phase_dryrun(cfg: Config):
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(cfg.cards)
    log("phase dryrun-multichip: mesh=2x%d wall_s=%.3f "
        "peak_bytes_in_use=%s" % (cfg.cards // 2, time.perf_counter() - t0,
                                  fmt_peaks(device_peaks())))


# ---------------------------------------------------------------------------


def run(cfg: Config, env: dict) -> int:
    import jax

    from km_tpu import native

    d = jax.devices()[0]
    log("device: platform=%s device_kind=%s count=%d jax=%s"
        % (d.platform, d.device_kind, len(jax.devices()), jax.__version__))
    if cfg.device == "gpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        for line in smi.stdout.strip().splitlines():
            log("nvidia-smi: " + line.strip())
    log("native host library: %s"
        % ("loaded" if native.available() else "not available"))

    tmp = tempfile.mkdtemp(prefix="km_chip_smoke_")
    try:
        fastq = os.path.join(tmp, "sample.fastq")
        t0 = time.perf_counter()
        info = write_sample_fastq(fastq, cfg)
        check(info["fastq_bytes"] >= cfg.min_fastq_bytes,
              "sample: FASTQ of %d bytes" % info["fastq_bytes"])
        log("sample: seed=%d fastq_bytes=%d reads=%d read_len=%d "
            "ref_bases=%d transcripts=%d gen_s=%.3f"
            % (cfg.seed, info["fastq_bytes"], info["reads"], READ_LEN,
               info["ref_bases"], info["transcripts"],
               time.perf_counter() - t0))
        npz = phase_count(cfg, env, fastq, tmp)
        if cfg.cards == 1:
            phase_walk_counted(cfg, env, npz)
            phase_catalog_fixtures(cfg, env)
            phase_count_kernel(cfg, fastq)
            phase_bigtable(cfg)
        else:
            phase_sharded_lookup(cfg)
            phase_dryrun(cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=[1, 4], default=1,
                    help="4: run only the multi-card path")
    ap.add_argument("--trace-out", default=None, metavar="DIR",
                    help="write the count kernel's per-op device times "
                         "to DIR/count_kernel_ops.json")
    a = ap.parse_args(argv)
    env = dict(os.environ)  # the children's: they run as users do
    # this process: no up-front reservation (the children need the
    # card), and XLA's command buffers off, so that the profiler sees
    # each kernel of the count step instead of one replayed graph
    os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_gpu_enable_command_buffer=").strip()

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.stderr.write("chip_smoke: JAX's default backend is %r, not the "
                         "GPU; nothing was run\n" % backend)
        return 1
    if not os.path.isdir(os.path.join(REPO, "km_tpu")):
        sys.stderr.write("chip_smoke: no km_tpu package beside this "
                         "script; run it from the repository\n")
        return 1
    if len(jax.devices()) < a.cards:
        sys.stderr.write("chip_smoke: --cards %d, but JAX sees %d GPU(s)\n"
                         % (a.cards, len(jax.devices())))
        return 1
    sys.path.insert(0, REPO)
    cfg = Config(seed=a.seed, cards=a.cards, trace_out=a.trace_out)
    try:
        return run(cfg, env)
    except PhaseFailed as e:
        sys.stderr.write("chip_smoke: FAILED: %s\n" % e)
        return 1


if __name__ == "__main__":
    sys.exit(main())
