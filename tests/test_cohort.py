"""The cohort subcommand: samples x targets through the batched
pipeline, per-pair report files equal to the find_mutation|find_report
pipe — and the count CLI's sharded path on the virtual 8-device mesh
(a user-invocable command must exercise km_tpu.parallel)."""

import io
import os
from argparse import Namespace
from contextlib import redirect_stdout

import numpy as np
import pytest

from km_tpu import cli

from helpers import REFDATA

CAT = f"{REFDATA}/catalog/GRCh38"


def _reference_report(target_fa, jf, fmt=None):
    """The two-stage pipe the cohort output must equal."""
    from km_tpu.tools.find_mutation import main_find_mut
    from km_tpu.tools.find_report import main_find_report

    args = Namespace(count=5, graphical=False, jellyfish_fn=jf,
                     ratio=0.05, steps=500, branchs=10, nodes=10000,
                     target_fn=[target_fa], verbose=False, debug=False)
    out = io.StringIO()
    with redirect_stdout(out):
        main_find_mut(args, None)
    rargs = Namespace(target=target_fa, infile=io.StringIO(out.getvalue()),
                      info="vs_ref", min_cov=1, exclu="", format=fmt)
    rep = io.StringIO()
    with redirect_stdout(rep):
        main_find_report(rargs, None)
    return rep.getvalue()


def test_cohort_cli_reports_match_pipe(tmp_path):
    outdir = str(tmp_path / "cohort_out")
    samples = [f"{REFDATA}/jf/02H025_NPM1.jf",
               f"{REFDATA}/jf/03H116_ITD.jf"]
    cli.main(["cohort", "-t", CAT, "-o", outdir] + samples)

    fas = sorted(os.listdir(CAT))
    for jf in samples:
        sample = os.path.splitext(os.path.basename(jf))[0]
        sdir = os.path.join(outdir, sample)
        assert os.path.isdir(sdir)
        produced = sorted(os.listdir(sdir))
        assert produced == sorted(os.path.splitext(fa)[0] + ".tsv"
                                  for fa in fas)
    # spot-check two (sample, target) pairs byte-for-byte vs the pipe
    for jf, fa in [(samples[0], "NPM1_4ins_exons_10-11utr.fa"),
                   (samples[1], "FLT3-ITD_exons_13-15.fa")]:
        sample = os.path.splitext(os.path.basename(jf))[0]
        name = os.path.splitext(fa)[0]
        got = open(os.path.join(outdir, sample, name + ".tsv")).read()
        want = _reference_report(os.path.join(CAT, fa), jf)
        assert got == want, (sample, name)


def test_cohort_counts_raw_reads_sharded(tmp_path):
    """A raw-read sample is counted via the all_to_all sharded path on
    the virtual mesh (KM_TPU_COHORT_SHARDED forces it on the CPU
    backend) and the resulting reports match a host-counted table."""
    import gzip

    from km_tpu.models.table import CountTable
    from km_tpu.ops import count as opcount
    from km_tpu.io.fastq import read_batches

    # synthesize reads covering the NPM1 target so the walk is nontrivial
    rng = np.random.default_rng(0)
    from km_tpu.io.fasta import read_target

    seqs, _ = read_target(f"{CAT}/NPM1_4ins_exons_10-11utr.fa")
    ref = "".join(seqs)
    reads = []
    for i in range(400):
        off = int(rng.integers(0, max(len(ref) - 60, 1)))
        reads.append(ref[off:off + 60])
    fq = tmp_path / "sample_reads.fastq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write("@r%d\n%s\n+\n%s\n" % (i, r, "I" * len(r)))

    outdir = str(tmp_path / "out")
    os.environ["KM_TPU_COHORT_SHARDED"] = "1"
    try:
        cli.main(["cohort", "-t", f"{CAT}/NPM1_4ins_exons_10-11utr.fa",
                  "-o", outdir, "-L", "1", str(fq)])
    finally:
        del os.environ["KM_TPU_COHORT_SHARDED"]
    produced = os.path.join(outdir, "sample_reads",
                            "NPM1_4ins_exons_10-11utr.tsv")
    assert os.path.isfile(produced)
    body = open(produced).read()
    assert "Reference" in body  # clean-coverage sample: reference row

    # equality of the sharded count table vs the host counter
    host_keys, host_counts = opcount.count_batches_host(
        read_batches([str(fq)], min_quality=None), 31, canonical=True,
        min_count=1)
    from km_tpu.parallel.sharded_table import make_mesh, sharded_count

    keys, counts = sharded_count(
        read_batches([str(fq)], min_quality=None), make_mesh(), 31,
        canonical=True, min_count=1)
    assert np.array_equal(keys, host_keys)
    assert np.array_equal(np.asarray(counts, np.int64),
                          np.asarray(host_counts, np.int64))


def test_count_cli_sharded_multidevice(tmp_path):
    """`km-tpu count --device cpu` on the 8-device virtual mesh takes
    the sharded_count path and produces the same table as host
    counting."""
    import numpy as np

    from km_tpu.models.table import CountTable
    from km_tpu.io.fastq import read_batches
    from km_tpu.ops import count as opcount

    rng = np.random.default_rng(1)
    bases = "ACGT"
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as f:
        for i in range(2000):
            seq = "".join(bases[b] for b in rng.integers(0, 4, 80))
            f.write("@r%d\n%s\n+\n%s\n" % (i, seq, "I" * 80))

    out = tmp_path / "table.npz"
    cli.main(["count", "-k", "31", "-L", "1", "--device", "cpu",
              "-o", str(out), str(fq)])
    table = CountTable.load(str(out))
    host_keys, host_counts = opcount.count_batches_host(
        read_batches([str(fq)], min_quality=None), 31, canonical=True,
        min_count=1)
    assert np.array_equal(np.asarray(table.keys), host_keys)
    assert np.array_equal(np.asarray(table.counts, np.int64),
                          np.asarray(host_counts, np.int64))


def test_local_read_shards_partitions_by_host(monkeypatch):
    """Host i of P takes samples i, i+P, ... — the multi-host analog of
    the reference's per-sample fan-out (example/run_leucegene.sh)."""
    import jax

    from km_tpu.parallel import distributed

    samples = ["s%d" % i for i in range(7)]
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    assert distributed.local_read_shards(samples) == ["s1", "s4"]
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    assert distributed.local_read_shards(samples) == ["s0", "s3", "s6"]
    # every sample lands on exactly one host
    got = []
    for p in range(3):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        got += distributed.local_read_shards(samples)
    assert sorted(got) == samples


def test_cohort_vcf_format(tmp_path):
    """-f vcf flows through to every per-pair report file."""
    outdir = str(tmp_path / "out")
    cli.main(["cohort", "-t", f"{CAT}/NPM1_4ins_exons_10-11utr.fa",
              "-o", outdir, "-f", "vcf",
              f"{REFDATA}/jf/02H025_NPM1.jf"])
    got = open(os.path.join(outdir, "02H025_NPM1",
                            "NPM1_4ins_exons_10-11utr.tsv")).read()
    want = _reference_report(f"{CAT}/NPM1_4ins_exons_10-11utr.fa",
                             f"{REFDATA}/jf/02H025_NPM1.jf", fmt="vcf")
    assert got == want
    assert got.startswith("##fileformat=VCFv4.1")
