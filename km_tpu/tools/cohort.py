"""cohort: the whole reference pipeline for many samples, as one
user-invocable command spanning a device mesh (and, with
jax.distributed, several processes).

The reference runs a cohort as nested shell loops — one
`km find_mutation | km find_report` process per (sample, target) pair
(reference: example/run_leucegene.sh:29-35, example/README.rst:15-21).
Here one invocation covers samples x targets:

- **processes** split the sample list (process i takes samples i,
  i+P, ... — parallel.distributed.local_read_shards), the
  multi-process analog of the reference's per-sample fan-out;
- **samples given as reads** (FASTQ/FASTA) are counted on the local
  mesh: every local device counts a read shard and the (key, count)
  runs are exchanged to their owner shard by `all_to_all`
  (parallel.sharded_table.sharded_count) when more than one device is
  attached, single-device counting otherwise
  (tools.count.count_read_files);
- **targets** run as ONE batched pipeline per sample (models.batch):
  frontier walk, path sweeps and NNLS for the whole catalog together,
  promoted to the GPU when JAX has one (tools.batchmode);
- **reports**: each target's rows run through the find_report
  transform, one output file per (sample, target), named like the
  reference recipe's `<outdir>/<sample>/<target>.tsv`.
"""

from __future__ import annotations

import io
import os
import sys
import time
from argparse import Namespace
from contextlib import redirect_stdout

from ..io.fasta import expand_target_files, read_target
from ..models.batch import run_catalog
from ..models.quant import PathRow
from ..models.sequence import TargetSeq
from ..parallel import distributed
from .find_mutation import load_table


def _table_for_sample(sample: str, args):
    """A count table for one sample argument: a prebuilt .jf/.npz table
    is loaded; anything else is counted as reads on the local mesh."""
    if sample.endswith((".jf", ".npz")):
        t = load_table(sample)
        t.name = sample
        return t

    from ..models.table import CountTable
    from .count import count_read_files

    # KM_TPU_COHORT_SHARDED=1 forces the JAX mesh path on the CPU
    # backend even for tiny inputs (used by the virtual-mesh tests)
    device = ("cpu" if os.environ.get("KM_TPU_COHORT_SHARDED") == "1"
              else "auto")
    keys, counts = count_read_files(
        [sample], args.k, canonical=True, min_count=args.lower_count,
        min_quality=args.min_quality, device=device)
    table = CountTable.from_arrays(keys, counts, args.k, True,
                                   name=sample, presorted=True)
    return table


def _report_rows(rows, target_path, args, out_path):
    """One target's find_mutation rows -> a find_report file (the
    reference pipe `find_mutation | find_report -t target`)."""
    from .find_report import create_report

    text = PathRow.HEADER + "\n" + "".join(str(r) + "\n" for r in rows)
    rargs = Namespace(target=target_path, infile=io.StringIO(text),
                      info=args.info, min_cov=args.min_cov,
                      exclu=args.exclu, format=args.format)
    with open(out_path, "w") as f, redirect_stdout(f):
        create_report(rargs)


def main_cohort(args, argparser):
    t0 = time.time()
    distributed.initialize()  # no-op single-host

    seq_files = expand_target_files([args.targets])
    targets, paths = [], []
    for seq_f in seq_files:
        name, _ = os.path.splitext(os.path.basename(seq_f))
        seqs, _attrs = read_target(seq_f)
        paths.append((name, seq_f))
        targets.append(("".join(seqs), name))

    my_samples = distributed.local_read_shards(args.samples)
    if not my_samples:
        sys.stderr.write("cohort: no samples for this host\n")
        return

    from .batchmode import prepare_table

    for sample in my_samples:
        table = _table_for_sample(sample, args)
        sample_name = os.path.splitext(os.path.basename(sample))[0]
        outdir = os.path.join(args.outdir, sample_name)
        os.makedirs(outdir, exist_ok=True)

        tgt_objs = [TargetSeq(seq, name, table.k) for seq, name in targets]
        run_table = prepare_table(table)
        row_lists = run_catalog(
            tgt_objs, run_table, ratio=args.ratio, count=args.count,
            max_stack=args.steps, max_break=args.branchs,
            max_node=args.nodes, on_budget="skip")
        for (name, seq_f), rows in zip(paths, row_lists):
            out_path = os.path.join(outdir, name + ".tsv")
            _report_rows(rows, seq_f, args, out_path)
        sys.stderr.write("cohort: %s -> %d targets in %s\n"
                         % (sample_name, len(paths), outdir))
    sys.stderr.write("cohort: done in %.1fs (%d sample(s) on host %d/%d)\n"
                     % (time.time() - t0, len(my_samples),
                        _process_index(), _process_count()))


def _process_index() -> int:
    try:
        import jax

        return jax.process_index()
    except Exception:
        return 0


def _process_count() -> int:
    try:
        import jax

        return jax.process_count()
    except Exception:
        return 1
