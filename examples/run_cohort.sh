#!/usr/bin/env bash
# End-to-end cohort recipe — the km-tpu equivalent of the reference's
# example/run_leucegene.sh (fastq-dump -> jellyfish count -> per-target
# km find_mutation | km find_report loop), with counting on the GPU and
# all targets walked in one batched invocation per sample.
#
# Usage: run_cohort.sh <catalog_dir> <out_dir> <sample1.fastq[.gz]> [...]
#
# The one-command equivalent (counts raw-read samples on the local
# device mesh — all_to_all-sharded when more than one card is attached
# — and, under jax.distributed, splits the sample list across the
# processes):
#
#   km-tpu cohort -t "$CATALOG" -o "$OUT" sample1.fastq sample2.jf ...
#
# The step-by-step pipeline below shows the same flow through the
# individual subcommands.
set -euo pipefail

CATALOG=${1:?catalog dir (e.g. data/catalog/GRCh38)}
OUT=${2:?output dir}
shift 2

mkdir -p "$OUT"

for fq in "$@"; do
  sample=$(basename "${fq%%.*}")
  table="$OUT/$sample.jf"

  # 1. count k-mers on-device (replaces: jellyfish count -m 31 -C -L 2
  #    -Q+ -t 8; emits Jellyfish's own binary/sorted .jf layout)
  km-tpu count -k 31 -L 2 -Q '+' -o "$table" "$fq"

  # 2. one batched walk over the whole catalog: every target advances
  #    through the device pipeline together (replaces the per-target
  #    shell loop of separate `km find_mutation` processes; rows are
  #    byte-identical to sequential mode)
  km-tpu find_mutation --batch "$CATALOG" "$table" > "$OUT/$sample.all.tsv"

  # 3. per-target genome-coordinate reports from the batched rows
  #    (column 2 = Query = target name)
  for fa in "$CATALOG"/*.fa; do
    name=$(basename "${fa%.fa}")
    awk -F'\t' -v t="$name" '$2 == t' "$OUT/$sample.all.tsv" \
      | km-tpu find_report -t "$fa" \
      > "$OUT/${sample}_${name}.xls"
  done
done
