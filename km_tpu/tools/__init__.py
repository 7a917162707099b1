"""Workload entry points: find_mutation, find_report, min_cov,
linear_kmin, count (the device FASTQ counter, new in km_tpu)."""
