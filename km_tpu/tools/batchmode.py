"""Batched catalog mode for find_mutation (`--batch`).

The full pipeline — frontier walk, path enumeration, quantification,
classification — runs through models.batch.run_catalog: when JAX's
backend is the GPU the count table is promoted to a DeviceCountTable
and every stage executes as batched device dispatches (single-dispatch
while_loop walk, lockstep Dijkstra sweeps, one batched NNLS solve);
otherwise the host-orchestrated batch path runs. Either way the rows
are byte-identical to sequential mode (asserted in
tests/test_batch_pipeline.py). A device error propagates: there is no
silent fallback to the host. Replaces the reference's
one-process-per-target shell loop (reference:
example/run_leucegene.sh:29-35).
"""

from __future__ import annotations

import sys

from ..models.batch import run_catalog
from ..utils import profiling


def _device_backend() -> bool:
    """True when JAX's default backend is the GPU."""
    import jax

    return jax.default_backend() == "gpu"


def prepare_table(table):
    """Promote a host table to the device when JAX's backend is the GPU;
    returns the table to run the batched pipeline with."""
    if _device_backend():
        from ..ops.device_table import DeviceCountTable

        with profiling.phase("table_to_device"):
            table = DeviceCountTable.from_host(table)
    return table


def emit_batched(targets, table, args) -> None:
    table = prepare_table(table)
    with profiling.phase("batch_pipeline"):
        # on_budget='skip': one runaway target loses only its own rows
        # (with km's error line on stderr), matching the blast radius
        # of the reference's one-process-per-target loop
        row_lists = run_catalog(
            targets, table, ratio=args.ratio, count=args.count,
            max_stack=args.steps, max_break=args.branchs,
            max_node=args.nodes, graphical=args.graphical,
            on_budget="skip")
    for rows in row_lists:
        for row in rows:
            sys.stdout.write(str(row) + "\n")
