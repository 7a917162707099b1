"""Multi-process bring-up: jax.distributed initialization and mesh
construction over every device of every process.

The reference composes work with Unix pipes and shell loops over
samples (reference: example/run_leucegene.sh:29-35); there is no
distributed runtime to mirror. Here a cohort run can span processes:
each process calls :func:`initialize` once at startup, then builds a
global mesh with :func:`global_mesh`. Read chunks are fed per process
(each process only touches its own FASTQ shards); the count-table shard
axis spans all devices so the table can exceed one device's memory.
"""

from __future__ import annotations

import logging as log
import os

import numpy as np

import jax
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-process run.

    The coordinator comes from the arguments or from
    ``JAX_COORDINATOR_ADDRESS`` / ``COORDINATOR_ADDRESS``; with neither
    (a single-process run) this is a no-op. Once a coordinator is
    configured, any failure to join it raises: a process must not count
    its samples alone while its peers wait for it.
    """
    explicit = (coordinator_address is not None or num_processes is not None
                or "JAX_COORDINATOR_ADDRESS" in os.environ
                or "COORDINATOR_ADDRESS" in os.environ)
    if jax.distributed.is_initialized():
        log.info("jax.distributed already initialized; skipping")
        return
    if not explicit:
        log.info("no coordinator configured: skipping "
                 "jax.distributed.initialize")
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    log.info("jax.distributed initialized: process %d of %d",
             jax.process_index(), jax.process_count())


def global_mesh(shard_axis: str = "shard", reads_axis: str | None = None,
                reads: int = 1) -> Mesh:
    """A mesh over every device of every process.

    With ``reads_axis`` set, returns a 2-D (reads, shard) mesh — reads
    data-parallel over ``reads`` groups, the table sharded across the
    rest — matching km_tpu.parallel.pipeline_step's axes. Device order
    follows jax.devices(), so the shard axis stays contiguous within a
    process.
    """
    devices = np.array(jax.devices())
    if reads_axis is None:
        return Mesh(devices, (shard_axis,))
    assert devices.size % reads == 0, (
        f"{devices.size} devices do not split into {reads} read groups")
    return Mesh(devices.reshape(reads, devices.size // reads),
                (reads_axis, shard_axis))


def local_read_shards(paths: list[str]) -> list[str]:
    """Partition input read files across processes: process i takes
    files i, i+P, i+2P, ... — the multi-process analog of the
    reference's per-sample shell fan-out."""
    p = jax.process_index()
    n = jax.process_count()
    return list(paths)[p::n]
