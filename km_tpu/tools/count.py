"""count: build a k-mer count table from FASTQ/FASTA reads.

Replaces the external ``jellyfish count`` step of km's pipeline
(reference: example/run_leucegene.sh:22). Counting runs on the GPU via
sort + segment reduction (km_tpu.ops.count) or on the host (numpy) for
small inputs and machines without a GPU. The device choice and the
strategy selection live in :func:`count_read_files`, shared with the
cohort tool.
"""

from __future__ import annotations

import os
import sys
import time

from ..io.fastq import read_batches
from ..models.table import CountTable
from ..ops import count as opcount

# Below this much input, numpy counts faster than a device run, which
# pays process start-up on the device and the first compile.
SMALL_INPUT_BYTES = 8 << 20


def pick_device(device: str, input_bytes: int) -> str:
    """Resolve a ``--device`` choice to 'gpu', 'cpu' or 'host'.

    'gpu' requires JAX's default backend to be the GPU and raises
    otherwise; 'cpu' runs the same JAX path on JAX's CPU backend (the
    tests use it); 'host' is the pure numpy counter; 'auto' is 'host'
    for inputs under SMALL_INPUT_BYTES, else 'gpu' when JAX has one,
    else 'host'."""
    if device == "auto":
        if input_bytes < SMALL_INPUT_BYTES:
            return "host"
        import jax

        return "gpu" if jax.default_backend() == "gpu" else "host"
    if device == "gpu":
        import jax

        if jax.default_backend() != "gpu":
            raise RuntimeError(
                "--device gpu: JAX found no GPU (default backend is %r)"
                % jax.default_backend())
    elif device not in ("cpu", "host"):
        raise ValueError("unknown device %r" % device)
    return device


def count_read_files(paths, k: int, canonical: bool = True,
                     min_count: int = 2, min_quality=None,
                     device: str = "auto", mode: str = "auto"):
    """Count k-mers of read files; returns host (keys, counts).

    device: see :func:`pick_device`. mode picks the device strategy:
    'stream' (one device-resident accumulator, one readback; the
    default) or 'chunked' (per-chunk compacted readbacks + native host
    k-way merge — no device-side capacity to size, useful when host RAM
    is the roomier resource). 'auto' = 'stream'. With several devices
    of the chosen platform in a single process, counting is sharded
    over all of them instead.
    """
    total = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    device = pick_device(device, total)
    batches = read_batches(paths, min_quality=min_quality)
    if device == "host":
        return opcount.count_batches_host(
            batches, k, canonical=canonical, min_count=min_count)

    import jax

    devices = jax.devices(device)
    if len(devices) > 1 and jax.process_count() == 1:
        # single-process multi-device mesh: every device counts a read
        # shard and the (key, count) runs are routed to their owner
        # with one all_to_all per step (parallel.sharded_table).
        # Guarded to one process: in multi-process cohort mode each
        # process counts DIFFERENT samples with different chunk counts,
        # so collectives over the global mesh would run mismatched
        # programs across processes (hang/corruption); there, each
        # sample counts on this process's default device instead.
        from ..parallel.sharded_table import make_mesh, sharded_count

        # per-device chunk sized to the input (FASTQ carries ~2 bytes
        # per base), between 2^16 and 2^22 bases
        chunk = 1 << max(16, min(22, (total // (2 * len(devices))
                                      ).bit_length()))
        sys.stderr.write("counting on a %d-device mesh\n" % len(devices))
        return sharded_count(batches, make_mesh(devices=devices), k,
                             canonical=canonical, min_count=min_count,
                             chunk=chunk)

    with jax.default_device(devices[0]):
        if mode == "chunked":
            return opcount.count_batches_device_compact(
                batches, k, canonical=canonical, min_count=min_count)

        # streaming accumulator: counts live on device, one readback at
        # the end; on capacity overflow re-read the files with a larger
        # table (counting is stateless, so a retry is exact)
        capacity = 1 << 22
        while True:
            try:
                return opcount.count_batches_device_stream(
                    batches, k, canonical=canonical, min_count=min_count,
                    capacity=capacity)
            except opcount.CountCapacityOverflow:
                capacity *= 4
                sys.stderr.write(
                    "count table capacity exceeded; retrying with "
                    "%d slots\n" % capacity)
                batches = read_batches(paths, min_quality=min_quality)


def main_count(args, argparser):
    t0 = time.time()
    keys, counts = count_read_files(
        args.reads_fn, args.k, canonical=args.canonical,
        min_count=args.min_count, min_quality=args.min_quality,
        device=args.device, mode=args.mode)
    table = CountTable.from_arrays(keys, counts, args.k, args.canonical,
                                   name=args.output, presorted=True)
    table.save(args.output)
    dt = time.time() - t0
    sys.stderr.write(
        "counted %d distinct k-mers (k=%d) in %.2fs -> %s\n"
        % (table.n_kmers, args.k, dt, args.output))
