"""Card-only checks (marker ``gpu``): the counting and catalog paths on
the GPU against the host spec. They skip wherever JAX's default backend
is not the GPU; on the card run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import io
from argparse import Namespace
from contextlib import redirect_stdout

import numpy as np
import pytest

from km_tpu.ops import count as opcount

from helpers import REFDATA

pytestmark = pytest.mark.gpu


def test_count_chunk_on_gpu_matches_host():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    n = (1 << 20) + 30
    ref = rng.integers(0, 4, 1 << 16, dtype=np.uint8)
    codes = np.resize(ref, n)
    valid = rng.random(n) > 0.01
    fn = jax.jit(opcount.count_chunk_device,
                 static_argnames=("k", "canonical"))
    hi, lo, cnt = fn(jnp.asarray(codes), jnp.asarray(valid), k=31,
                     canonical=True)
    assert jax.devices()[0].platform == "gpu"
    cnt = np.asarray(cnt).astype(np.int64)
    keep = cnt > 0
    keys = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64))[keep]
    hk, hc = opcount.count_batches_host([(codes, valid)], 31)
    assert np.array_equal(keys, hk)
    assert np.array_equal(cnt[keep], hc.astype(np.int64))


def test_stream_count_on_gpu_matches_host():
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 4, 1 << 18, dtype=np.uint8)
    batches = [(ref[o:o + 100], np.ones(100, bool))
               for o in rng.integers(0, len(ref) - 100, 50_000)]
    sk, sc = opcount.count_batches_device_stream(iter(batches), 31,
                                                 min_count=2,
                                                 capacity=1 << 20)
    hk, hc = opcount.count_batches_host(iter(batches), 31, min_count=2)
    assert np.array_equal(sk, hk) and np.array_equal(sc, hc)


def test_batch_rows_on_gpu_match_host():
    from km_tpu.io.fasta import read_target
    from km_tpu.models.batch import run_catalog
    from km_tpu.models.sequence import TargetSeq
    from km_tpu.models.table import CountTable
    from km_tpu.tools import batchmode

    table = CountTable.from_jf(f"{REFDATA}/jf/03H116_ITD.jf")
    seqs, _ = read_target(
        f"{REFDATA}/catalog/GRCh38/FLT3-ITD_exons_13-15.fa")
    targets = [TargetSeq("".join(seqs), "FLT3", table.k)]
    want = [str(r) for rows in run_catalog(targets, table, walk="host")
            for r in rows]
    assert batchmode._device_backend()
    out = io.StringIO()
    with redirect_stdout(out):
        batchmode.emit_batched(
            [TargetSeq("".join(seqs), "FLT3", table.k)], table,
            Namespace(ratio=0.05, count=5, steps=500, branchs=10,
                      nodes=10000, graphical=False))
    assert out.getvalue().splitlines() == want
