"""The persistent XLA cache must hit ACROSS PROCESSES and ACROSS entry
points for the device-pipeline kernels (jaxcache stabilizes the cache
key by canonicalizing source locations; a regression here silently
multiplies cold-start time by the number of entry points)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVER = r"""
import logging, sys
logging.basicConfig(level=logging.WARNING)
lg = logging.getLogger("jax._src.compiler")
lg.setLevel(logging.DEBUG)
h = logging.StreamHandler(sys.stderr)
lg.addHandler(h)
sys.path.insert(0, %(repo)r)
from km_tpu.utils.jaxcache import enable
enable()
import numpy as np
from km_tpu.io.fasta import read_target
from km_tpu.models.batch import run_catalog
from km_tpu.models.sequence import TargetSeq
from km_tpu.models.table import CountTable
from km_tpu.ops.device_table import DeviceCountTable
from km_tpu.refdata import catalog_fa, jf_path

host = CountTable.from_jf(
    jf_path("02H025_NPM1"))
seqs, _ = read_target(
    catalog_fa("NPM1_4ins_exons_10-11utr"))
targets = [TargetSeq("".join(seqs), "NPM1_%%d" %% i, host.k)
           for i in range(3)]
dev = DeviceCountTable.from_host(host)
rows = run_catalog(targets, dev, walk="device")
assert len(rows) == 3
print("ROWS_OK")
"""


def _run(cache_dir, extra_src=""):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    # CPU compiles are fast; cache even sub-second programs so the test
    # can assert on every pipeline kernel
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    src = (DRIVER % {"repo": REPO}) + extra_src
    proc = subprocess.run([sys.executable, "-c", src],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ROWS_OK" in proc.stdout
    return proc.stderr


def test_second_process_hits_cache_for_walk_kernels(tmp_path):
    cache = str(tmp_path / "xla_cache")
    log1 = _run(cache)
    assert os.listdir(cache), "first process wrote nothing to the cache"
    # the first process may hit nothing (fresh dir)
    log2 = _run(cache)
    # the blob wrapper is the compiled entry; filter + walk fuse inside
    for kernel in ("jit_walk_kernel_blob",):
        assert ("Persistent compilation cache hit for '%s'" % kernel
                in log2), (
            "second process recompiled %s — cache key unstable across "
            "processes" % kernel)


def test_cache_key_stable_across_entry_points(tmp_path):
    """A different entry file (python -c source differs in padding /
    line numbers) must still hit: the key canonicalizes source
    locations."""
    cache = str(tmp_path / "xla_cache")
    _run(cache)
    # shift every source line number in the second process
    shifted = "\n" * 37
    log2 = _run(cache, extra_src="\n# trailing comment %s" % id(object()))
    proc_src_prefix_changed = shifted + (DRIVER % {"repo": REPO})
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = cache
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    proc = subprocess.run([sys.executable, "-c", proc_src_prefix_changed],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Persistent compilation cache hit for 'jit_walk_kernel_blob'" \
        in proc.stderr
