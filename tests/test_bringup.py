"""What the GPU bring-up settled: the `--device` choices, the compile
cache's location, multi-process initialization that fails loudly,
chip_smoke.py refusing to run without a GPU, and a source guard against
TPU-only kernels and platform branches."""

import os
import re
import subprocess
import sys

import pytest

import jax

from km_tpu.parallel import distributed
from km_tpu.tools import count as count_tool
from km_tpu.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra=None, timeout=300):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


# --- --device choices ------------------------------------------------------


def test_device_gpu_raises_without_gpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        count_tool.pick_device("gpu", 1 << 30)


def test_count_cli_device_gpu_exits_nonzero(tmp_path):
    fq = tmp_path / "r.fq"
    fq.write_text("@r1\nACGTACGTACGTACGTACGTACGTACGTACGTAC\n+\n"
                  + "I" * 34 + "\n")
    proc = _run(["-m", "km_tpu", "count", "--device", "gpu",
                 "-o", str(tmp_path / "t.npz"), str(fq)])
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert not (tmp_path / "t.npz").exists()


@pytest.mark.parametrize("size", [1 << 10, 1 << 30])
def test_device_auto_picks_host_without_gpu(size):
    """auto = host for small inputs, and host for any input when JAX
    has no GPU."""
    assert count_tool.pick_device("auto", size) == "host"


def test_device_cpu_and_host_pass_through():
    assert count_tool.pick_device("cpu", 1 << 30) == "cpu"
    assert count_tool.pick_device("host", 1 << 30) == "host"


# --- compile cache ---------------------------------------------------------


def test_jaxcache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    jaxcache.enable()
    assert jax.config.jax_compilation_cache_dir == jaxcache.REPO_CACHE_DIR
    assert jaxcache.cache_dir() == jaxcache.REPO_CACHE_DIR


def test_jaxcache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, enable() sets no other
    directory and compiled programs land there."""
    src = ("from km_tpu.utils import jaxcache; jaxcache.enable()\n"
           "import jax, jax.numpy as jnp\n"
           "jax.jit(lambda x: x * 3 + 1)(jnp.arange(8)).block_until_ready()\n"
           "print(jax.config.jax_compilation_cache_dir)\n"
           "print(jaxcache.cache_dir())\n")
    cache = str(tmp_path / "cache")
    proc = _run(["-c", src], {"JAX_COMPILATION_CACHE_DIR": cache,
                              "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS":
                                  "0"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [cache, cache]
    assert os.listdir(cache)


# --- multi-process initialization ----------------------------------------


def test_distributed_coordinator_failure_raises(monkeypatch):
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)

    def refuse(**_kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", refuse)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        distributed.initialize(coordinator_address="localhost:1",
                               num_processes=2, process_id=0)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        distributed.initialize()


def test_distributed_needs_an_explicit_coordinator(monkeypatch):
    """Without a coordinator nothing initializes; with one, exactly the
    given arguments reach jax.distributed."""
    calls = []
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    distributed.initialize()
    assert calls == []
    distributed.initialize(coordinator_address="localhost:9",
                           num_processes=2, process_id=1)
    assert calls == [dict(coordinator_address="localhost:9",
                          num_processes=2, process_id=1)]


# --- chip_smoke.py ---------------------------------------------------------


def test_chip_smoke_fails_without_gpu():
    proc = _run(["chip_smoke.py"], timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "gpu" in proc.stderr.lower()


# --- source guard ----------------------------------------------------------


def _sources():
    roots = [os.path.join(REPO, "km_tpu"), os.path.join(REPO, "scripts")]
    for root in roots:
        for dirpath, _dirs, files in os.walk(root):
            for fn in files:
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)
    for fn in ("bench.py", "chip_smoke.py", "__graft_entry__.py"):
        yield os.path.join(REPO, fn)


def test_no_tpu_kernels_or_platform_branches():
    bad = []
    pat = re.compile(r"pallas\.tpu|pltpu|mosaic_tpu|libtpu"
                     r"|[\"']tpu[\"']", re.IGNORECASE)
    for path in _sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pat.search(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: "
                               f"{line.strip()}")
    assert not bad, "TPU-only code:\n" + "\n".join(bad)
