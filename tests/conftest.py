"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
paths are exercised without a GPU.

JAX_PLATFORMS defaults to cpu here; tests marked ``gpu`` run only where
JAX's default backend is the GPU (``JAX_PLATFORMS=cuda,cpu python -m
pytest -m gpu tests/`` on a machine with the card) and skip elsewhere.
The check happens inside a fixture, at test time, never at import or
collection, so every pytest-xdist worker collects the same tests."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from km_tpu.utils import jaxcache  # noqa: E402

jaxcache.enable()  # CPU test compiles persist across pytest runs too

from km_tpu.refdata import DATA_DIR as REFDATA  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a ``gpu``-marked test unless JAX's default backend is the
    GPU."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; JAX's default backend is %s"
                    % jax.default_backend())


def pytest_collection_modifyitems(config, items):
    """Skip fixture-dependent tests when the reference data tree is absent
    (e.g. a hosted CI runner) instead of erroring on FileNotFoundError."""
    if os.path.isdir(REFDATA):
        return
    skip = pytest.mark.skip(reason=f"reference fixtures not found at "
                            f"{REFDATA} (set KM_TPU_REFDATA)")
    needs_refdata: dict[str, bool] = {}
    for item in items:
        path = str(getattr(item, "fspath", ""))
        if path not in needs_refdata:
            try:
                src = open(path).read() if path.endswith(".py") else ""
            except OSError:
                src = ""
            needs_refdata[path] = "REFDATA" in src
        if needs_refdata[path]:
            item.add_marker(skip)
