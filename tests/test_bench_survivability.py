"""The bench driver's survival contract: it must print a parseable
cumulative JSON line and exit 0 even when the budget cuts stages off —
the round-3 failure (one slow stage erased every metric) must be
impossible by construction."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(budget: str):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["KM_TPU_BENCH_BUDGET"] = budget
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=REPO)
    return proc


def _json_lines(stdout: str):
    out = []
    for line in stdout.strip().splitlines():
        try:
            d = json.loads(line)
        except ValueError:
            continue
        if isinstance(d, dict) and d.get("metric"):
            out.append(d)
    return out


def test_tiny_budget_still_prints_json():
    """With a budget too small for most stages, the driver exits 0 and
    the last stdout line is a well-formed bench result that says which
    stages were skipped."""
    proc = _run_bench("30")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = _json_lines(proc.stdout)
    assert lines, "no JSON line on stdout"
    final = lines[-1]
    assert final["metric"] == "kmers_counted_per_sec_per_chip"
    assert "stage_errors" in final["extra"]
    skipped = [v for v in final["extra"]["stage_errors"].values()
               if "budget" in v or "timeout" in v]
    assert skipped, final["extra"]["stage_errors"]


def test_every_emitted_line_is_cumulative():
    """Each progressive line must contain at least the fields of the
    previous one (a driver kill always leaves the best-so-far)."""
    proc = _run_bench("90")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = _json_lines(proc.stdout)
    assert len(lines) >= 2
    seen: set = set()
    for d in lines:
        keys = set(d["extra"]) - {"stage_errors"}
        assert seen <= keys, (seen - keys, d)
        seen = keys
