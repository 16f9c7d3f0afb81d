"""On the card: one short run of each cell from the checkout, correct and
with its metrics. ``python -m pytest -m cuda portbench/tests``."""

import json
import subprocess
import sys

import pytest

from tests_paths import BENCH

CELLS = [w["name"] for w in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(card, workload):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "3141592653", "--seconds", "3", "--trace", "0"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"]
