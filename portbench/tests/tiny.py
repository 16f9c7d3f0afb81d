"""A relocated copy of the benchmark with its cells cut to CPU size, for
the benchmark's own tests: the same files, the configurations' image
sizes, counts and batches made small (widths unchanged)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent


def make(dst: Path, precision: str = "f32") -> Path:
    shutil.copytree(BENCH, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        f = dst / c["file"]
        cfg = json.loads(f.read_text())
        if cfg["network"] == "deeplab":
            # CamVid's train crops are 360x480 whatever the image size
            cfg.update(image_hw=[64, 96], train_hw=[360, 480], n_train=14,
                       n_val=3, pool_batch_size=4)
        else:
            cfg.update(image_sizes=[[60, 80, 2], [80, 60, 1]],
                       train_hw=[64, 64], size_base=80, n_train=8,
                       batch_size=2)
        cfg["port_args"]["n_workers"] = 2
        # the port in ``precision`` while the reference stays at f32
        cfg["precision"] = precision
        f.write_text(json.dumps(cfg))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


def run(root: Path, workload: str, seed: int = 12345, seconds: float = 1.0,
        trace: int = 0, fault: str = None, timeout: float = 900.0):
    """``run.main`` of the copy at ``root`` on the CPU, in a fresh
    interpreter; returns the completed process."""
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; "
            f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
            f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
            f"device='cpu', fault={fault!r}))")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="4")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


def result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
