"""A cell's files, found by the names ``BENCHMARK.json`` gives.

- ``BENCHMARK.json`` (the checkout's root): the cell's configuration and
  traffic names, and the metrics that the cell reports;
- ``portbench/configs/<config>.json``: the configuration's sizes;
- ``portbench/traffic/<traffic>.json``: the traffic mix: which phase the
  window drives, and its parameters;
- ``portbench/phases/<phase>.py``: the phase, which drives one loop of the
  port and compares what it produced (``pb/phase.py``);
- ``portbench/metrics/<metric>.py``: the reader of a metric;
- ``portbench/kernels/<metric>.<impl>.json``: the kernel names a roofline
  sums, one file per implementation;
- ``portbench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct``.

A later cell, traffic mix, phase, metric or kernel list is a new file;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


class Cell:
    def __init__(self, workload: str, root: Optional[Path] = None):
        self.bench_dir = Path(root) if root else BENCH_DIR
        spec_path = self.bench_dir.parent / "BENCHMARK.json"
        self.spec = json.loads(spec_path.read_text())
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in {spec_path}; "
                           f"known: {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in self.spec["configs"]}
        entry = configs[self.workload["config"]]
        self.config = json.loads((self.bench_dir.parent
                                  / entry["file"]).read_text())
        self.traffic = self._json("traffic", self.workload["traffic"])
        self.limits = self._json("limits", workload)

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.bench_dir / kind / f"{name}.json").read_text())

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if self._applies(m)]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a ``workloads`` key whose end-to-end metric the cell
        reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.spec["per_layer"]:
            if self.name in m["workloads"] if "workloads" in m \
                    else m["moves"] in e2e:
                out.append(m)
        return out

    def metric_module(self, name: str):
        """``portbench/metrics/<name>.py``: its ``read(ctx)``, and
        ``PROFILED = True`` where it reads the profiled stretch in a
        ``--trace 0`` run too."""
        path = self.bench_dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def kernel_names(self, metric: str) -> List[str]:
        """Every kernel name listed for ``metric``, over all its
        implementation files."""
        names: List[str] = []
        for p in sorted((self.bench_dir / "kernels").glob(f"{metric}.*.json")):
            names += json.loads(p.read_text())["kernels"]
        return names


def load_peaks(bench_dir: Path, device_kind: str) -> Optional[Dict]:
    """The published peaks of ``device_kind`` from ``peaks.json``, matched
    by a substring of its name; None for a card the table lacks."""
    table = json.loads((bench_dir / "peaks.json").read_text())["cards"]
    for row in table:
        if row["match"] in device_kind:
            return row
    return None
