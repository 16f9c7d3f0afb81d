#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload mv2dl_camvid.train --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for. The cell's configuration, traffic mix, metrics and limits are files
under ``portbench/`` found by the names in ``BENCHMARK.json``
(``pb/cell.py``). The run writes the synthetic dataset under ``TMPDIR``,
builds the port's round driver on it (``pixelpick_tpu_torch``), loads the
seeded weights, warms every shape (``setup_s``), drives the traffic's loop
for ``--seconds`` (``portbench/phases/<phase>.py``), reads its metrics
(with ``--trace 1`` the per-layer ones, from host spans over the window and
a profiled stretch of the same loop after it), frees the program and
compares what the window produced with the plain reference. The last lines
of standard error give each compared number beside its limit; the last
line of standard output is the result's JSON. Without enough CUDA cards,
or with JAX or the JAX package loaded once all of that has run, it prints
no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pixelpick_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHE_ENV = {"TRITON_CACHE_DIR": "build/portbench/triton",
             "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, device: str = "cuda", fault=None, t_start=None) -> int:
    """``device`` and ``fault`` are for the benchmark's own tests: a CPU run
    of the same code, and a run with a fault planted under the timed path,
    whose ``correct`` must come out false."""
    args = parse(argv)
    t_start = T_START if t_start is None else t_start
    os.environ.setdefault("USE_FLAX", "0")
    for k, v in CACHE_ENV.items():
        os.environ.setdefault(k, str(ROOT / v))
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from pb import check, counts
    from pb.cell import Cell, load_peaks
    from pb.phase import make

    cell = Cell(args.workload)
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); {seen}"
              " visible. No result.", file=sys.stderr)
        return 2
    try:
        import pixelpick_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is not in this checkout ({e}). "
              "No result.", file=sys.stderr)
        return 4
    wanted = cell.per_layer() if args.trace else cell.end_to_end()
    readers = {m["name"]: cell.metric_module(m["name"]) for m in wanted}
    # an end-to-end metric read from the device's trace profiles the
    # stretch after the window in a --trace 0 run too
    profiled = bool(args.trace) or any(getattr(r, "PROFILED", False)
                                       for r in readers.values())
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        phase = make(cell, seed=args.seed, seconds=args.seconds,
                     trace=profiled, device=device, workdir=workdir,
                     fault=fault)
        phase.setup()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        phase.run_window()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        phase.run_stretch()
        stretch = phase.stretch if phase.stretch and phase.stretch.done \
            else None
        if stretch is not None:
            stretch.parse()
        kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        ctx = SimpleNamespace(cell=cell, cfg=cell.config, phase=phase,
                              window=phase.window, spans=phase.spans.seconds,
                              stretch=stretch, setup_s=setup_s,
                              peaks=load_peaks(HERE, kind), counts=counts)
        metrics = {}
        for m in wanted:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {"correct": False, "attempted": phase.window["images"],
                  "failed": 0, "metrics": metrics,
                  "device": {"platform": "gpu" if cuda else "cpu",
                             "kind": kind, "count": cell.chips,
                             "memory_peak_bytes": peak}}
        if stretch is not None and args.trace:
            result["device"]["busy_s"] = stretch.busy_us() / 1e6
            result["device"]["window_s"] = stretch.seconds
            result["breakdown"] = stretch.breakdown()
        result["card"] = card_line() if cuda else "cpu"
        phase.free_program()
        values = phase.numbers()
        result["correct"] = check.judge(values, cell.limits)
        result["checks"] = {k: {"value": values[k], "limit": lim}
                            for k, lim in cell.limits.items()}
        found = forbidden_modules()  # after everything this process ran
        if found:
            print(f"portbench: loaded in the measuring process: {found}. "
                  "No result.", file=sys.stderr)
            return 3
        for k, c in result["checks"].items():
            print(f"check {k} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result))
        sys.stdout.flush()
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
