#!/usr/bin/env python3
"""Read the numbers that decide ``correct``, for setting their limits.

    python3 portbench/calibrate.py --workload mv2dl_camvid.train \\
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control-seeds 13,14,15 \\
        --faults half_batch:16,17,18 --out build/portbench/calib.jsonl

runs, in one process on the card, the cell's set-up and a short window at
its own sizes for each seed and prints the compared numbers: the program's
on ``--seeds`` (the lower readings), the control's on ``--control-seeds``
(the reference in TF32 in the program's place: the upper readings) and,
on the seeds given after each fault's name, the program with that fault
planted under its timed path (``portbench/phases/<phase>.py``:
``half_batch``, ``unchanged``, ``mislabelled``, ``altered``). One JSON line per reading goes to ``--out``.
The limits in ``portbench/limits/`` are set from these readings, as
``PERF.md`` records.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def main(argv=None, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="", help="name:seed,seed;name:...")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)

    from pb.cell import Cell
    from pb.phase import make

    cell = Cell(a.workload)
    jobs = [(s, None, "f32") for s in _ints(a.seeds)]
    jobs += [(s, None, "tf32") for s in _ints(a.control_seeds)]
    for part in filter(None, a.faults.split(";")):
        name, seeds = part.split(":")
        jobs += [(s, name, "f32") for s in _ints(seeds)]
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    with open(a.out, "a") as out:
        for seed, fault, prec in jobs:
            t0 = time.perf_counter()
            work = Path(tempfile.mkdtemp(prefix="portbench-calib-"))
            try:
                ph = make(cell, seed=seed, seconds=a.seconds, trace=False,
                          device=device, workdir=work, fault=fault)
                ph.setup()
                ph.run_window()
                ph.free_program()
                values = ph.numbers(prec)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            rec = {"workload": a.workload, "seed": seed,
                   "side": "control" if prec != "f32" else
                   (f"fault:{fault}" if fault else "program"),
                   "values": values,
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(rec), flush=True)
            out.write(json.dumps(rec) + "\n")
            out.flush()
    return 0


def _ints(text: str):
    return [int(s) for s in text.split(",") if s]


if __name__ == "__main__":
    sys.exit(main())
