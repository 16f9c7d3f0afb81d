#!/usr/bin/env python3
"""One rank past the first of a cell that runs over several ranks of one
host (``phases/sweep_sharded.py``).

    python3 portbench/pb/ranks.py --workload W --seed N --seconds S \\
        --trace 0|1 --rank R --coordinator localhost:PORT --workdir DIR \\
        --device cuda|cpu [--fault NAME]

from the root of a checkout, started by rank 0 (``run.py``'s process) with
its own arguments and the run's directory, where rank 0 has written the
dataset, the weights and the labelled pixels. It builds the cell's phase as
rank ``R``, joins rank 0's world at ``--coordinator``, serves rank 0's words
until ``end``, and exits 0. It exits at once, non-zero, when its parent is
gone, and with 3 when JAX or the JAX package was loaded by then, as
``run.py`` refuses them for rank 0.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # portbench/
ORPHAN_EXIT = 8


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name in ("--workload", "--coordinator", "--workdir", "--device"):
        p.add_argument(name, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--fault", default="")
    return p.parse_args(argv)


def exit_with_parent(parent: int) -> None:
    """End this process once its parent has gone (a rank blocked in a
    collective would otherwise wait on it)."""
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(ORPHAN_EXIT)


def main(argv=None) -> int:
    threading.Thread(target=exit_with_parent, args=(os.getppid(),),
                     daemon=True).start()
    args = parse(argv)
    # this file's own directory first on the path would shadow the standard
    # library's ``trace`` with the harness's
    own = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != own]
    for p in (str(HERE.parent), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import run
    from pb.cell import Cell
    from pb.phase import make

    phase = make(Cell(args.workload), seed=args.seed, seconds=args.seconds,
                 trace=bool(args.trace), device=args.device,
                 workdir=Path(args.workdir), fault=args.fault or None,
                 rank=args.rank, coordinator=args.coordinator)
    phase.setup()
    phase.serve()
    phase.free_program()
    found = run.forbidden_modules()
    if found:
        print(f"portbench: rank {args.rank} loaded {found}.",
              file=sys.stderr, flush=True)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
