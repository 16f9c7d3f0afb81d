#!/usr/bin/env python3
"""One run of a cell with the port's tracer on, and where its time went by
the port's own spans.

    python3 portbench/span_report.py --workload r50fpn_voc.train \\
        --seed 7 --seconds 51 --trace 1

runs ``run.py`` with the same arguments, in this process, with the port's
tracer (``pixelpick_tpu_torch/utils/profiling.py``) on from the start:
its result line comes first, as ``run.py`` prints it. With ``--trace 0``
its end-to-end metrics are those of a run with the tracer on, the tracer's
cost against a plain ``run.py`` run on the same seed. A last line,
``{"spans": ...}``, gives:

- ``window``: each span name over the window's spans (``pb/program.py``),
  per unit of the cell (update, eval step or pool batch): its count, wall,
  main-thread CPU, waited (wall less CPU) and self (wall less its
  children's) ms;
- ``stretch`` (where the run profiled one, on a card): the device's idle
  ms per unit by the innermost port span at each idle instant (``null``:
  inside none), their shares of the idle time, and ``outside_share``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
from pb import program  # noqa: E402

# the span that marks one unit of each phase, and the window's count of it
UNITS = {"train": ("train.step", lambda w: w["updates"]),
         "val": ("val.step", lambda w: len(w["image_ms"])),
         "sweep": ("query.score", lambda w: w["batches"])}


def window_report(ctx) -> dict:
    anchor, units = UNITS[ctx.cell.traffic["phase"]]
    n = units(ctx.window)
    picked = program.window(ctx, anchor, n)
    if picked is None:
        return {}
    _, inside = picked
    out = {}
    for name in sorted({r.name for r in inside}):
        own = [r for r in inside if r.name == name]
        out[name] = {
            "count": len(own),
            "wall_ms": sum(r.end_ns - r.start_ns for r in own) / 1e6 / n,
            "cpu_ms": sum(r.cpu_ns for r in own) / 1e6 / n,
            "waited_ms": program.waited_ms(own) / n,
            "self_ms": program.self_ms(name, inside) / n}
    return {"unit": anchor, "units": n, "by_span": out}


def stretch_report(ctx) -> dict:
    idle = program.idle_by_span(ctx) if ctx.stretch is not None else None
    if idle is None:
        return {}
    n = program.stretch_units(ctx)
    total = sum(idle.values())
    return {"units": n, "idle_ms_per_unit": total / n,
            "outside_share": idle.get(None, 0.0) / total if total else None,
            "by_span": {str(k) if k else "null": {
                "idle_ms": v / n, "share": v / total if total else None}
                for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}}


def main(argv=None, device: str = "cuda") -> int:
    """``device``: as ``run.main``'s, for the benchmark's own tests."""
    import pb.phase

    program.enable()
    kept = {}
    make = pb.phase.make

    def keep(cell, **kw):
        kept["phase"] = make(cell, **kw)
        return kept["phase"]

    pb.phase.make = keep
    rc = run.main(argv, device=device)
    phase = kept.get("phase")
    if rc != 0 or phase is None:
        return rc
    stretch = phase.stretch if phase.stretch and phase.stretch.done \
        else None
    ctx = SimpleNamespace(cell=phase.cell, window=phase.window,
                          stretch=stretch)
    print(json.dumps({"spans": {"window": window_report(ctx),
                                "stretch": stretch_report(ctx)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
