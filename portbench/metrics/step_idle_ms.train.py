"""step_idle_ms.train (ms): device idle time inside the port's
``train.step`` span (``engine/trainer.py``; its children included) per
update of the profiled stretch: the union of the stretch's device
operations laid over the span on the profiler's clock (``pb/program.py``).
Silent without device operations, or with a port that records no span."""

from pb import program

program.enable()


def read(ctx):
    idle = program.idle_inside_ms(ctx, {"train.step"})
    n = program.stretch_units(ctx) if idle is not None else 0
    return idle / n if n else None
