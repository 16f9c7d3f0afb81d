"""bookkeeping_idle_ms.sweep (ms): device idle time inside the port's
``query.encode`` and ``query.stats`` spans (``active/selector.py``: the
picks' masks and encoding, the statistics) per pool batch of the profiled
sweep, the union of its device operations laid over the spans on the
profiler's clock (``pb/program.py``). Silent without device operations."""

from pb import program

program.enable()


def read(ctx):
    idle = program.idle_inside_ms(ctx, {"query.encode", "query.stats"})
    n = program.stretch_units(ctx) if idle is not None else 0
    return idle / n if n else None
