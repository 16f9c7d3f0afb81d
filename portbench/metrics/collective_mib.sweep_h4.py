"""collective_mib.sweep_h4 (MiB): the port's counter ``collective_bytes``
(``parallel/distributed.py``: the bytes rank 0 hands to the collectives) over
the window's pool batches, per pool batch, from the first batch's
``query.score`` to the last one's end. Silent where the port counts
nothing."""

from pb import program

program.enable()


def read(ctx):
    n = ctx.window["batches"]
    picked = program.window(ctx, "query.score", n)
    if picked is None:
        return None
    anchors, _ = picked
    sent = program.counted("collective_bytes", anchors[0].start_ns,
                           anchors[-1].end_ns)
    return sent / n / 2 ** 20 if sent is not None else None
