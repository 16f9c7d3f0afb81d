"""loader_wait_ms.train (ms): host time per update spent waiting for the
next batch of the port's loader (``data/loader.py``), timed by the
benchmark's loader proxy over the window."""

from pb.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "loader_wait")
