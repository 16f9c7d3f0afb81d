"""loader_wait_ms.sweep (ms): host time per pool batch spent waiting for
the port's query loader, timed by the loader proxy over the window."""

from pb.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "loader_wait")
