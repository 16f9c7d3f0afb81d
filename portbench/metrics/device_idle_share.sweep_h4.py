"""device_idle_share.sweep_h4 (%): the share of the profiled sweep in which
rank 0's card ran no operation: one less the union of its operations'
intervals over the stretch's wall time."""

from pb.readers import idle_share


def read(ctx):
    return idle_share(ctx)
