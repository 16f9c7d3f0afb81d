"""device_idle_share.val (%): the share of the profiled stretch in which
the device ran no operation: one less the union of its operations'
intervals over the stretch's wall time."""

from pb.readers import idle_share


def read(ctx):
    return idle_share(ctx)
