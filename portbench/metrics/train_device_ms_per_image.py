"""train_device_ms_per_image (ms): the card's busy time per training image:
the union of the device's operation intervals (kernels and copies) over
the profiled stretch of whole updates that follows the window, over the
images of those updates. The host does not pace it: it is the card time a
training image costs, which the wall time per image cannot go below. Read
in ``--trace 0`` runs too (``PROFILED``)."""

from pb.readers import busy_s_per_image

PROFILED = True


def read(ctx):
    s = busy_s_per_image(ctx)
    return None if s is None else 1e3 * s
