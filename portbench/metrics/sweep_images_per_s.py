"""sweep_images_per_s (images/s): the pool images scored and picked in
the window's whole sweeps, over the window."""

from pb.readers import rate


def read(ctx):
    return rate(ctx)
