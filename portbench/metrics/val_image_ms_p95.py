"""val_image_ms_p95 (ms): the 95th percentile over every image of the
window of the time between its eval step's completion on the device and the
previous image's (the first image's from the window's start), read from
CUDA events recorded after each step without a sync: idle time of the
device counts, so a stall of the host shows."""

from pb.readers import quantile


def read(ctx):
    ms = ctx.window.get("image_ms")
    return quantile(ms, 0.95) if ms else None
