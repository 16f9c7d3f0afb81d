"""mfu.train_busy (%): the model's forward and backward operations per
training image (as ``mfu.train`` counts them) over the card's busy time per
image in the profiled stretch (``train_device_ms_per_image``), over the
card's f32 peak: the whole step's share of the peak while the card works."""

from pb.readers import busy_s_per_image


def read(ctx):
    s = busy_s_per_image(ctx)
    if s is None or ctx.peaks is None:
        return None
    flops = ctx.counts.train_flops(ctx.cfg, ctx.cfg["train_hw"])
    return 100.0 * flops / s / ctx.peaks["f32_flops"]
