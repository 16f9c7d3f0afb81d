"""mfu.sweep_h4 (%): the model's forward operations per pool image times
the images of the window, over the window, over the f32 peak of all the
cell's cards."""

from pb.readers import mfu


def read(ctx):
    share = mfu(ctx, ctx.counts.forward_flops(ctx.cfg, ctx.cfg["image_hw"]))
    return share / ctx.cell.chips if share is not None else None
