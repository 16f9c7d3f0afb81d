"""mfu.val (%): the model's forward operations per validation image
times the images of the window, over the window, over the card's f32
peak."""

from pb.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.counts.forward_flops(ctx.cfg, ctx.cfg["image_hw"]))
