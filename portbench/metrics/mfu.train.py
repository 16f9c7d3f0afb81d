"""mfu.train (%): the model's forward and backward operations per
training image (three forwards' worth, no recomputation, at the crop the
configuration trains on) times the images of the window, over the
window, over the card's f32 peak."""

from pb.readers import mfu


def read(ctx):
    return mfu(ctx, ctx.counts.train_flops(ctx.cfg, ctx.cfg["train_hw"]))
