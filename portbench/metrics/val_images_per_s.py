"""val_images_per_s (images/s): the validation images of the window's
whole passes, over the window."""

from pb.readers import rate


def read(ctx):
    return rate(ctx)
