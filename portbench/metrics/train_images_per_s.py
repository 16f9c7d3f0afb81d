"""train_images_per_s (images/s): the training images of every update
completed in the window, over the window, which ends when the port's epoch
loop has closed its last epoch."""

from pb.readers import rate


def read(ctx):
    return rate(ctx)
