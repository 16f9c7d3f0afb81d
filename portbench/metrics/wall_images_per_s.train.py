"""wall_images_per_s.train (images/s): ``train_images_per_s`` where the
host paces the step: the training images of every update completed in the
window, over the window, which ends when the port's epoch loop has closed
its last epoch. Per layer, with no bound: on shared host cores it spreads
more than a bound of 25 % holds."""

from pb.readers import rate


def read(ctx):
    return rate(ctx)
