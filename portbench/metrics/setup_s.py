"""setup_s (s): the whole set-up of the run, from the start of the
process (interpreter and imports included) to the window: the dataset
written, the port's round driver built, the kernels loaded, the weights
made, the warm steps, forwards or sweep."""


def read(ctx):
    return ctx.setup_s
