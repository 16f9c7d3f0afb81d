"""allocator_calls.train (count): the caching allocator's device
allocations, frees and retries per update of the window, the port's
``allocator_calls`` counter (``utils/profiling.py``, taken at each
``train.step``'s open and close). Silent without CUDA, or with a port that
counts nothing."""

from pb import program

program.enable()


def read(ctx):
    n = ctx.window["updates"]
    picked = program.window(ctx, "train.step", n)
    if picked is None:
        return None
    steps, _ = picked
    calls = program.counted("allocator_calls", steps[0].start_ns,
                            steps[-1].end_ns)
    return None if calls is None else calls / n
