"""step_host_ms.train (ms): host time inside the train step per update
(``engine/trainer.py:make_train_step``), which is the enqueue: the step
syncs nothing."""

from pb.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "step")
