"""eval_host_ms.val (ms): host time inside the eval step per image
(``engine/trainer.py:make_eval_step``)."""

from pb.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "eval_step")
