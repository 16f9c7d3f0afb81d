"""train_graph_share.train (%): the share of the window's sparse train steps
that replayed a captured CUDA graph (``engine/trainer.py:_TrainGraphs``):
the port's counter ``train_graph_replays`` over it, ``train_graph_captures``
and ``train_eager_steps`` together, between the window's first and last
``train.step``. Silent on a device without CUDA graphs, and with a port
that counts none of them."""

from pb import program

program.enable()

COUNTERS = ("train_graph_replays", "train_graph_captures",
            "train_eager_steps")


def read(ctx):
    if ctx.phase.device.type != "cuda":
        return None
    picked = program.window(ctx, "train.step", ctx.window["updates"])
    if picked is None:
        return None
    steps, _ = picked
    n = [program.counted(c, steps[0].start_ns, steps[-1].end_ns)
         for c in COUNTERS]
    if all(v is None for v in n):
        return None
    total = sum(v or 0 for v in n)
    return 100.0 * (n[0] or 0) / total if total else None
