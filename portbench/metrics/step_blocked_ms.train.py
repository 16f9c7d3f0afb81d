"""step_blocked_ms.train (ms): wall minus the main thread's CPU time inside
the port's ``train.forward`` and ``train.optimizer`` spans
(``engine/trainer.py``), per update of the window: the time the host waited
instead of enqueueing. ``train.backward`` is left out: autograd launches
the backward's device work from its own thread, so the main thread waits
there by design."""

from pb import program

program.enable()


def read(ctx):
    n = ctx.window["updates"]
    picked = program.window(ctx, "train.step", n)
    if picked is None:
        return None
    _, inside = picked
    return program.waited_ms(r for r in inside if r.name in (
        "train.forward", "train.optimizer")) / n
