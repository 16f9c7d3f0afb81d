"""vis_host_ms.val (ms): the self time of the port's ``val.vis`` span
(``engine/trainer.py:make_eval_step``, the visualisation maps every eval
step computes) over the window, per image."""

from pb import program

program.enable()


def read(ctx):
    picked = program.window(ctx, "val.step", len(ctx.window["image_ms"]))
    if picked is None or not ctx.window["images"]:
        return None
    _, inside = picked
    return program.self_ms("val.vis", inside) / ctx.window["images"]
