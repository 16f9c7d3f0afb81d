"""depthwise_roofline.sweep (%): the least time of block 0's stride-1
depthwise 3x3 in each forward of the profiled sweep (the one that the
port's kernel runs in an evaluation forward under ``--fused_ir``;
``pb/counts.py:depthwise_work``), over the device time of the kernels that
``portbench/kernels/depthwise_roofline.sweep.*.json`` name. Silent unless
the port's counter shows one launch per forward."""

from pb.readers import launched, roofline


def read(ctx):
    st, cfg, counts = ctx.stretch, ctx.cfg, ctx.counts
    if st is None or ctx.peaks is None:
        return None
    shapes = ctx.phase.batch_shapes[st.work["from"]:st.work["to"]]
    if not shapes or launched(ctx, "depthwise_kernel") != len(shapes):
        return None
    least = 0.0
    for b, hh, ww in shapes:
        h, w, c, d = counts.first_depthwise(cfg, (hh, ww))
        least += counts.least_seconds(*counts.depthwise_work(b, h, w, c, d),
                                      ctx.peaks)
    return roofline(ctx, "depthwise_roofline.sweep", least)
