"""fused_ir_roofline.train (%): the least time of the forward and backward
work of the stride-1 expansion-6 MobileNetV2 blocks of the profiled
updates (``pb/counts.py:fused_block_work``, each call bounded by the f32
peak or the bandwidth), over the device time of the kernels that
``portbench/kernels/fused_ir_roofline.train.*.json`` name. Silent unless the
port's counters show each of those blocks launched forward and backward
once per update."""

from pb.readers import launched, roofline


def read(ctx):
    st, cfg, counts = ctx.stretch, ctx.cfg, ctx.counts
    if st is None or ctx.peaks is None:
        return None
    rows = ctx.phase.batch_rows[st.work["from"]:st.work["to"]]
    shapes = counts.fused_shapes(cfg, cfg["train_hw"])
    if not rows or any(launched(ctx, k) != len(rows) * len(shapes)
                       for k in ("fused_fwd", "fused_bwd")):
        return None
    least = 0.0
    for b in rows:
        for h, w, cin, cout, d in shapes:
            fo, fb, bo, bb = counts.fused_block_work(b, h, w, cin, cout, d)
            least += counts.least_seconds(fo, fb, ctx.peaks) \
                + counts.least_seconds(bo, bb, ctx.peaks)
    return roofline(ctx, "fused_ir_roofline.train", least)
