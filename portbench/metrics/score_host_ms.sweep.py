"""score_host_ms.sweep (ms): host time inside the selector's scoring
function per pool batch (``active/acquisition.py:make_score_fn``)."""

from pb.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "score")
