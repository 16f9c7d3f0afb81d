"""rank_skew_ms.sweep_h4 (ms): per pool batch of the window, the latest
rank's start of ``query.score`` less the earliest rank's, averaged over the
window's batches: how far the ranks drift apart before the batch's first
collective. Read from every rank's span records, which the phase gathers to
rank 0 (``utils/profiling.py:gather_records``) and groups by their rank
tag; the ranks share the host's clock. Silent where the port gathers no
records, or where a rank's batches do not line up with rank 0's."""

from collections import defaultdict

from pb import program

program.enable()


def read(ctx):
    gathered = getattr(ctx.phase, "rank_records", None)
    n = ctx.window["batches"]
    picked = program.window(ctx, "query.score", n) if gathered else None
    if picked is None:
        return None
    starts = defaultdict(list)
    for spans, _ in gathered:
        for r in spans:
            if r.name == "query.score":
                starts[getattr(r, "rank", None)].append(r.start_ns)
    if len(starts) < 2 or None in starts:
        return None
    own, t0 = starts[0], picked[0][0].start_ns
    if t0 not in own or any(len(s) != len(own) for s in starts.values()):
        return None
    first = own.index(t0)
    cols = zip(*(s[first:first + n] for s in starts.values()))
    return sum(max(c) - min(c) for c in cols) / n / 1e6
