"""collective_ms.sweep_h4 (ms): rank 0's device ms in NCCL's collective
kernels (``portbench/kernels/collective_ms.sweep_h4.*.json``) per pool batch
of the profiled sweep: the halo rows' and the score map's all-gathers and
the sums over the ranks (``parallel/distributed.py``). An NCCL kernel spins
until its peers arrive, so this holds the transfer and the wait for the
slowest rank. Silent without device operations or without such kernels."""

from pb import program


def read(ctx):
    st = ctx.stretch
    if st is None or not st.ops:
        return None
    ms = st.device_ms_of(ctx.cell.kernel_names("collective_ms.sweep_h4"))
    n = program.stretch_units(ctx)
    return ms / n if ms > 0 and n else None
