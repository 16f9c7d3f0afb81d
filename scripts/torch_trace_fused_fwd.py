#!/usr/bin/env python3
"""Per-phase device times of the port's fused inverted-residual forward
kernel (``pp_fused_ir_fwd`` in ``pixelpick_tpu_torch/csrc/fused_ir.cu``) at
the 13 stride-1 t=6 block shapes of one train step (batch 4, 360x480, f32,
one ghost-BN group), on one CUDA card.

    python3 scripts/torch_trace_fused_fwd.py [--tag NAME]

For each of the 8 distinct shapes it runs the forward ``--reps`` times
under ``torch.profiler``, labels each launch with its role in the phase
sequence, and takes the median device time of each phase; the whole call
is also timed with CUDA events. Per-step sums weight each shape by the
number of blocks that have it. Prints each product's share of its bound
(67 TFLOP/s f32, 3.35 TB/s) and writes
``<out>/trace_fused_fwd_<tag>.json``. The tracing itself is
``scripts/torch_trace_fused_bwd.py``'s ``trace``.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_trace_fused_bwd as bwd  # noqa: E402

# The forward's phase sequence by launch order, (kernel, role): the tree's
# (the projection split over its depth adds its fixed-order sum), and the
# one before its products moved to the register-tiled core (row_gemm).


def _sequence(gemm: str, split: bool) -> list:
    return ([(gemm, "expand"), ("moments_finish", "BN1 finish"),
             ("dw_forward", "depthwise"), ("moments_finish", "BN2 finish"),
             (gemm, "project")]
            + ([("rows_sum_moments", "project sum")] if split else [])
            + [("moments_finish", "BN3 finish"), ("bn_output", "y")])


SEQUENCES = [_sequence("data_gemm", False), _sequence("data_gemm", True),
             _sequence("row_gemm", False)]


def phase_work(role: str, shape, item: int = 4):
    """(operations, bytes) of the forward's expand, depthwise and project
    at a block shape (B, H, W, Cin, Cout, dilation): each input read once,
    each output written once. The expand runs over the padded domain."""
    b, h, w, cin, cout, d = shape
    ch, px = 6 * cin, b * h * w
    padded = b * (h + 2 * d) * (w + 2 * d)
    return {
        "expand": (2 * padded * cin * ch,
                   (px * cin + padded * ch + cin * ch) * item),
        "depthwise": (18 * px * ch, (padded * ch + px * ch + 9 * ch) * item),
        "project": (2 * px * ch * cout,
                    (px * (ch + cout) + ch * cout) * item),
    }.get(role.split(" (")[0])


def main(argv=None) -> int:
    opts = bwd.parse(__doc__, argv)
    fused_ir = bwd.port()
    if fused_ir is None:
        return 2
    import torch

    import chip_smoke as cs

    def make_call(shape, seed):
        b, h, w, cin, cout, d = shape
        x, weights, _ = cs.fused_inputs(b, h, w, cin, cout, torch.float32,
                                        seed=seed)
        args = (b, d, cin == cout)
        return lambda: fused_ir.fused_fwd_kernel(x, weights, *args)

    return bwd.trace("fwd", make_call, SEQUENCES, phase_work, opts)


if __name__ == "__main__":
    sys.exit(main())
