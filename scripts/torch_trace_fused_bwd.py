#!/usr/bin/env python3
"""Per-phase device times of the port's fused inverted-residual backward
kernel (``pp_fused_ir_bwd`` in ``pixelpick_tpu_torch/csrc/fused_ir.cu``) at
the 13 stride-1 t=6 block shapes of one train step (batch 4, 360x480, f32,
one ghost-BN group), on one CUDA card.

    python3 scripts/torch_trace_fused_bwd.py [--tag NAME]

The block shapes and inputs come from ``chip_smoke.py``. For each of the 8
distinct shapes it runs the forward once and the backward on its saved
state ``--reps`` times under ``torch.profiler``, splits the card's kernels into
calls by launch order, labels each launch with its role in the phase
sequence, and takes the median device time of each phase over the calls;
the whole call is also timed with CUDA events (``chip_smoke.time_ms``).
Per-step sums weight each shape by the number of blocks that have it.
Writes ``<out>/trace_fused_bwd_<tag>.json`` and prints a table.
``scripts/torch_trace_fused_fwd.py`` does the same for the forward with the
helpers below (``short``, ``label``, ``trace``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# The phase sequence of the backward by launch order, (kernel, role); dx
# split over its depth adds its fixed-order sum.
ROLES = [("bn_grad_sums", "BN3 sums"), ("bn_grad_finish", "BN3 finish"),
         ("bn_grad_apply", "dh3"), ("bwd_wgrad", "dWp"),
         ("sum_splits", "dWp sum"), ("data_gemm", "da2"),
         ("bn_grad_finish", "BN2 finish"), ("bn_grad_apply", "dh2"),
         ("dw_backward_data", "depthwise data"),
         ("dw_backward_weight", "depthwise weight"),
         ("sum_splits", "dwd sum"), ("bn_grad_finish", "BN1 finish"),
         ("bn_grad_apply", "dh1"), ("bwd_wgrad", "dWe"),
         ("sum_splits", "dWe sum"), ("data_gemm", "dx")]
SEQUENCES = [ROLES, ROLES + [("rows_sum", "dx sum")]]


def product_work(role: str, shape, item: int = 4):
    """(operations, bytes) of one of the backward's four matrix products
    at a block shape: each input read once, each output written once."""
    b, h, w, cin, cout, _ = shape
    ch, px = 6 * cin, b * h * w
    res = cin == cout
    return {
        "da2": (2 * px * cout * ch, (px * (cout + 2 * ch) + ch * cout) * item),
        "dx": (2 * px * ch * cin,
               (px * (ch + cin + (cin if res else 0)) + cin * ch) * item),
        "dWp": (2 * px * ch * cout, px * (ch + cout) * item + 4 * ch * cout),
        "dWe": (2 * px * cin * ch, px * (ch + cin) * item + 4 * cin * ch),
    }.get(role.split(" (")[0])


def short(name: str) -> str:
    """``void (anonymous namespace)::row_gemm<float>(RowGemm)`` -> row_gemm"""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)::", "")
    return head.split("(")[0].split("<")[0].split("::")[-1].strip()


def label(names, sequences) -> list:
    """Each launch's role, ``"role (kernel)"``, from the first sequence of
    (kernel, role) whose kernels are ``names`` in order; numbered launches
    where none is."""
    for seq in sequences:
        if [k for k, _ in seq] == names:
            return [f"{role} ({k})" for k, role in seq]
    return [f"{k + 1:02d} {nm}" for k, nm in enumerate(names)]


def parse(doc: str, argv=None):
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(HERE / "chiprun_out"))
    return ap.parse_args(argv)


def trace(kind: str, make_call, sequences, work, opts) -> int:
    """Trace ``make_call(shape, seed)()`` (one kernel call of the ``kind``
    pass at a block shape) at the train step's distinct block shapes, phase
    by phase; print the table, each product's share of the card, and the
    per-step sums; write ``<out>/trace_fused_<kind>_<tag>.json``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs  # shapes, timing, peaks

    shapes = cs.fused_block_shapes(cs.TRAIN_BATCH)
    per_step = Counter(shapes)
    rows, step = [], {}
    for i, shape in enumerate(dict.fromkeys(shapes)):
        call = make_call(shape, i)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(opts.reps):
                call()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        n = len(events) // opts.reps
        if n * opts.reps != len(events) or n == 0:
            raise RuntimeError(f"{len(events)} device events for "
                               f"{opts.reps} calls")
        names = [short(e[2]) for e in events[:n]]
        roles = label(names, sequences)
        phases = []
        for k in range(n):
            us = [events[c * n + k][1] - events[c * n + k][0]
                  for c in range(opts.reps)]
            ph = {"phase": roles[k], "kernel": names[k],
                  "ms": statistics.median(us) / 1e3}
            wk = work(roles[k], shape)
            if wk is not None:  # a matrix product: its share of the card
                ops, nbytes = wk
                s = ph["ms"] / 1e3
                ph["flop_share"] = ops / cs.PEAK_F32_FLOPS / s
                ph["byte_share"] = nbytes / cs.PEAK_BYTES_PER_S / s
                ph["bound_share"] = max(ph["flop_share"], ph["byte_share"])
            phases.append(ph)
        total = cs.time_ms(call, [()])
        row = {"shape": list(shape), "blocks_per_step": per_step[shape],
               "launches": n, "ms": total,
               "phase_sum_ms": sum(p["ms"] for p in phases),
               "phases": phases}
        rows.append(row)
        print(f"x{shape} (x{per_step[shape]} per step): {n} launches, "
              f"{total:.4f} ms (phases sum {row['phase_sum_ms']:.4f})")
        for p in phases:
            share = (f"  ({100 * p['flop_share']:.1f} % of 67 TFLOP/s, "
                     f"{100 * p['byte_share']:.1f} % of 3.35 TB/s)"
                     if "flop_share" in p else "")
            print(f"    {p['ms']:8.4f}  {p['phase']}{share}")
            step[p["phase"]] = step.get(p["phase"], 0.0) \
                + p["ms"] * per_step[shape]
        del call
    step_ms = sum(r["ms"] * r["blocks_per_step"] for r in rows)
    print(f"per train step (13 blocks): {step_ms:.4f} ms")
    for name, ms in sorted(step.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:8.4f}  {name}")
    out = Path(opts.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = cs.nvidia_smi_line()
    print(smi)
    with open(out / f"trace_fused_{kind}_{opts.tag}.json", "w") as f:
        json.dump({"nvidia_smi": smi, "torch": torch.__version__,
                   "per_step_ms": step_ms, "per_step_phases_ms": step,
                   "shapes": rows}, f, indent=1)
    return 0


def port():
    """The port's fused_ir module from this checkout with TF32 off, or None
    without a card."""
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return None
    sys.path.insert(0, str(HERE))
    from pixelpick_tpu_torch.ops import fused_ir

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return fused_ir


def main(argv=None) -> int:
    opts = parse(__doc__, argv)
    fused_ir = port()
    if fused_ir is None:
        return 2
    import torch

    import chip_smoke as cs

    def make_call(shape, seed):
        b, h, w, cin, cout, d = shape
        x, weights, dy = cs.fused_inputs(b, h, w, cin, cout, torch.float32,
                                         seed=seed)
        args = (b, d, cin == cout)
        _, _, state = fused_ir.fused_fwd_kernel(x, weights, *args)
        return lambda: fused_ir.fused_bwd_kernel(x, dy, weights, *args,
                                                 state=state)

    return trace("bwd", make_call, SEQUENCES, product_work, opts)


if __name__ == "__main__":
    sys.exit(main())
