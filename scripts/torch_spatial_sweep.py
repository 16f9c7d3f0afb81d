#!/usr/bin/env python3
"""The query CLI with ``--spatial_query_sharding`` on N NCCL ranks, one card
each, against the same command without the flag in one process, at full
width on CUDA cards.

    python3 scripts/torch_spatial_sweep.py [--ranks 4] [--out chiprun_out]

The pool is 8 synthetic CamVid-layout images of 1024x2048 at pool batch 4,
a labelled round of 10 pixels per image before it; the model is the
DeepLabv3+ on MobileNetV2 at width 1.0, f32, with ``--pallas_dw``, at
seeded random weights (11 classes), loaded from a checkpoint by the CLI.
The ranks are ``chip_smoke.py --worker`` processes (``spatial_ranks``),
each given its coordinator flags and ``--data_parallel N``. It prints,
beside the cards' ``nvidia-smi`` names and power limits: the picks against
the single process's (``chip_smoke.picks_agree``: near-ties at the top-k
boundary set aside), the depthwise launches per rank, each rank's peak
device memory beside the single process's, the images/s of a warm sweep
(the median of 3, PNG decode included) on each side, and the time a rank
spends inside the collectives (each between two synchronisations, waits
included). Writes ``<out>/spatial_sweep_<N>xnccl.json``; exits nonzero if
a rank fails or the picks disagree.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

IMAGES, HW, BATCH, REPS = cs.SPATIAL_CS_IMAGES, cs.SPATIAL_CS_HW, \
    cs.SPATIAL_CS_BATCH, 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out")
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false; this script needs CUDA "
              "cards", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < opts.ranks:
        raise SystemExit(f"{opts.ranks} NCCL ranks need {opts.ranks} cards; "
                         f"{torch.cuda.device_count()} are visible")
    cs.import_port()
    from pixelpick_tpu_torch.cli.query import main as query_main
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.engine.checkpoint import save_checkpoint
    from pixelpick_tpu_torch.models.factory import get_model

    cs.phase_card()  # builds the kernels once, for every rank
    out = Path(opts.out)
    out = out if out.is_absolute() else ROOT / out
    work = ROOT / "build" / "spatial_sweep"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt = work / "model.ckpt"
    save_checkpoint(str(ckpt), get_model(default_args(
        dataset_name="cv", device=cs.DEVICE, pallas_dw=True,
        width_multiplier=1.0, precision="f32"), cs.DEVICE))
    labelled = cs.spatial_query_set(work, IMAGES, HW, seed=22)

    def argv(name: str, spatial: bool) -> list:
        return cs.query_argv(work, cs.query_run(work, name, labelled), ckpt,
                             BATCH, spatial)

    single = [cs.observed(query_main, argv(f"single_{i}", False),
                          record=i == 0) for i in range(1 + REPS)]
    torch.cuda.empty_cache()

    calls = [dict(name="sweep", record=True), *(
        dict(name=f"warm_{i}") for i in range(REPS)),
        dict(name="collectives", collectives=True)]
    for c, port in zip(calls, cs.free_ports(len(calls))):
        c.update(entry="query", port=port, argv=argv(c["name"], True))
    jobs = [dict(kind="spatial", rank=r, world=opts.ranks, backend="nccl",
                 calls=calls, output=str(work / "scores.pt"),
                 report=str(work / f"rank_{r}.json"))
            for r in range(opts.ranks)]
    t0 = time.perf_counter()
    cs.run_workers(jobs, work / "ranks.log")
    ranks_s = time.perf_counter() - t0
    got = torch.load(work / "scores.pt", weights_only=False)
    reports = [json.loads((work / f"rank_{r}.json").read_text())
               for r in range(opts.ranks)]
    agree = cs.held_to_single(work / "sweep", got["sweep"],
                              work / "single_0", single[0]["scores"],
                              labelled, HW)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    single_s = statistics.median(s["sweep_s"] for s in single[1:])
    ranks_sweep_s = max(statistics.median(r[f"warm_{i}"]["sweep_s"]
                                          for i in range(REPS))
                        for r in reports)
    keep = ("launches", "on_stripes", "sharded", "sweep_s", "peak_mib")
    result = {
        "cards": smi, "ranks": opts.ranks, "backend": "nccl",
        "images": IMAGES, "batch": BATCH, "hw": HW, "agree": agree,
        "ranks_s": ranks_s,
        "single": [{k: s[k] for k in keep} for s in single],
        "per_rank": reports,
        "single_images_per_s": IMAGES / single_s,
        "ranks_images_per_s": IMAGES / ranks_sweep_s}
    print(f"{opts.ranks} ranks (nccl) against one process, {IMAGES} images "
          f"of {HW[0]}x{HW[1]} at pool batch {BATCH}: "
          f"{agree['picks_differ']} pick otherwise, "
          f"{agree['candidates_differ']} have other candidates (worst tie "
          f"gap {agree['worst_tie_gap']:.3g}, limit {cs.PICK_TIE_TOL}), "
          f"{agree['picks_differ_equal_candidates']} pick otherwise from "
          f"equal candidates")
    print(f"depthwise launches per rank "
          f"{[r['sweep']['launches'] for r in reports]}, on stripes "
          f"{[r['sweep']['on_stripes'] for r in reports]} (one process "
          f"{single[0]['launches']})")
    print(f"peak device memory per rank "
          f"{[round(r['sweep']['peak_mib'], 1) for r in reports]} MiB, one "
          f"process {single[0]['peak_mib']:.1f} MiB")
    print(f"warm sweep {result['ranks_images_per_s']:.2f} images/s on the "
          f"ranks, {result['single_images_per_s']:.2f} in one process "
          f"(median of {REPS}, PNG decode included); the collectives per "
          f"rank {[r['collectives']['collectives'] for r in reports]} (ms, "
          f"calls, MiB sent) in sweeps of "
          f"{[round(r['collectives']['sweep_s'] * 1e3, 1) for r in reports]}"
          f" ms")
    for line in smi:
        print(line)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"spatial_sweep_{opts.ranks}xnccl.json"
    path.write_text(json.dumps(result, indent=1))
    n_fwd = -(-IMAGES // BATCH)
    cs.check(agree["ok"], f"the ranks' picks differ: {agree}")
    cs.check(all(r[c["name"]]["sharded"] == [True] * n_fwd
                 for r in reports for c in calls),
             "a batch was not sharded")
    cs.check(all(r["sweep"]["on_stripes"] == 14 * n_fwd for r in reports),
             "the kernel did not run on stripes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
