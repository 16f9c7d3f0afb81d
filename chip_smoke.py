#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (pixelpick_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card, PyTorch built
for CUDA and the CUDA toolkit (nvcc):

    python3 chip_smoke.py [--out chiprun_out]

It builds the hand-written kernels from the sources in the checkout and
drives the port's pool-scoring (query) path at full width, in phases; any
failure exits nonzero:

1. card: name and power limit, torch and CUDA versions, the kernel build;
2. kernels vs plain: the depthwise 3x3 kernel at every shape one
   DeepLabv3+/MobileNetV2 forward (batch 32, 360x480) gives it, in f32 and
   bf16, plus ragged shapes, held against its plain PyTorch version; the
   kernel's, the plain version's and the library's (grouped ``F.conv2d``)
   times, and the bound;
3. oracle query round, as ``main_al`` runs it after a stage: a seeded
   synthetic CamVid-layout pool (367 images at 360x480, labels 0-10, void
   11), the full-width model in f32 with ``--pallas_dw``, margin sampling,
   10 pixels per image, ``top_n_percent 0.05``, pool batch 32. The kernel
   counters are zeroed just before the sweep and read just after it; one
   pool batch is repeated with the library's depthwise conv for comparison;
4. human-mode CLI round: ``pixelpick_tpu_torch.cli.query.main`` on a saved
   checkpoint, with picks labelled from the synthetic ground truth.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. The details go to
``<out>/chip_smoke.json``. Weights are random, from a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle as pkl
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and f32
# CUDA-core arithmetic (the kernel accumulates in f32 in both dtypes)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
L2_BYTES = 50 * 2 ** 20

# Kernel vs plain version, elementwise, with mag = sum over the 9 taps of
# |x| * |w|. f32: the same 9 products summed in the same order; fused vs
# separate multiply-adds round differently, at most ~9 f32 ulp of mag.
# bf16: both sides are f32 sums rounded once to bf16, so one bf16 ulp of the
# result (2**-7 relative) plus the f32 difference.
F32_TOL = 2e-6
BF16_TOL = 2.0 ** -7
MODEL_TOL = 1e-4     # whole-model logits, kernel vs library depthwise, f32,
#                      relative to the largest |logit|: other summation
#                      orders through ~60 layers
SLEEP_CYCLES = 20_000_000  # ~10 ms of device time for the host to run ahead
PORTED_KERNEL = "dw3x3_s1_nhwc"  # csrc/depthwise.cu's kernel, by name

N_IMAGES, IMAGE_HW, POOL_BATCH, N_CLASSES, VOID = 367, (360, 480), 32, 11, 11
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, inputs, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call ``fn(*inputs[i % len(inputs)])``, from
    CUDA events around each call. Every timed call is enqueued behind a
    device-side sleep, so the host's time between calls stays off the
    device's clock; cycling through ``inputs`` (copies that together
    outgrow the L2 cache) makes each call read its input from device
    memory, as the bound assumes."""
    import torch

    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for i, (start, end) in enumerate(events):
        start.record()
        fn(*inputs[i % len(inputs)])
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def cold_copies(x) -> list:
    """``x`` and enough copies of it to fill four times the L2 cache."""
    n = min(16, -(-4 * L2_BYTES // (x.numel() * x.element_size())))
    return [x] + [x.clone() for _ in range(n - 1)]


def import_port():
    """The port from this checkout, never from elsewhere on the path."""
    sys.path.insert(0, str(HERE))
    import pixelpick_tpu_torch

    where = Path(pixelpick_tpu_torch.__file__).resolve().parent.parent
    check(where == HERE, f"pixelpick_tpu_torch imported from {where}, not "
                         f"from this checkout {HERE}")
    return pixelpick_tpu_torch


# ------------------------------ phase 1 ------------------------------

def phase_card() -> dict:
    import torch

    from pixelpick_tpu_torch.ops import depthwise as dw

    smi = nvidia_smi_line()
    print(f"[1] card: {smi}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}, "
          f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    so = dw.build_library()
    dw._library()
    build_s = time.perf_counter() - t0
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").is_file() else ""
    print(f"[1] built {so.relative_to(HERE)} in {build_s:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1] ptxas: {line.strip()}")
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
            "build_s": build_s}


# ------------------------------ phase 2 ------------------------------

def main_path_dw_shapes(model, batch: int) -> list:
    """The (x shape, dilation) of every kernel launch of one forward of
    ``model`` on a (batch, 360, 480) input, recorded at the wrapper."""
    import torch

    from pixelpick_tpu_torch.ops import depthwise as dw

    seen = []
    launch = dw._launch_kernel

    def spy(x, w, dilation):
        seen.append((tuple(x.shape), dilation))
        return launch(x, w, dilation)

    dw._launch_kernel = spy
    try:
        with torch.no_grad():
            model(torch.zeros((batch, *IMAGE_HW, 3), device=DEVICE),
                  upsample=False)
        torch.cuda.synchronize()
    finally:
        dw._launch_kernel = launch
    return seen


def expected_dw_shapes(batch: int) -> list:
    """The stride-1 depthwise inputs that the MobileNetV2 plan implies
    (os 16, width 1.0): the (fixed-)padded block input after expansion."""
    from pixelpick_tpu_torch.models.mobilenet_v2 import block_plan

    plan, _ = block_plan(16, 1.0)
    h, w = IMAGE_HW[0] // 2, IMAGE_HW[1] // 2  # after the stride-2 stem
    shapes = []
    for inp, _oup, stride, d, t in plan:
        hidden = int(round(inp * t))
        hp, wp = h + 2 * d, w + 2 * d
        if stride == 1:
            shapes.append(((batch, hp, wp, hidden), d))
        else:
            h, w = (hp - 3) // 2 + 1, (wp - 3) // 2 + 1
    return shapes


def measure_dw_shape(shape, dilation, dtype, seed) -> dict:
    import torch

    from pixelpick_tpu_torch.ops import depthwise as dw

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(shape, device=DEVICE, generator=g).to(dtype)
    w = (torch.randn((3, 3, shape[-1]), device=DEVICE, generator=g)
         / 3.0).to(dtype)
    return _measure(x, w, dilation, dw)


def _measure(x, w, dilation, dw) -> dict:
    import torch

    y = dw.depthwise_conv3x3(x, w, 1, dilation, 0)
    torch.cuda.synchronize()
    ref = dw.depthwise_reference_torch(x.float(), w.float(), dilation)
    mag = dw.depthwise_reference_torch(x.float().abs(), w.float().abs(),
                                       dilation)
    err = (y.float() - ref.to(x.dtype).float()).abs()
    if x.dtype == torch.float32:
        ok = bool((err <= F32_TOL * mag).all())
    else:
        ok = bool((err <= BF16_TOL * ref.abs() + F32_TOL * mag).all())
    item = x.element_size()
    nbytes = (x.numel() + w.numel() + y.numel()) * item
    flops = 18 * y.numel()
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_F32_FLOPS * 1e3
    inputs = [(xc, w) for xc in cold_copies(x)]
    return {
        "x": list(x.shape), "dilation": dilation,
        "dtype": str(x.dtype).replace("torch.", ""),
        "max_abs_err": float(err.max()), "ok": ok,
        "ms": time_ms(lambda a, b: dw.depthwise_conv3x3(a, b, 1, dilation, 0),
                      inputs),
        "plain_ms": time_ms(
            lambda a, b: dw.depthwise_reference_torch(a, b, dilation),
            inputs, reps=5),
        "library_ms": time_ms(
            lambda a, b: dw.grouped_conv_nhwc(a, b, 1, dilation), inputs),
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
    }


def phase_kernels(model) -> dict:
    import torch

    from pixelpick_tpu_torch.ops import depthwise as dw

    seen = main_path_dw_shapes(model, POOL_BATCH)
    expected = expected_dw_shapes(POOL_BATCH)
    check(seen == expected, f"kernel launches of one forward {seen} differ "
                            f"from the plan's {expected}")
    print(f"[2] one forward launches the depthwise kernel {len(seen)} times")
    results = {"float32": [], "bfloat16": [], "ragged": []}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for i, (shape, d) in enumerate(seen):
            r = measure_dw_shape(shape, d, dtype, seed=i)
            results[name].append(r)
            print(f"[2] {name:8s} x{tuple(shape)} d={d}: err "
                  f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
            check(r["ok"], f"kernel disagrees with its plain version at "
                           f"{shape} d={d} {name}: {r['max_abs_err']}")
    # ragged extras: odd widths, C not a multiple of 8 (narrower vector
    # paths), dilation 2 and 3, and a misaligned base pointer
    extras = [((2, 19, 25, 20), 1), ((3, 15, 17, 7), 2),
              ((1, 11, 15, 129), 3), ((2, 9, 9, 6), 1)]
    for i, (shape, d) in enumerate(extras):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=DEVICE).manual_seed(100 + i)
            n = int(np.prod(shape))
            if i == len(extras) - 1:  # a view one element into its storage
                x = torch.randn(n + 1, device=DEVICE, generator=g) \
                    .to(dtype)[1:].view(shape)
            else:
                x = torch.randn(shape, device=DEVICE, generator=g).to(dtype)
            w = (torch.randn((3, 3, shape[-1]), device=DEVICE, generator=g)
                 / 3.0).to(dtype)
            r = _measure(x, w, d, dw)
            results["ragged"].append(r)
            print(f"[2] ragged {r['dtype']} x{shape} d={d}: err "
                  f"{r['max_abs_err']:.3g}")
            check(r["ok"], f"kernel disagrees with its plain version at "
                           f"ragged {shape} d={d} {dtype}")
    return results


# ------------------------------ phase 3 ------------------------------

def make_synthetic_camvid(root: Path, n: int, seed: int = 0) -> None:
    """CamVid layout: {root}/train/*.png RGB and {root}/trainannot/*.png
    labels 0..10 with void 11, in 30x40-pixel tiles; images are a colour per
    class plus noise."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (N_CLASSES + 1, 3))
    h, w = IMAGE_HW
    (root / "train").mkdir(parents=True)
    (root / "trainannot").mkdir(parents=True)
    for i in range(n):
        tiles = rng.integers(0, N_CLASSES, (h // 30, w // 40))
        tiles[rng.random(tiles.shape) < 0.05] = VOID
        lab = np.repeat(np.repeat(tiles, 30, 0), 40, 1).astype(np.uint8)
        img = palette[lab] + rng.integers(-20, 21, (h, w, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            root / "train" / f"{i:04d}.png", compress_level=1)
        Image.fromarray(lab).save(root / "trainannot" / f"{i:04d}.png",
                                  compress_level=1)


def phase_oracle_round(work: Path, model, args) -> dict:
    import torch

    from pixelpick_tpu_torch.active.selector import QuerySelector
    from pixelpick_tpu_torch.data.factory import get_dataset
    from pixelpick_tpu_torch.data.loader import Loader
    from pixelpick_tpu_torch.engine.trainer import normalize_images
    from pixelpick_tpu_torch.models import layers
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.ops import depthwise as dw

    dataset = get_dataset(args, val=False, query=True)
    check(dataset.n_pixels_total == N_IMAGES * args.n_pixels_by_us,
          f"initial queries: {dataset.n_pixels_total} pixels")
    before = [q.copy() for q in dataset.queries]
    torch.cuda.reset_peak_memory_stats()
    with Loader(dataset, POOL_BATCH, mode="query",
                n_workers=args.n_workers) as loader:
        n_forwards = len(loader)
        selector = QuerySelector(args, loader, model, DEVICE)
        torch.cuda.synchronize()
        dw.reset_launch_counts()
        t0 = time.perf_counter()
        picks = selector(nth_query=0)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        counts = dict(dw.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[3] sweep of {N_IMAGES} images in {n_forwards} forwards: "
          f"{sweep_s:.3f} s = {N_IMAGES / sweep_s:.1f} images/s "
          f"(cold image cache, PNG decode included); launches {counts}; "
          f"peak device memory {peak_gb:.2f} GB")
    check(counts["kernel"] == 14 * n_forwards,
          f"{counts['kernel']} kernel launches for {n_forwards} forwards")
    check(counts["stride2_conv"] == 3 * n_forwards,
          f"{counts['stride2_conv']} stride-2 convs for {n_forwards} forwards")

    # 3,670 new picks, none on a labelled or void pixel
    check(len(picks) == N_IMAGES, f"{len(picks)} images picked")
    new = 0
    for i, p in enumerate(dataset.list_inputs):
        info = picks[p]
        ys, xs = np.asarray(info["y_coords"]), np.asarray(info["x_coords"])
        new += len(ys)
        check(not before[i][ys, xs].any(), f"{p}: picked a labelled pixel")
        check(not (dataset._load_y(i)[ys, xs] == VOID).any(),
              f"{p}: picked a void pixel")
    check(new == N_IMAGES * args.n_pixels_by_us, f"{new} new picks")
    check(dataset.n_pixels_total == 2 * new, "labelled masks not updated")
    stats_path = Path(args.dir_checkpoints) / "0_query" / "query_stats.pkl"
    check(stats_path.is_file(), f"{stats_path} not written")
    with open(stats_path, "rb") as f:
        stats = pkl.load(f)
    check(np.isfinite(stats["avg_entropy"]), f"stats {stats}")
    out_dir = Path(args.dir_checkpoints) / "1_query"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "queries.pkl", "wb") as f:  # as main_al dumps them
        pkl.dump(picks, f)
    warm = warm_sweep(selector, dataset, args)

    # one pool batch again, kernel vs library depthwise, TF32 off
    xb = torch.from_numpy(np.stack([dataset._load_x(i)
                                    for i in range(POOL_BATCH)])).to(DEVICE)
    x = normalize_images(xb, args.mean, args.std)
    layers.set_depthwise_impl("xla")
    try:
        library_model = get_model(args)
    finally:
        layers.set_depthwise_impl("pallas")
    library_model.load_state_dict(model.state_dict())
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    with torch.no_grad():
        ours = model(x, upsample=False)["pred"].float()
        dw.reset_launch_counts()
        ref = library_model(x, upsample=False)["pred"].float()
        torch.cuda.synchronize()
        check(dw.launch_counts["kernel"] == 0,
              "the library-path model launched the kernel")
        err = float((ours - ref).abs().max())
        scale = float(ref.abs().max())
        check(bool(torch.isfinite(ours).all()), "non-finite logits")
        check(tuple(ours.shape) == (POOL_BATCH, IMAGE_HW[0] // 4,
                                    IMAGE_HW[1] // 4, N_CLASSES),
              f"logits shape {tuple(ours.shape)}")
        fwd = {}
        for name, m in (("kernel", model), ("library", library_model),
                        ("library_2", library_model), ("kernel_2", model)):
            fwd[name] = time_ms(lambda m=m: m(x, upsample=False), [()],
                                reps=10)
    print(f"[3] one pool batch, kernel vs library depthwise: max |diff| "
          f"{err:.3g} of max |logit| {scale:.3g} (tolerance {MODEL_TOL} "
          f"relative); forward ms per batch of {POOL_BATCH}: {fwd}")
    check(err <= MODEL_TOL * scale, f"model logits disagree: {err} vs "
                                    f"{MODEL_TOL} * {scale}")
    return {"n_forwards": n_forwards, "launches": counts,
            "sweep_s": sweep_s, "images_per_s": N_IMAGES / sweep_s,
            "peak_device_gb": peak_gb, "warm_sweep": warm,
            "model_max_abs_err": err, "model_max_abs_logit": scale,
            "forward_ms": fwd,
            "query_stats": {k: v for k, v in stats.items()
                            if k != "label_distribution"}}


def warm_sweep(selector, dataset, args) -> dict:
    """The round's scoring again over the pool, its images decoded already:
    once timed, once under ``torch.profiler`` for the device's busy share
    and the kernels that take its time. Picks are dropped; no mask
    changes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pixelpick_tpu_torch.data.loader import Loader

    generator = torch.Generator(device=DEVICE).manual_seed(1)

    def sweep() -> float:
        t0 = time.perf_counter()
        with Loader(dataset, POOL_BATCH, mode="query",
                    n_workers=args.n_workers) as loader:
            for batch in loader:
                dev = {k: torch.from_numpy(batch[k]).to(DEVICE)
                       for k in ("x", "excluded", "y")}
                selector._score_fn(dev, generator)[0].cpu()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm_s = sweep()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_s = sweep()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for s, e, name in spans:  # union of the device intervals
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    busy = busy_us / 1e6 / traced_s if spans else None
    ours_ms = sum(t for name, (t, _) in by_name.items()
                  if PORTED_KERNEL in name) / 1e3
    print(f"[3] warm sweep (images decoded): {warm_s:.3f} s = "
          f"{N_IMAGES / warm_s:.1f} images/s; under the profiler "
          f"{traced_s:.3f} s, device busy "
          + (f"{100 * busy:.1f}%, of which {ours_ms:.3f} ms in "
             f"{PORTED_KERNEL}" if spans else "not measured (the profiler "
             "saw no device activity)"))
    for name, (us, n) in top:
        print(f"[3]   {us / 1e3:9.3f} ms {n:5d}x  {name[:90]}")
    return {"warm_s": warm_s, "images_per_s": N_IMAGES / warm_s,
            "traced_s": traced_s, "device_busy_share": busy,
            "device_busy_ms": busy_us / 1e3, "ported_kernel_ms": ours_ms,
            "top_device_ms": [{"name": k, "ms": v[0] / 1e3, "count": v[1]}
                              for k, v in top]}


# ------------------------------ phase 4 ------------------------------

def phase_human_cli(work: Path, model, args) -> dict:
    from PIL import Image

    from pixelpick_tpu_torch.active import codec
    from pixelpick_tpu_torch.cli.query import main as query_main
    from pixelpick_tpu_torch.engine.checkpoint import save_checkpoint
    from pixelpick_tpu_torch.ops import depthwise as dw

    run = work / "human"
    labelled = {}
    # the oracle round's files, labelled from the synthetic ground truth in
    # place of the annotation tool
    for nth in (0, 1):
        with open(Path(args.dir_checkpoints) / f"{nth}_query" / "queries.pkl",
                  "rb") as f:
            queries = pkl.load(f)
        for p, info in queries.items():
            gt = np.asarray(Image.open(
                Path(args.dir_dataset) / "trainannot" / Path(p).name))
            info["category_id"] = gt[info["y_coords"], info["x_coords"]] \
                .astype(np.int64).tolist()
            mask = labelled.setdefault(Path(p).name, np.zeros(IMAGE_HW, bool))
            mask[info["y_coords"], info["x_coords"]] = True
        (run / f"{nth}_query").mkdir(parents=True)
        with open(run / f"{nth}_query" / "queries.pkl", "wb") as f:
            pkl.dump(queries, f)
    ckpt = work / "model.ckpt"
    save_checkpoint(str(ckpt), model)

    dw.reset_launch_counts()
    t0 = time.perf_counter()
    path = query_main([
        "--dataset_name", "cv", "--dir_datasets", str(work),
        "--dir_checkpoints", str(run), "--p_state_dict", str(ckpt),
        "--device", DEVICE, "--pallas_dw", "--n_pixels_by_us", "10",
        "--pool_batch_size", str(POOL_BATCH),
        "--n_workers", str(args.n_workers)])
    cli_s = time.perf_counter() - t0
    counts = dict(dw.launch_counts)
    check(Path(path) == run / "2_query" / "queries.pkl", f"wrote {path}")
    with open(path, "rb") as f:
        decoded = codec.decode_queries(pkl.load(f), return_as_dict=True)
    check(len(decoded) == N_IMAGES, f"{len(decoded)} images in {path}")
    for p, mask in decoded.items():
        check(int(mask.sum()) == 10, f"{p}: {int(mask.sum())} picks")
        check(not (mask & labelled[Path(p).name]).any(),
              f"{p}: picked a labelled pixel")
    n_forwards = -(-N_IMAGES // POOL_BATCH)
    check(counts["kernel"] == 14 * n_forwards,
          f"CLI round: {counts['kernel']} kernel launches")
    print(f"[4] CLI human-mode round wrote {Path(path).relative_to(HERE)} "
          f"({len(decoded)} images, 10 picks each) in {cli_s:.2f} s; "
          f"launches {counts}")
    return {"path": str(Path(path).relative_to(HERE)), "cli_s": cli_s,
            "launches": counts}


# ------------------------------ main ------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for chip_smoke.json")
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import_port()
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models.factory import get_model

    card = phase_card()

    work = HERE / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_camvid(work / "camvid", N_IMAGES)
    print(f"[3] wrote the synthetic pool in {time.perf_counter() - t0:.1f} s")
    args = default_args(
        dataset_name="cv", dir_datasets=str(work),
        dir_dataset=str(work / "camvid"),
        dir_checkpoints=str(work / "run"), write_files=True, device=DEVICE,
        pallas_dw=True, precision="f32", width_multiplier=1.0,
        query_strategy="margin_sampling", n_pixels_by_us=10,
        top_n_percent=0.05, pool_batch_size=POOL_BATCH, n_workers=4, seed=0)
    model = get_model(args)

    kernels = phase_kernels(model)
    oracle = phase_oracle_round(work, model, args)
    human = phase_human_cli(work, model, args)

    f32 = kernels["float32"]
    entry = {
        "name": "depthwise3x3_s1_nhwc",
        "route": "cuda",
        "source": "pixelpick_tpu_torch/csrc/depthwise.cu",
        "replaces": "pixelpick_tpu/ops/depthwise.py:73",
        "launches": oracle["launches"]["kernel"],
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        # per forward of the main path: the 14 launches at batch 32, f32
        "ms": sum(r["ms"] for r in f32),
        "plain_ms": sum(r["plain_ms"] for r in f32),
        "bound_ms": sum(r["bound_ms"] for r in f32),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in f32)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in f32),
    }
    out = Path(opts.out)
    if not out.is_absolute():
        out = HERE / out
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "kernels": kernels, "oracle_round": oracle,
                   "human_cli": human, "summary": entry}, f, indent=1)
    shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [entry]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
