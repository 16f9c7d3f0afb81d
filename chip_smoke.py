#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (pixelpick_tpu_torch) on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card, PyTorch built
for CUDA and the CUDA toolkit (nvcc):

    python3 chip_smoke.py [--out chiprun_out]

It builds the hand-written kernels from the sources in the checkout (one
``nvcc`` per source, started together) and drives the port's pool-scoring
(query) path, its training round and its other round modes (micro-batch,
dense, MC-dropout committee), its train and eval CLIs with stage
snapshots, JAX-layout checkpoint files, ``--resume_campaign`` and
``--pretrained_ckpt``, device augmentation on CamVid, Cityscapes and VOC,
PASCAL VOC with DeepLab and with the ResNet-50 FPN, data parallelism over
``torch.distributed``, the annotation tools, the TPU-only rewrites of the
default math (``--s2d_backbone``, ``--conv3x3_matmul``, ``remat_blocks``)
and height-sharded pool sweeps (``--spatial_query_sharding``, with the
s2d blocks too), at full width, in phases; any failure exits nonzero:

1. card: name and power limit, torch and CUDA versions, the kernel builds;
2. kernels vs plain: the depthwise 3x3 kernel at every shape one
   DeepLabv3+/MobileNetV2 forward (batch 32, 360x480) gives it, in f32 and
   bf16, and, in f32, at the shapes of a VOC query bucket (batch 32,
   304x400) and of a VOC train batch (10 crops of 320x320), plus ragged
   shapes, held against its plain PyTorch version; the kernel's, the plain
   version's and the library's (grouped ``F.conv2d``) times, and the
   bound;
3. oracle query round, as ``main_al`` runs it after a stage: a seeded
   synthetic CamVid-layout pool (367 images at 360x480, labels 0-10, void
   11), the full-width model in f32 with ``--pallas_dw``, margin sampling,
   10 pixels per image, ``top_n_percent 0.05``, pool batch 32. The kernel
   counters are zeroed just before the sweep and read just after it; one
   pool batch is repeated with the library's depthwise conv for comparison;
4. human-mode CLI round: phase 3's two query files labelled through the
   port's annotation tools, the synthetic ground truth answering (round 0
   by the keyboard annotator head-less, round 1 through the VIA round trip,
   the annotator page served over localhost; every label checked against
   the ground truth), then ``pixelpick_tpu_torch.cli.query.main`` on a
   saved checkpoint;
5. fused kernels vs plain: the fused inverted-residual forward and backward
   kernels at the 13 stride-1 t=6 block shapes of a train step (batch 4,
   one ghost-BN group) and at the remainder batch of 3, in f32 and bf16,
   plus ragged shapes (two groups, odd sizes, channels not a multiple of
   the tiles), held against their plain versions gradient by gradient, two
   calls bit-equal, the backward (which reads the forward's saved state)
   leaving that state's bytes unchanged, and controls (dx zeroed, a
   gradient 5% off) refused; the kernels', the plain versions' and the
   library-built block's times (its backward alone, from a graph built
   beforehand), and the bounds; then the 13 blocks of VOC's train step
   (batch 10, 320x320 crops, one ghost-BN group) timed in f32, checked in
   bf16, and at VOC's remainder batch of 4;
6. train step: the full-width model at 360x480, batch 4, f32, dropout off
   for this check, at well-conditioned weights: the loss and every
   parameter gradient with the kernels (``--fused_ir --pallas_dw``) against
   the library path, leaf by leaf, and a planted 5% fault refused; the
   launches per step (13 fused forward, 13 fused backward, 1 + 1
   depthwise); the median step time and the peak device memory of both
   paths;
7. AL campaign: ``pixelpick_tpu_torch.cli.main_al.main`` on a synthetic
   367-train / 101-val CamVid at 360x480 with ``--fused_ir --pallas_dw
   --n_pixels_by_us 10 --max_budget 20`` and 2 epochs per round (a dataset
   config overlay): two rounds. The warm epoch's train images/s, its
   device share (profiler), the train loader's images/s alone, validation
   images/s; the artifacts, 10 valid picks per image per round, finite
   losses, and the kernels' launches over the campaign;
8. micro-batch step (``--micro_batch_size``): at phase 6's weights, dropout
   off, SGD, the kernels on, a megabatch of 48 at micro 4 against 12
   sequential train steps on the same rows (every parameter and running
   statistic to phase 6's leaf limit; 12 x 13 fused launches), a remainder
   of 31 padded to 32 against 8 sequential steps on the padded rows, and a
   megabatch whose third micro-batch is all pad bit-equal to the first
   two alone; then ``main_al`` at ``--batch_size 48 --micro_batch_size 4``
   (a config overlay) for 3 epochs: 92 optimizer updates per epoch, the
   warm epoch's train images/s beside phase 7's bs-4 epoch, the device's
   busy time (profiler);
9. dense step: ``main_al --n_pixels_by_us 0`` for 2 epochs at bs 4 with the
   kernels: the ``fully_sup`` artifacts, finite losses, the fused
   launches, the warm epoch's images/s and peak device memory;
10. MC-dropout committee: phase 3's weights with ``--use_mc_dropout
   --mc_n_steps 20``, soft vote, margin sampling: a warm sweep of the pool
   (10 valid picks per image, none labelled or void, 14 x 20 depthwise
   launches per pool batch) timed against phase 3's warm sweep; one pool
   batch with the hard vote; at dropout p = 0 the committee's picks equal
   the plain sweep's;
11. train CLI with a resume: ``pixelpick_tpu_torch.cli.train.main`` on
   phase 4's human-labelled rounds (stage ``1_query``, 2 epochs,
   ``--fused_ir --pallas_dw --stage_ckpt_interval 1``, cuDNN's
   deterministic algorithms), (a) straight and (b) interrupted after 10
   updates of epoch 2 and rerun over the same directory: (b)'s final
   ``state_dict`` equal to (a)'s bit for bit, or else no further from it,
   leaf by leaf, than (c) a second straight run; the line says which held.
   The snapshot's save ms and bytes, the logs' rows (epochs 1-2 once), the
   snapshot gone, 13 fused launches per update, the warm epoch's images/s;
12. eval CLI: ``pixelpick_tpu_torch.cli.eval.main --pallas_dw`` on arm
   (a)'s ``best_miou_model.ckpt`` and on a JAX-layout msgpack file of the
   same weights (written by ``write_flax_checkpoint`` below; the card's
   machine has no flax): both confusion matrices equal, 14 depthwise
   launches per forward, the validation images/s; the torch file again
   with ``--fused_ir``, the stage's own model (its blocks' eval path keeps
   the library's depthwise, as JAX's does): the stage's best validation's
   confusion matrix exactly;
13. ``main_al --resume_campaign`` over phase 7's campaign (no update, no
   sweep, the same labelled pixels, the logs untouched), and ``main_al
   --pretrained_ckpt`` with phase 12's msgpack file for one ``--debug``
   round: round 0's weights before its first update are the file's;
14. device augmentation: ``main_al --device_augment`` at ``--batch_size 48
   --micro_batch_size 4`` (phase 8's configuration) for 3 epochs and one
   round, then phase 8's host-loader run again for 2 epochs, so that the
   host loader and the device pipeline run in turns in one call: 92
   updates per epoch, no labelled pixel dropped (overflow 0), 13 fused
   launches of each kind per update, the warm epochs' train images/s, the
   device's busy share (profiler), the staged bytes, the pipeline's
   device ms per batch of 48 (CUDA events) and its host ms to enqueue
   one; the card's pipeline against its CPU run on the same draws, with
   TF32 on in the process (``pipeline_card_vs_cpu``);
15. Cityscapes: a synthetic 1024x2048 ``leftImg8bit/``/``gtFine/`` tree
   (50 train, 6 val images, labelIds 0-33), and ``main_al --dataset_name
   cs --device_augment`` at bs 48 / micro 4 for 2 epochs and one round
   with its sweep, which builds the ds-4 train and ds-2 val caches: every
   cached label in 0-19, 10 picks per image and none void, 13 updates per
   epoch and their launches;
16. VOC: a synthetic ``VOCdevkit/VOC2012`` tree (100 train, 20 val JPEGs
   at 375x500, 500x375, 333x500 and 500x500; palette-mode labels 0-20 in
   64x64 blocks with void borders), and ``main_al --dataset_name voc
   --fused_ir --pallas_dw`` at bs 10 with 320x320 crops, 3 epochs and one
   round with its sweep, validation and sweep in shape buckets: 10
   non-void picks per image inside the image, 13 fused launches of each
   kind and one depthwise dx per update; the warm epoch's train images/s,
   device ms per step and busy share (profiler), peak device memory, the
   sweep's and validation's images/s;
17. FPN: ``main_al --network_name FPN --n_layers 50`` (dilated ResNet-50)
   on phase 16's tree, the same measures; the eval CLI on its best
   checkpoint (the stage's best mIoU again); a ``--debug`` round with
   ``--pretrained_ckpt`` from a file that the port's convert CLI wrote
   from a random torchvision-layout ResNet-50: every encoder entry
   overlaid;
18. VOC with ``--device_augment``: phase 16's round with the train set
   staged on the card, padded to the largest base-resized size beside each
   image's true size; the same measures beside phase 16's host loader, the
   kernels' launches, the staged bytes, the pipeline's device and host ms
   per batch of 10, and the card's pipeline against its CPU run on a padded
   remainder (``pipeline_card_vs_cpu``);
19. data parallelism: two ranks on the one card over gloo (``python3
   chip_smoke.py --worker JOB`` each): a full-width bs-8 step with
   ``--pallas_dw``, 4 rows per rank, held to the single-process step (the
   loss and every gradient to phase 6's limits, the running statistics,
   the confusion matrices exactly; the depthwise launches of every rank);
   ``main_al`` as two ranks, 1 epoch and 2 rounds at bs 8 on a 48-image
   CamVid, every artifact written once; an NCCL world of one through
   ``init_process_group``. A rank that fails fails the run;
20. the TPU-only rewrites of the default math at full width: a bs-4 step
   with ``--s2d_backbone --conv3x3_matmul --fused_ir --pallas_dw`` at phase
   6's weights against the library path (phase 6's limits; 12 + 12 fused
   launches, block 2 running s2d), the same step with ``remat_blocks``
   against the plain build, and a ``--s2d_backbone --pallas_dw`` sweep
   over phase 3's pool against phase 3's path (pick sets, near-ties at the
   top-k boundary set aside; 12 depthwise launches per forward); the
   rewritten step's ms and the s2d sweep's images/s and busy share beside
   phases 6 and 3;
21. ``--spatial_query_sharding``: two ranks on the one card over gloo
   (``--worker``), through the entry points at full width with
   ``--pallas_dw``: the query CLI over the first 64 images of phase 3's
   pool (360x480, phase 3's weights) and over 8 images of 1024x2048 at
   pool batch 4, each held to the same command without the flag in one
   process (pick sets, near-ties at the top-k boundary set aside), 14
   depthwise launches per forward on every rank, on stripes, each rank's
   peak device memory beside the single process's, the time inside the
   collectives; ``main_al`` with the flag for one round on a 48-image
   CamVid (the step sharded by images, the sweep by rows, every file
   written once); and the kernel on each rank's halo-padded stripes of
   the 14 inputs against its plain version and the whole map's rows,
   each rank's inputs checked to be those stripes;
22. JAX orbax checkpoints and JAX stage snapshots, with neither orbax nor
   tensorstore on the machine: the committed JAX-written orbax fixture
   (``tests/torch_fixtures/jax_orbax/``, OCDBT and zstd) decoded and every
   leaf's sha256 checked; one ``--debug`` round of ``main_al --fused_ir
   --pallas_dw --ckpt_backend orbax --stage_ckpt_interval 1`` (the step
   directory alone, no tmp left; two more saves number on and prune as
   JAX's do; a full-width save and load timed), then the query CLI with
   ``--pallas_dw`` from that directory and from a torch file of the same
   weights (the same ``state_dict`` and picks, 14 launches per forward);
   the round's epoch-1 snapshot rewritten in JAX's layout and resumed by
   ``main_al`` (model and optimizer bit-equal to the port's snapshot's;
   the stage's fused and depthwise launches counted);
23. ``--s2d_backbone`` under ``--spatial_query_sharding``: phase 21's two
   ranks and query CLI with blocks 0-3 in s2d layout on row stripes, over
   phase 21's 64 images of 360x480 (an even 1/4 map: 12 depthwise
   launches per forward on every rank, on stripes) and over 8 images of
   364x480 (the 1/4 map's 91 rows split 48 / 43: blocks 2-3 run the
   standard way on both ranks, 13 launches), each held to the same
   command with ``--s2d_backbone`` in one process (pick sets, near-ties
   at the top-k boundary set aside), each rank's peak device memory
   beside the single process's, the ranks' warm images/s and the time
   inside the collectives beside phase 21's; the kernel on each rank's
   halo-padded stripes of the 364x480 inputs against its plain version
   and the whole map's rows, and each rank's inputs in both parts checked
   to be the stripes held to the plain version (the 360x480 ones in phase
   21).

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. The details go to
``<out>/chip_smoke.json``. Weights are random, from a seed. In the kernels'
line, ``launches`` counts every main-path run: the depthwise kernel's
(forward and dx) over the sweeps of phases 3 and 10, the campaign of phase
7, the epoch runs of phases 8 and 9, the train CLI's runs of phase 11, the
eval CLI's of phase 12, the ``--pretrained_ckpt`` round of phase 13 and
the runs of phases 14, 15, 16 and 18, phase 19's, 21's and 23's ranks
(each counts in its own process and reports its counts), phase 20's
s2d step and sweep and phase 22's round, query CLI runs and resumed
stage; the fused kernels' over phases 7, 8, 9, 11, 13, 14, 15, 16 and
18, phase 20's s2d step and phase 22's round and resumed stage (their
counters zeroed just before each run and read just after). Phase 17's
path reaches none of them.
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
PEAK_BF16_FLOPS = 989e12  # dense tensor-core rate, the peak for bf16 inputs
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
SLEEP_CYCLES_PER_S = 2.0e9  # the sleep's clock, about the card's (1.98 GHz)
PORTED_KERNEL = "dw3x3_s1_nhwc"  # csrc/depthwise.cu's kernel, by name

# fused kernels vs plain: y relative to its largest |value| and the moments
# to theirs, as tests/test_fused_ir.py holds them. Each of the ten
# gradients relative to its own largest |value|, or to GRAD_FLOOR of the
# largest of the ten where its own is smaller (a near-zero gradient). f32:
# 1e-4, on the entries that no ReLU6 input within KINK_CLEARANCE of 0 or 6
# reaches (kink_masks). bf16: 4e-2, or twice how far the plain version
# itself moves between bf16 and f32 on the same inputs where that is more
FUSED_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
FUSED_GRAD_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
FUSED_STATS_TOL = {"float32": 1e-5, "bfloat16": 4e-2}
GRAD_FLOOR = 1e-3
KINK_CLEARANCE = 4e-6
# train step, kernels vs library path, f32, on weights and images chosen so
# that few ReLU inputs lie near a kink and no BatchNorm cancels
# (well_conditioned_): the loss relative; each parameter gradient relative
# to its own largest |value| plus STEP_GRAD_FLOOR of the largest |gradient|
# (the floor holds the leaves whose true gradient is zero to their rounding
# noise). A ReLU input within rounding of its kink still occurs where a
# zero-padded border meets those positive activations (on an H100: 1.7e-5
# from it, in block 0), and the other branch moves the leaves that read it
# by a few pixels' worth of the 23x30 maps, each 1/2760 of their scale (on
# an H100: up to 6.5e-4, in block 17); a wrong gradient in one block moves
# its leaves by its own size
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_GRAD_FLOOR = 1e-5, 2e-3, 1e-5

GRAD_NAMES = ("dx", "dwe", "dwd", "dwp", "dg1", "db1", "dg2", "db2", "dg3",
              "db3")

N_IMAGES, IMAGE_HW, POOL_BATCH, N_CLASSES, VOID = 367, (360, 480), 32, 11, 11
N_VAL, TRAIN_BATCH = 101, 4
DEVICE = "cuda"
# the VOC path (phases 2, 5, 16, 17): a query bucket of base-resized
# 500x375 images (300x400, padded to stride 8), the train crops and batch
# (voc.py, args.py:133-152), and the remainder batch of VOC's 1464 train
# images at batch 10
VOC_QUERY_HW, VOC_CROP_HW, VOC_BATCH, VOC_REMAINDER = (304, 400), (320, 320), \
    10, 1464 % 10


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
    # the host's time to enqueue one call: the sleep must outlast enqueueing
    # all of them, or a function of many small launches is timed at the
    # host's pace
    t0 = time.perf_counter()
    fn(*inputs[0])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(max(SLEEP_CYCLES,
                          int(2 * reps * host_s * SLEEP_CYCLES_PER_S)))
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

    from pixelpick_tpu_torch.ops import build, depthwise as dw, fused_ir

    smi = nvidia_smi_line()
    print(f"[1] card: {smi}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}, "
          f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    libs = build.build_all(["depthwise", "fused_ir"])
    dw._library()
    fused_ir._library()
    build_s = time.perf_counter() - t0
    for name, so in libs.items():
        print(f"[1] built {so.relative_to(HERE)} (in {build_s:.2f} s for "
              f"both, in parallel)")
        log = so.with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1] ptxas {name}: {line.strip()}")
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
            "build_s": build_s}


# ------------------------------ phase 2 ------------------------------

def main_path_dw_shapes(model, batch: int, hw=IMAGE_HW) -> list:
    """The (x shape, dilation) of every kernel launch of one forward of
    ``model`` on a (batch, *hw) input, recorded at the wrapper."""
    import torch

    from pixelpick_tpu_torch.ops import depthwise as dw

    seen = []
    launch = dw._launch_kernel

    def spy(x, w, dilation, counter="kernel"):
        seen.append((tuple(x.shape), dilation))
        return launch(x, w, dilation, counter)

    dw._launch_kernel = spy
    try:
        with torch.no_grad():
            model(torch.zeros((batch, *hw, 3), device=DEVICE),
                  upsample=False)
        torch.cuda.synchronize()
    finally:
        dw._launch_kernel = launch
    return seen


def expected_dw_shapes(batch: int, hw=IMAGE_HW) -> list:
    """The stride-1 depthwise inputs that the MobileNetV2 plan implies
    (os 16, width 1.0): the (fixed-)padded block input after expansion."""
    from pixelpick_tpu_torch.models.mobilenet_v2 import block_plan

    plan, _ = block_plan(16, 1.0)
    h, w = hw[0] // 2, hw[1] // 2  # after the stride-2 stem
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
    # the VOC path's shapes, f32: one query forward over a pool batch of a
    # bucket, and one forward of a train batch of crops (whose first
    # launch, block 0's, is the one a --fused_ir train step makes, forward
    # and dx)
    results["voc"] = []
    for batch, hw in ((POOL_BATCH, VOC_QUERY_HW), (VOC_BATCH, VOC_CROP_HW)):
        seen = main_path_dw_shapes(model, batch, hw)
        check(seen == expected_dw_shapes(batch, hw),
              f"VOC launches {seen} differ from the plan's")
        for i, (shape, d) in enumerate(seen):
            r = measure_dw_shape(shape, d, torch.float32, seed=200 + i)
            results["voc"].append(r)
            print(f"[2] voc float32 x{tuple(shape)} d={d}: err "
                  f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
            check(r["ok"], f"kernel disagrees with its plain version at "
                           f"VOC {shape} d={d}: {r['max_abs_err']}")
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

def make_synthetic_camvid(root: Path, n: int, n_val: int = 0,
                          seed: int = 0, hw=IMAGE_HW) -> None:
    """CamVid layout: {root}/train/*.png RGB and {root}/trainannot/*.png
    labels 0..10 with void 11 (and ``n_val`` more under test/, testannot/),
    images of ``hw`` in 30x40-pixel tiles; images are a colour per class
    plus noise."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (N_CLASSES + 1, 3))
    h, w = hw
    for split, count in (("train", n), ("test", n_val)):
        (root / split).mkdir(parents=True)
        (root / f"{split}annot").mkdir(parents=True)
        for i in range(count):
            tiles = rng.integers(0, N_CLASSES, (-(-h // 30), -(-w // 40)))
            tiles[rng.random(tiles.shape) < 0.05] = VOID
            lab = np.repeat(np.repeat(tiles, 30, 0), 40, 1)[:h, :w].astype(
                np.uint8)
            img = palette[lab] + rng.integers(-20, 21, (h, w, 3))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                root / split / f"{i:04d}.png", compress_level=1)
            Image.fromarray(lab).save(root / f"{split}annot" / f"{i:04d}.png",
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
    busy, busy_us, by_name = device_busy(prof, traced_s)
    parsed, parsed_us = device_busy_parsed(prof, traced_s)
    ours_ms = sum(t for name, (t, _) in by_name.items()
                  if PORTED_KERNEL in name) / 1e3
    print(f"[3] warm sweep (images decoded): {warm_s:.3f} s = "
          f"{N_IMAGES / warm_s:.1f} images/s; under the profiler "
          f"{traced_s:.3f} s, device busy "
          + (f"{100 * busy:.1f}%, of which {ours_ms:.3f} ms in "
             f"{PORTED_KERNEL}" if busy is not None else "not measured (the "
             "profiler saw no device activity)")
          + (f"; from prof.events() on the same trace {100 * parsed:.1f}% "
             f"({parsed_us / 1e3:.3f} ms against {busy_us / 1e3:.3f})"
             if parsed is not None else ""))
    top = print_top("[3]", by_name)
    return {"warm_s": warm_s, "images_per_s": N_IMAGES / warm_s,
            "traced_s": traced_s, "device_busy_share": busy,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share_events_parse": parsed,
            "device_busy_ms_events_parse": parsed_us / 1e3,
            "ported_kernel_ms": ours_ms, "top_device_ms": top}


def device_busy(prof, wall_s: float):
    """From a ``torch.profiler`` trace: the share of ``wall_s`` in which the
    device ran anything (the union of its kernels' intervals; None when the
    trace holds no device activity), that busy time in us, and
    {kernel name: (us, launches)}. It reads the profiler's raw device
    events, the ones ``prof.events()`` is parsed from: that parse builds
    every host and device event of an epoch and took about a minute on a
    slow host."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns())
                    / 1e3, e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not getattr(e, "is_hidden_event", lambda: False)())
    by_name: dict = {}
    for s, e, name in spans:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s), n + 1)
    busy_us = union_us(spans)
    busy = busy_us / 1e6 / wall_s if spans else None
    return busy, busy_us, by_name


def union_us(spans) -> float:
    """The length of the union of sorted (start, end, ...) intervals."""
    busy_us, end = 0.0, float("-inf")
    for s, e, *_ in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy_us


def device_busy_parsed(prof, wall_s: float):
    """``device_busy``'s share and us from ``prof.events()``, the parse that
    earlier versions of this script read, for one comparison on phase 3's
    trace."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us = union_us(spans)
    return (busy_us / 1e6 / wall_s if spans else None), busy_us


def print_top(prefix: str, by_name: dict, n: int = 10) -> list:
    """Print and return the ``n`` kernels that took the most device time."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    for name, (us, count) in top:
        print(f"{prefix}   {us / 1e3:9.3f} ms {count:5d}x  {name[:90]}")
    return [{"name": k, "ms": v[0] / 1e3, "count": v[1]} for k, v in top]


# ------------------------------ phase 4 ------------------------------

def label_with_tools(work: Path, args, run: Path):
    """The oracle round's two query files labelled through the port's
    annotation tools, as an annotation team runs them, the synthetic
    ground truth answering: round 0's ``queries.pkl`` through the keyboard
    annotator head-less (``annotate_dataset(..., labels_from_gt=True)``),
    round 1's through the VIA round trip (``build_via_project``,
    ``write_project_js``, every point's ``av`` set to the key of its
    ground-truth class, ``convert_via_json``), each written to
    ``run/{nth}_query/queries.pkl``. Every queried pixel must come back
    with its ground-truth label, and ``serve`` must deliver the annotator
    page and the project over localhost. Returns the labelled pixels per
    image and the tools' measures."""
    import urllib.request

    from PIL import Image

    from pixelpick_tpu_torch.active import codec
    from pixelpick_tpu_torch.human import annotation, via
    from pixelpick_tpu_torch.utils.palettes import CV_LABEL_CATEGORY

    def ground_truth(p):
        return np.asarray(Image.open(
            Path(args.dir_dataset) / "trainannot" / Path(p).name))

    labelled, out = {}, {}
    for nth in (0, 1):
        with open(Path(args.dir_checkpoints) / f"{nth}_query" / "queries.pkl",
                  "rb") as f:
            queries = pkl.load(f)
        masks = codec.decode_queries(queries, return_as_dict=True)
        paths = list(masks)
        gts = [ground_truth(p) for p in paths]
        t0 = time.perf_counter()
        if nth == 0:
            imgs = [np.asarray(Image.open(p)) for p in paths]
            result = annotation.annotate_dataset(
                imgs, [masks[p] for p in paths], paths, CV_LABEL_CATEGORY,
                gt_labels=gts, dir_log=str(work / "annotation_logs"),
                labels_from_gt=True)
            logs = len(list((work / "annotation_logs").glob("*.txt")))
            check(logs == len(paths), f"{logs} annotation logs")
        else:
            keys = annotation.default_key_mapping(CV_LABEL_CATEGORY)
            key_of = {cid: k for k, cid in keys.items()}
            project = via.build_via_project(
                queries, {k.upper(): CV_LABEL_CATEGORY[cid]
                          for k, cid in keys.items()})
            served = work / "via"
            served.mkdir()
            js = via.write_project_js(project,
                                      str(served / "via_debug_project.js"))
            gt_of = dict(zip(paths, gts))
            for md in project["metadata"].values():
                p = project["file"][md["vid"]]["src"]
                md["av"] = {"1": key_of[int(gt_of[p][md["xy"][2],
                                                     md["xy"][1]])]}
            result = via.convert_via_json(
                json.loads(json.dumps(project)),
                {k: CV_LABEL_CATEGORY[cid] for k, cid in keys.items()},
                keys, image_sizes={p: IMAGE_HW for p in paths},
                verbose=False)
            httpd = via.serve(str(served), port=0, open_browser=False,
                              block=False)
            try:
                base = f"http://localhost:{httpd.server_port}"
                page = urllib.request.urlopen(
                    f"{base}/via_pixelpick_annotator.html", timeout=30).read()
                body = urllib.request.urlopen(
                    f"{base}/via_debug_project.js", timeout=30).read()
            finally:
                httpd.shutdown()
                httpd.server_close()
            with open(via.annotator_asset_path(), "rb") as f:
                check(page == f.read() and b"draw_pixelpick" in page,
                      "serve did not deliver the annotator page")
            with open(js, "rb") as f:
                check(body == f.read() and body.startswith(b"_via_dp = "),
                      "serve did not deliver the project")
            out["via_points"] = len(project["metadata"])
            out["served_bytes"] = len(page) + len(body)
        out[f"round_{nth}_s"] = time.perf_counter() - t0
        check(sorted(result) == sorted(paths),
              f"round {nth}: {len(result)} of {len(paths)} images labelled")
        n = 0
        for p, gt in zip(paths, gts):
            rec = result[p]
            ys, xs = np.asarray(rec["y_coords"]), np.asarray(rec["x_coords"])
            picked = np.zeros(IMAGE_HW, bool)
            picked[ys, xs] = True
            check(len(ys) == int(masks[p].sum())
                  and np.array_equal(picked, masks[p]),
                  f"round {nth}, {p}: the labelled pixels are not the "
                  f"queried ones")
            check(rec["category_id"] == gt[ys, xs].astype(int).tolist(),
                  f"round {nth}, {p}: a label differs from the ground truth")
            n += len(ys)
            labelled.setdefault(Path(p).name, np.zeros(IMAGE_HW, bool))[
                ys, xs] = True
        out[f"round_{nth}_pixels"] = n
        (run / f"{nth}_query").mkdir(parents=True)
        with open(run / f"{nth}_query" / "queries.pkl", "wb") as f:
            pkl.dump(result, f)
    print(f"[4] labelled through the tools: round 0 by the annotator "
          f"head-less ({out['round_0_pixels']} pixels, "
          f"{out['round_0_s']:.2f} s), round 1 through the VIA round trip "
          f"({out['via_points']} points, {out['round_1_s']:.2f} s, "
          f"{out['served_bytes']} bytes served over localhost); every "
          f"label equals the ground truth")
    return labelled, out


def phase_human_cli(work: Path, model, args) -> dict:
    from pixelpick_tpu_torch.active import codec
    from pixelpick_tpu_torch.cli.query import main as query_main
    from pixelpick_tpu_torch.engine.checkpoint import save_checkpoint
    from pixelpick_tpu_torch.ops import depthwise as dw

    run = work / "human"
    labelled, tools = label_with_tools(work, args, run)
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
            "launches": counts, "tools": tools}



# ------------------------------ phase 5 ------------------------------

def fused_block_shapes(batch: int, hw=IMAGE_HW) -> list:
    """(B, H, W, Cin, Cout, dilation) of the 13 stride-1 t=6 blocks of one
    train step at ``hw`` (os 16, width 1.0), in order."""
    from pixelpick_tpu_torch.models.mobilenet_v2 import block_plan

    plan, _ = block_plan(16, 1.0)
    h, w = hw[0] // 2, hw[1] // 2  # after the stride-2 stem
    shapes = []
    for inp, oup, stride, d, t in plan:
        if stride == 2:
            h, w = (h + 2 * d - 3) // 2 + 1, (w + 2 * d - 3) // 2 + 1
        elif t != 1:
            shapes.append((batch, h, w, inp, oup, d))
    return shapes


def fused_inputs(b, h, w, cin, cout, dtype, seed):
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    ch = 6 * cin

    def rn(*shape, scale=1.0):
        return torch.randn(shape, device=DEVICE, generator=g) * scale

    x = rn(b, h, w, cin).to(dtype)
    # the two ReLU6 BatchNorms' biases in [1, 2]: the kink at 0 sits in the
    # tail of their outputs, not at its mode, so few inputs lie near it, and
    # both sides of both kinks still occur. The depthwise taps and the
    # projection's columns sum to zero, so the products of those positive
    # activations stay centred and their fast variances do not cancel
    wd, wp = rn(3, 3, ch, scale=1 / 3), rn(ch, cout, scale=ch ** -0.5)
    weights = [rn(cin, ch, scale=cin ** -0.5).to(dtype),
               (wd - wd.mean((0, 1))).to(dtype), (wp - wp.mean(0)).to(dtype)]
    for c, lo in ((ch, 1.0), (ch, 1.0), (cout, None)):
        weights += [0.5 + torch.rand(c, device=DEVICE, generator=g),
                    0.1 * rn(c) if lo is None
                    else lo + torch.rand(c, device=DEVICE, generator=g)]
    return x, tuple(weights), rn(b, h, w, cout).to(dtype)


def library_block(x, weights, d: int, use_res: bool):
    """The block from library calls over one ghost-BN group (the batch):
    1x1 and grouped ``F.conv2d``, ``F.batch_norm(training=True)``,
    ``F.hardtanh``, in eager PyTorch; NCHW out. A yardstick only: no single
    PyTorch call computes a fused block."""
    import torch.nn.functional as F

    we, wd, wp, g1, b1, g2, b2, g3, b3 = weights
    xc = x.permute(0, 3, 1, 2)
    h = F.conv2d(F.pad(xc, (d, d, d, d)), we.t()[:, :, None, None])
    h = F.hardtanh(F.batch_norm(h, None, None, g1, b1, training=True), 0, 6)
    h = F.conv2d(h, wd.permute(2, 0, 1)[:, None], dilation=d,
                 groups=h.shape[1])
    h = F.hardtanh(F.batch_norm(h, None, None, g2, b2, training=True), 0, 6)
    h = F.batch_norm(F.conv2d(h, wp.t()[:, :, None, None]), None, None, g3,
                     b3, training=True)
    return xc + h if use_res else h


def relu6_inputs(x, weights, group: int, d: int):
    """The inputs of the block's two ReLU6s in the plain forward, per group:
    over the padded domain (B, H + 2d, W + 2d, Ch) and the image."""
    import torch

    from pixelpick_tpu_torch.ops import fused_ir

    we, wd, _, g1, b1, g2, b2, _, _ = weights
    u1s, u2s = [], []
    for i in range(0, x.shape[0], group):
        u1 = fused_ir.stage1_pre(x[i:i + group], we, g1, b1, d)[0]
        u1s.append(u1)
        u2s.append(fused_ir.stage2_pre(u1.clamp(0, 6), wd, g2, b2, d)[0])
    return torch.cat(u1s), torch.cat(u2s)


def kink_masks(x, weights, group: int, d: int):
    """Where the gradients may take another branch than the plain version's.
    A ReLU6 input within KINK_CLEARANCE of 0 or 6 can land on either side
    of the kink under another summation order, and every gradient that
    reads it then moves by that element's whole contribution: a different
    branch, not a rounding error (block 2 at batch 4 has 13M ReLU6 inputs,
    about ten within 4e-6 of a kink). Such an input at hidden channel c reaches
    the gradients of channel c (we's column, wd's taps, both BatchNorms'
    parameters) and dx at the pixels that read it (its own for the first
    ReLU6, the 3x3 taps around it for the second). Returns (the pixels and
    channels no such input reaches, the count of such inputs)."""
    import torch.nn.functional as F

    u1, u2 = relu6_inputs(x, weights, group, d)
    near = [(u.float().abs() < KINK_CLEARANCE)
            | ((u.float() - 6).abs() < KINK_CLEARANCE) for u in (u1, u2)]
    taps = F.max_pool2d(F.pad(near[1].any(-1)[:, None].float(), (d,) * 4),
                        3, 1, 0, d)[:, 0]
    keep_p = ~(near[0].any(-1)[:, d:-d, d:-d] | (taps > 0))
    keep_c = ~(near[0].flatten(0, 2).any(0) | near[1].flatten(0, 2).any(0))
    return keep_p, keep_c, sum(int(n.sum()) for n in near)


def held(grads, keep_p, keep_c) -> list:
    """The entries of the ten gradients that ``kink_masks`` leaves."""
    dx, dwe, dwd, dwp, dg1, db1, dg2, db2, dg3, db3 = grads
    return [dx[keep_p], dwe[:, keep_c], dwd[:, :, keep_c], dwp, dg1[keep_c],
            db1[keep_c], dg2[keep_c], db2[keep_c], dg3, db3]


def grad_errors(grads, ref, gmax: float) -> dict:
    """Per gradient, the largest |difference| over the larger of its own
    largest |value| and GRAD_FLOOR * gmax."""
    out = {}
    for n, a, r in zip(GRAD_NAMES, grads, ref):
        if r.numel() == 0:
            out[n] = 0.0
            continue
        scale = max(float(r.float().abs().max()), GRAD_FLOOR * gmax)
        out[n] = float((a.float() - r.float()).abs().max()) / scale
    return out


def measure_fused(shape, group: int, dtype, seed: int, timed: bool) -> dict:
    import torch

    from pixelpick_tpu_torch.ops import fused_ir

    b, h, w, cin, cout, d = shape
    x, weights, dy = fused_inputs(b, h, w, cin, cout, dtype, seed)
    use_res = cin == cout
    args = (group, d, use_res)
    y, stats, state = fused_ir.fused_fwd_kernel(x, weights, *args)
    saved = state.work.clone()
    grads = fused_ir.fused_bwd_kernel(x, dy, weights, *args, state=state)
    y2, stats2, _ = fused_ir.fused_fwd_kernel(x, weights, *args)
    # the backward only reads the saved state: a second call on it gives
    # the same bits and leaves its bytes as they were
    grads2 = fused_ir.fused_bwd_kernel(x, dy, weights, *args, state=state)
    torch.cuda.synchronize()
    state_kept = torch.equal(saved, state.work)
    del saved
    bit_equal = (torch.equal(y, y2)
                 and all(torch.equal(a, c) for a, c in zip(stats, stats2))
                 and all(torch.equal(a, c) for a, c in zip(grads, grads2)))
    y_ref, stats_ref = fused_ir.fused_fwd_plain(x, weights, *args)
    grads_ref = fused_ir.fused_bwd_plain(x, dy, weights, *args)

    def err(a, r):
        return float((a.float() - r.float()).abs().max())

    name = str(dtype).replace("torch.", "")
    y_scale = float(y_ref.float().abs().max())
    gmax = max(float(r.float().abs().max()) for r in grads_ref)
    y_err = err(y, y_ref)
    stat_rel = max(err(a, r) / max(float(r.abs().max()), 1e-30)
                   for a, r in zip(stats, stats_ref))
    grad_tol = dict.fromkeys(GRAD_NAMES, FUSED_GRAD_TOL[name])
    bf16_drift = kinks = None
    if dtype == torch.float32:
        keep_p, keep_c, n_near = kink_masks(x, weights, group, d)
        kinks = {"near": n_near, "pixels_held": int(keep_p.sum()),
                 "pixels": keep_p.numel(), "channels_held": int(keep_c.sum()),
                 "channels": keep_c.numel()}

        def judged(gs):
            return held(gs, keep_p, keep_c)
    else:  # the plain version's own bf16 error
        def judged(gs):
            return gs
        f32 = fused_ir.fused_bwd_plain(
            x.float(), dy.float(), tuple(t.float() for t in weights), *args)
        bf16_drift = grad_errors(grads_ref, f32, gmax)
        grad_tol = {n: max(t, 2 * bf16_drift[n]) for n, t in grad_tol.items()}
    ref_held = judged(grads_ref)
    grad_errs = grad_errors(judged(grads), ref_held, gmax)

    def grads_pass(gs):
        errs = grad_errors(judged(gs), ref_held, gmax)
        return all(errs[n] <= grad_tol[n] for n in GRAD_NAMES)

    # controls the judge must refuse: dx zeroed, and in f32 the expand
    # weight's gradient 5% too large
    controls = [[torch.zeros_like(grads[0]), *grads[1:]]]
    if dtype == torch.float32:
        controls.append([grads[0], grads[1] * 1.05, *grads[2:]])
    controls_fail = not any(grads_pass(c) for c in controls)
    ok = (y_err <= FUSED_TOL[name] * y_scale
          and stat_rel <= FUSED_STATS_TOL[name]
          and grads_pass(grads) and bit_equal and state_kept
          and controls_fail)
    item = x.element_size()
    fwd_flops, bwd_flops = fused_ir.block_flops(b, h, w, cin, 6 * cin, cout,
                                                d)
    wbytes = sum(t.numel() * t.element_size() for t in weights)
    fwd_bytes = (x.numel() + y.numel()) * item + wbytes \
        + sum(t.numel() * 4 for t in stats)
    # the backward reads x, dy, the weights and the forward's saved h1
    # (padded), h2 and h3, and writes dx and the nine gradients
    saved_elems = b * (h + 2 * d) * (w + 2 * d) * 6 * cin \
        + b * h * w * (6 * cin + cout)
    bwd_bytes = (2 * x.numel() + dy.numel() + saved_elems) * item + wbytes \
        + sum(t.numel() * 4 for t in weights)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    r = {"shape": list(shape), "group": group, "dtype": name,
         "y_max_abs_err": y_err, "y_max_abs": y_scale,
         "stats_max_rel_err": stat_rel,
         "grad_max_abs_err": max(err(a, r) for a, r in zip(grads, grads_ref)),
         "grad_max_abs": gmax, "grad_rel_err": grad_errs,
         "grad_own_max": {n: float(r.float().abs().max()) / gmax
                          for n, r in zip(GRAD_NAMES, grads_ref)},
         "grad_tol": grad_tol, "grad_worst": max(
             grad_errs[n] / grad_tol[n] for n in GRAD_NAMES),
         "plain_bf16_drift": bf16_drift, "controls_fail": controls_fail,
         "relu6_inputs_near_kinks": kinks,
         "bit_equal": bit_equal, "state_unchanged": state_kept, "ok": ok,
         "fwd_flops": fwd_flops, "bwd_flops": bwd_flops,
         "fwd_bytes": fwd_bytes, "bwd_bytes": bwd_bytes}
    for k, fl, by in (("fwd", fwd_flops, fwd_bytes),
                      ("bwd", bwd_flops, bwd_bytes)):
        t_bytes = by / PEAK_BYTES_PER_S * 1e3
        t_ops = fl / peak * 1e3
        r[f"{k}_bound_ms"] = max(t_bytes, t_ops)
        r[f"{k}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if not timed:
        return r
    copies = cold_copies(x)
    r["fwd_ms"] = time_ms(
        lambda a: fused_ir.fused_fwd_kernel(a, weights, *args),
        [(xc,) for xc in copies])
    del state
    # each copy of x with the state its own forward left, so that the
    # backward reads the saved tensors from device memory too
    inputs = [(xc, fused_ir.fused_fwd_kernel(xc, weights, *args)[2])
              for xc in copies]
    r["bwd_ms"] = time_ms(
        lambda a, st: fused_ir.fused_bwd_kernel(a, dy, weights, *args,
                                                state=st), inputs)
    del inputs
    if dtype != torch.float32:
        return r
    inputs = [(xc,) for xc in copies]
    r["plain_fwd_ms"] = time_ms(
        lambda a: fused_ir.fused_fwd_plain(a, weights, *args), inputs,
        reps=3, warmup=1)
    r["plain_bwd_ms"] = time_ms(
        lambda a: fused_ir.fused_bwd_plain(a, dy, weights, *args), inputs,
        reps=3, warmup=1)
    if group == b:
        with torch.no_grad():
            r["library_fwd_ms"] = time_ms(
                lambda a: library_block(a, weights, d, use_res), inputs)
        # like for like: the backward kernel's function starts from the
        # forward's saved state, so the library's backward is timed alone,
        # on graphs built beforehand, one per copy of x
        leaves = [t.detach().requires_grad_() for t in weights]
        dyc = dy.permute(0, 3, 1, 2)
        graphs = []
        for xc in copies:
            a = xc.detach().requires_grad_()
            graphs.append((library_block(a, leaves, d, use_res), a))
        r["library_bwd_ms"] = time_ms(
            lambda out, a: torch.autograd.grad(out, [a, *leaves], dyc,
                                               retain_graph=True), graphs)
    return r


def phase_fused_kernels() -> dict:
    import torch

    # the library-built block's convolutions in strict f32, as the kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    results = {"float32": [], "bfloat16": [], "remainder": [], "ragged": []}
    failures = []  # every shape is measured before the phase fails

    def judge(r, what):
        if not r["ok"]:
            failures.append(what)
            print(f"[5] FAILED {what}: {r}")

    main = fused_block_shapes(TRAIN_BATCH)
    check(len(main) == 13, f"{len(main)} fused blocks in the plan")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for i, shape in enumerate(main):
            r = measure_fused(shape, TRAIN_BATCH, dtype, seed=i, timed=True)
            results[name].append(r)
            print(f"[5] {name:8s} block x{tuple(shape)}: y err "
                  f"{r['y_max_abs_err']:.3g}/{r['y_max_abs']:.3g}, worst "
                  f"gradient at {r['grad_worst']:.3g} of its tolerance, "
                  f"ReLU6 inputs near a kink {r['relu6_inputs_near_kinks']}, "
                  f"controls refused {r['controls_fail']}, "
                  f"bit-equal {r['bit_equal']}, saved state unchanged "
                  f"{r['state_unchanged']}; fwd {r['fwd_ms']:.4f} ms "
                  f"(bound {r['fwd_bound_ms']:.4f}, plain "
                  f"{r.get('plain_fwd_ms', float('nan')):.3f}, library "
                  f"{r.get('library_fwd_ms', float('nan')):.4f}), bwd "
                  f"{r['bwd_ms']:.4f} ms (bound {r['bwd_bound_ms']:.4f}, "
                  f"plain {r.get('plain_bwd_ms', float('nan')):.3f}, library "
                  f"{r.get('library_bwd_ms', float('nan')):.4f})")
            judge(r, f"{name} block {shape}")
        # the epoch's remainder batch of 3 runs every block with group 3
        for i, shape in enumerate(main):
            rem = (3, *shape[1:])
            r = measure_fused(rem, 3, dtype, seed=50 + i, timed=False)
            results["remainder"].append(r)
            judge(r, f"{name} remainder {rem}")
        worst = max(r["grad_worst"] for r in results["remainder"][-13:])
        print(f"[5] {name}: the 13 blocks at the remainder batch of 3, worst "
              f"gradient at {worst:.3g} of its tolerance")
    # VOC's train step: the 13 blocks at batch 10 on 320x320 crops (one
    # ghost-BN group of 10; 40x40 to 20x20 maps), f32 timed and bf16, and
    # the remainder batch of 4, f32
    results["voc"], results["voc_bf16"], results["voc_remainder"] = [], [], []
    for i, shape in enumerate(fused_block_shapes(VOC_BATCH, VOC_CROP_HW)):
        for key, b, dtype, timed in (
                ("voc", VOC_BATCH, torch.float32, True),
                ("voc_bf16", VOC_BATCH, torch.bfloat16, False),
                ("voc_remainder", VOC_REMAINDER, torch.float32, False)):
            shp = (b, *shape[1:])
            r = measure_fused(shp, b, dtype, seed=200 + i, timed=timed)
            results[key].append(r)
            judge(r, f"VOC {key} {shp}")
        r = results["voc"][-1]
        print(f"[5] voc float32 block x{tuple(shape)}: y err "
              f"{r['y_max_abs_err']:.3g}/{r['y_max_abs']:.3g}, worst "
              f"gradient at {r['grad_worst']:.3g} of its tolerance (bf16 "
              f"{results['voc_bf16'][-1]['grad_worst']:.3g}, remainder "
              f"{results['voc_remainder'][-1]['grad_worst']:.3g}); fwd "
              f"{r['fwd_ms']:.4f} ms (bound {r['fwd_bound_ms']:.4f}, "
              f"library {r.get('library_fwd_ms', float('nan')):.4f}), bwd "
              f"{r['bwd_ms']:.4f} ms (bound {r['bwd_bound_ms']:.4f}, "
              f"library {r.get('library_bwd_ms', float('nan')):.4f})")
    # ragged: 1, 2, 3 and 12 groups (batch 48 in ghost-BN groups of 4), odd
    # sizes, channels off the 32/64 tiles
    extras = [((8, 23, 30, 64, 64, 1), 4), ((8, 11, 13, 20, 28, 1), 4),
              ((6, 7, 9, 24, 24, 2), 2), ((3, 5, 7, 40, 40, 3), 3),
              ((2, 9, 10, 16, 24, 1), 1), ((48, 5, 6, 16, 16, 1), 4)]
    for i, (shape, group) in enumerate(extras):
        for dtype in (torch.float32, torch.bfloat16):
            r = measure_fused(shape, group, dtype, seed=100 + i, timed=False)
            results["ragged"].append(r)
            print(f"[5] ragged {r['dtype']} x{shape} group {group}: y err "
                  f"{r['y_max_abs_err']:.3g}, worst gradient at "
                  f"{r['grad_worst']:.3g} of its tolerance, bit-equal "
                  f"{r['bit_equal']}")
            judge(r, f"ragged {shape} group {group} {r['dtype']}")
    check(not failures, f"fused kernels disagree with their plain versions "
                        f"at {failures}")
    return results


# ------------------------------ phase 6 ------------------------------

def relu_batchnorms(model) -> list:
    """(name, module) of the BatchNorms whose outputs feed a ReLU: all but
    the blocks' projections."""
    from pixelpick_tpu_torch.models import layers
    from pixelpick_tpu_torch.models.mobilenet_v2 import InvertedResidual

    projections = {
        id([m for m in block.conv if isinstance(m, layers.BatchNorm)][-1])
        for block in model.modules() if isinstance(block, InvertedResidual)}
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, layers.BatchNorm) and id(m) not in projections]


def well_conditioned_(model, seed: int) -> None:
    """Weights at which f32 rounding moves no ReLU input across a kink and
    no BatchNorm through a cancellation: every BatchNorm that feeds a ReLU
    with scale in [0.15, 0.3] and bias in [2.5, 3.5] (its outputs 8
    standard deviations or more from 0 and 6), every conv's taps minus
    their mean over its inputs (a conv of those positive activations is
    centred). At a random
    init the ReLU kinks sit in the middle of the activations, and the
    gradients of two summation orders differ by whole elements."""
    import torch

    from pixelpick_tpu_torch.models import layers

    g = torch.Generator().manual_seed(seed)
    # the blocks' projection BatchNorms feed no ReLU but the residual
    # stream: centred, so that the stream stays centred too
    relu = {id(m) for _, m in relu_batchnorms(model)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.BatchNorm):
                c = m.weight.shape[0]
                if id(m) not in relu:
                    m.weight.copy_(0.5 + 0.5 * torch.rand(c, generator=g))
                    m.bias.copy_(0.2 * torch.rand(c, generator=g) - 0.1)
                else:
                    m.weight.copy_(0.15 + 0.15 * torch.rand(c, generator=g))
                    m.bias.copy_(2.5 + torch.rand(c, generator=g))
            elif getattr(m, "weight", None) is not None \
                    and m.weight.dim() == 4:
                m.weight.sub_(m.weight.mean((1, 2, 3), keepdim=True))


def train_batch(rng, n: int, k: int = 10, hw=IMAGE_HW) -> dict:
    """A host batch of ``n`` sparse-label train rows: images of distinct
    content (a 24x24-pixel random mosaic plus noise, at a contrast and
    brightness of their own, so that ASPP's pooled branch varies across the
    batch) and ``k`` valid random picks each."""
    mosaic = np.kron(rng.uniform(-1, 1, (n, hw[0] // 24, hw[1] // 24, 3)),
                     np.ones((1, 24, 24, 1)))
    images = (rng.uniform(30, 120, (n, 1, 1, 3)) * mosaic
              + rng.uniform(60, 200, (n, 1, 1, 3))
              + rng.normal(0, 10, mosaic.shape))
    return {
        "x": np.clip(images, 0, 255).astype(np.uint8),
        "coords": np.stack([rng.integers(0, hw[0], (n, k)),
                            rng.integers(0, hw[1], (n, k))], -1),
        "labels": rng.integers(0, N_CLASSES, (n, k)),
        "valid": np.ones((n, k), dtype=bool),
    }


def phase_train_step(args_cv) -> dict:
    """One full-width train step with the kernels against the library path
    at the same weights and batch, then timed steps of both."""
    import torch

    from pixelpick_tpu_torch.engine.optim import make_optimizer
    from pixelpick_tpu_torch.engine.trainer import (
        make_train_step, normalize_images, sparse_ce_and_hist,
    )
    from pixelpick_tpu_torch.models import layers
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.ops import depthwise as dw, fused_ir

    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             train_batch(np.random.default_rng(7), TRAIN_BATCH).items()}
    models = {}
    for name, fused in (("kernels", True), ("library", False)):
        args_cv.fused_ir = fused
        layers.set_depthwise_impl("pallas" if fused else "xla")
        models[name] = get_model(args_cv, DEVICE, seed=11)
    layers.set_depthwise_impl("pallas")
    args_cv.fused_ir = False
    well_conditioned_(models["kernels"], seed=12)
    models["library"].load_state_dict(models["kernels"].state_dict())
    for m in models.values():
        for mod in m.modules():
            if isinstance(mod, layers.Dropout):
                mod.p = 0.0  # dropout off for this comparison only
        m.train()
    margins = []

    def margin(name):
        def hook(_mod, _inp, out):
            out = out.detach().float()
            margins.append((float(torch.minimum(out.abs(),
                                                (out - 6).abs()).min()),
                            name, float(out.min()), float(out.max())))
        return hook

    hooks = [m.register_forward_hook(margin(n))
             for n, m in relu_batchnorms(models["library"])]

    def loss_and_grads(model):
        x = normalize_images(batch["x"], args_cv.mean, args_cv.std)
        out = model(x, upsample=False)
        loss, _ = sparse_ce_and_hist(out["pred"], batch["coords"],
                                     batch["labels"], batch["valid"],
                                     IMAGE_HW, N_CLASSES)
        names, params = zip(*model.named_parameters())
        return loss, dict(zip(names, torch.autograd.grad(loss, params)))

    torch.cuda.synchronize()
    fused_ir.reset_launch_counts()
    dw.reset_launch_counts()
    loss_k, grads_k = loss_and_grads(models["kernels"])
    torch.cuda.synchronize()
    counts = {**fused_ir.launch_counts, **{f"depthwise_{k}": v for k, v in
                                           dw.launch_counts.items()}}
    loss_l, grads_l = loss_and_grads(models["library"])
    torch.cuda.synchronize()
    for hook in hooks:
        hook.remove()
    print(f"[6] launches in one train step with the kernels: {counts}")
    check(counts["fused_fwd"] == 13 and counts["fused_bwd"] == 13,
          f"fused launches per step {counts}")
    check(counts["depthwise_kernel"] == 1 and counts["depthwise_kernel_dx"] == 1
          and counts["depthwise_stride2_conv"] == 3,
          f"depthwise launches per step {counts}")
    loss_k, loss_l = float(loss_k.detach()), float(loss_l.detach())
    loss_err = abs(loss_k - loss_l) / abs(loss_l)
    gmax = max(float(g.abs().max()) for g in grads_l.values())

    def leaf_errors(grads):
        """Per leaf: largest |diff| over its tolerance."""
        return {n: float((grads[n] - g).abs().max())
                / (STEP_GRAD_TOL * float(g.abs().max())
                   + STEP_GRAD_FLOOR * gmax)
                for n, g in grads_l.items()}

    errs = leaf_errors(grads_k)
    worst = sorted(((e, n, float(grads_l[n].abs().max()) / gmax)
                    for n, e in errs.items()), reverse=True)[:5]
    # a control the judge must refuse: block 2's expand-weight gradient 5%
    # too large
    planted = dict(grads_k)
    planted["backbone.features.2.conv.0.weight"] = \
        grads_k["backbone.features.2.conv.0.weight"] * 1.05
    control_fails = max(leaf_errors(planted).values()) > 1
    print(f"[6] loss {loss_k:.7f} with the kernels, {loss_l:.7f} with the "
          f"library (relative {loss_err:.3g}, tolerance {STEP_LOSS_TOL}); "
          f"least distance of a ReLU input from 0 or 6 "
          f"{min(margins)}; gradients, kernels vs library, the worst "
          f"leaves at {[(n, f'{e:.3g}') for e, n, _ in worst]} of their "
          f"tolerance (their largest |value| over the largest gradient: "
          f"{[f'{o:.2g}' for _, _, o in worst]}); the planted 5% fault "
          f"refused: {control_fails}")
    check(np.isfinite(loss_k), "non-finite loss")
    check(loss_err <= STEP_LOSS_TOL, f"loss {loss_k} vs {loss_l}")
    check(worst[0][0] <= 1, f"gradients off: {worst}")
    check(control_fails, "the planted gradient fault passed the check")

    # whole steps (forward, loss, backward, Adam), each synchronised after
    # it, kernels and library in turns
    step_ms = {"kernels": [], "library": []}
    peak_gb = {}
    for name in ("kernels", "library", "library", "kernels"):
        m = models[name]
        step = make_train_step(m, make_optimizer(args_cv, m, 92),
                               n_classes=N_CLASSES, mean=args_cv.mean,
                               std=args_cv.std)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        for _ in range(5):
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3)
        peak_gb[name] = max(peak_gb.get(name, 0.0),
                            torch.cuda.max_memory_allocated() / 1e9)
        del step
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    print(f"[6] train step at batch {TRAIN_BATCH} (median of 10): "
          f"{med['kernels']:.2f} ms with the kernels, {med['library']:.2f} ms "
          f"with the library path; peak device memory in a step "
          f"{peak_gb['kernels']:.3f} GB with the kernels, "
          f"{peak_gb['library']:.3f} GB with the library path (both models "
          f"resident)")
    return {"launches_per_step": counts, "loss_kernels": loss_k,
            "loss_library": loss_l, "loss_rel_err": loss_err,
            "kink_margin": min(margins), "grad_worst": worst,
            "grad_err_over_tol": errs, "control_fails": control_fails,
            "step_ms": step_ms, "median_step_ms": med,
            "peak_device_gb": peak_gb}


# ------------------------------ phase 7 ------------------------------

def write_cfg(work: Path, name: str, dataset: str = "cv",
              **overrides) -> Path:
    """The dataset's block (CamVid's unless ``dataset`` says otherwise) as a
    dataset config overlay on the synthetic set (the epoch count and the
    batch size are set by such an overlay, not by flags, in both
    packages)."""
    import yaml

    from pixelpick_tpu_torch.config import DATASET_DEFAULTS

    cfg = {k: v for k, v in DATASET_DEFAULTS[dataset].items()
           if k != "dir_dataset_name"}
    cfg["optimizer_params"] = {k: list(v) if isinstance(v, tuple) else v
                               for k, v in cfg["optimizer_params"].items()}
    cfg.update(dataset_name=dataset, dir_dataset=str(work / "camvid"))
    cfg.update(overrides)
    path = work / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_main_al(argv: list, record: dict, timed=(), traced=(), entry=None):
    """``cli.main_al.main(argv)`` (or ``entry(argv)``, another CLI that
    drives ``ALModel``) with the kernels' counters zeroed just before and
    read just after. The epochs keyed (round, epoch) in ``timed`` are
    timed, with the peak device memory; those in ``traced`` run under the
    profiler, the device's activity only (sifting a host trace of every
    operator of an epoch takes longer than the epoch). Returns (the
    driver, its wall time, the launch counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pixelpick_tpu_torch.active import driver
    from pixelpick_tpu_torch.cli.main_al import main as main_al
    from pixelpick_tpu_torch.ops import depthwise as dw, fused_ir

    train_epoch = driver.ALModel._train_epoch

    def hooked(self, epoch, step_fn):
        key = (self.nth_query, epoch)
        if key not in timed and key not in traced:
            return train_epoch(self, epoch, step_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if key in timed:
            out = train_epoch(self, epoch, step_fn)
            torch.cuda.synchronize()
            record["warm_epoch_s"] = time.perf_counter() - t0
            record["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
            return out
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = train_epoch(self, epoch, step_fn)
            torch.cuda.synchronize()
        record["traced_epoch_s"] = time.perf_counter() - t0
        record["busy"] = device_busy(prof, record["traced_epoch_s"])
        return out

    driver.ALModel._train_epoch = hooked
    torch.cuda.synchronize()
    fused_ir.reset_launch_counts()
    dw.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        al = (entry or main_al)(argv)
        torch.cuda.synchronize()
    finally:
        driver.ALModel._train_epoch = train_epoch
    wall_s = time.perf_counter() - t0
    counts = {**fused_ir.launch_counts, **{f"depthwise_{k}": v for k, v in
                                           dw.launch_counts.items()}}
    return al, wall_s, counts


def phase_campaign(work: Path) -> dict:
    """Two AL rounds through the CLI entry point, as a user runs them; the
    round-0 warm epoch timed, the round-1 warm epoch under the profiler."""
    from pixelpick_tpu_torch.active import codec
    from pixelpick_tpu_torch.data.loader import Loader

    run = work / "campaign"
    cfg = write_cfg(work, "cv_2epochs", n_epochs=2)
    record = {}
    al, campaign_s, counts = run_main_al([
        "-pdc", str(cfg), "--dir_checkpoints", str(run), "--device", DEVICE,
        "--fused_ir", "--pallas_dw", "--n_pixels_by_us", "10",
        "--max_budget", "20", "-qs", "margin_sampling", "--pool_batch_size",
        str(POOL_BATCH), "--n_workers", "8", "--seed", "0"], record,
        timed={(0, 2)}, traced={(1, 2)})
    n_steps = 2 * 2 * -(-N_IMAGES // TRAIN_BATCH)
    print(f"[7] two rounds in {campaign_s:.1f} s; launches {counts} for "
          f"{n_steps} train steps")
    check(counts["fused_fwd"] == 13 * n_steps
          and counts["fused_bwd"] == 13 * n_steps, f"fused launches {counts}")
    check(counts["depthwise_kernel_dx"] == n_steps, f"dx launches {counts}")

    for stage in ("0_query", "1_query"):
        for f in ("queries.pkl", "query_stats.pkl", "log_train.txt",
                  "log_val.txt", "best_miou_model.ckpt", "timing.json",
                  "1_train.png", "2_train.png", "1_val.png", "2_val.png"):
            check((run / stage / f).is_file(), f"{stage}/{f} not written")
        rows = (run / stage / "log_train.txt").read_text().split()[1:]
        check(len(rows) == 2 and all(np.isfinite(float(r.split(",")[3]))
                                     for r in rows), f"{stage} losses {rows}")
    check((run / "2_query" / "queries.pkl").is_file(), "2_query not written")
    labelled = None
    for nth in (0, 1, 2):
        with open(run / f"{nth}_query" / "queries.pkl", "rb") as f:
            masks = codec.decode_queries(pkl.load(f), return_as_dict=True)
        check(len(masks) == N_IMAGES, f"{nth}_query: {len(masks)} images")
        for p, m in masks.items():
            check(int(m.sum()) == 10, f"{nth}_query {p}: {int(m.sum())} picks")
            gt = np.asarray(al.dataset._load_y(
                al.dataset.list_inputs.index(p)))
            check(not (gt[m] == VOID).any(), f"{nth}_query {p}: a void pick")
        if labelled is not None:
            check(not any((labelled[p] & m).any() for p, m in masks.items()),
                  f"{nth}_query re-picked a labelled pixel")
            labelled = {p: labelled[p] | m for p, m in masks.items()}
        else:
            labelled = masks
    check(al.dataset.n_pixels_total == 3 * 10 * N_IMAGES,
          f"{al.dataset.n_pixels_total} labelled pixels")
    timing = {stage: json.loads((run / stage / "timing.json").read_text())
              for stage in ("0_query", "1_query")}
    busy, busy_us, by_name = record["busy"]
    warm_ips = N_IMAGES / record["warm_epoch_s"]
    # the profiler slows the host, not the device: the traced epoch's device
    # time over the untraced warm epoch's wall time (same number of steps)
    busy_untraced = busy_us / 1e6 / record["warm_epoch_s"]
    val_ips = [timing[s]["val"]["items_per_sec"] for s in timing]
    # the host's share: one epoch of the train loader alone (images decoded
    # and cached already), no step
    with Loader(al.dataset, TRAIN_BATCH, mode="train", shuffle=True,
                n_workers=8, seed=0) as loader:
        loader.set_epoch(3)
        t0 = time.perf_counter()
        n_loaded = sum(len(b["x"]) for b in loader)
        loader_s = time.perf_counter() - t0
    print(f"[7] warm epoch (round 0, epoch 2): {record['warm_epoch_s']:.2f} s "
          f"= {warm_ips:.1f} train images/s; round 1 epoch 2 under the "
          f"profiler {record['traced_epoch_s']:.2f} s, device busy "
          + (f"{100 * busy:.1f}% of it, its device time {busy_us / 1e6:.2f} "
             f"s = {100 * busy_untraced:.1f}% of the untraced warm epoch"
             if busy is not None else "not measured")
          + f"; the train loader alone {n_loaded / loader_s:.1f} images/s; "
          f"validation {val_ips} images/s")
    top = print_top("[7]", by_name)
    return {"campaign_s": campaign_s, "launches": counts, "n_steps": n_steps,
            "warm_epoch_s": record["warm_epoch_s"],
            "train_images_per_s": warm_ips,
            "traced_epoch_s": record["traced_epoch_s"],
            "device_busy_share": busy, "device_busy_ms": busy_us / 1e3,
            "device_busy_share_untraced_epoch": busy_untraced,
            "loader_images_per_s": n_loaded / loader_s,
            "top_device_ms": top, "val_images_per_s": val_ips,
            "timing": timing}


# ------------------------------ phase 8 ------------------------------

def sgd_args(args_cv):
    """``args_cv`` with SGD, whose update is linear in the gradient: two
    runs stay as close as their gradients (Adam's normalisation would blow
    a rounding difference of a near-zero gradient up to a whole step)."""
    import copy

    args = copy.copy(args_cv)
    args.optimizer_type, args.optimizer_params = "SGD", {"lr": 5e-4}
    return args


def fresh_model(args, start: dict):
    """A full-width train-mode model with the kernels at ``start``'s
    weights, dropout at p = 0, and its SGD optimizer."""
    from pixelpick_tpu_torch.engine.optim import make_optimizer
    from pixelpick_tpu_torch.models import layers
    from pixelpick_tpu_torch.models.factory import get_model

    model = get_model(args, DEVICE, seed=11)
    model.load_state_dict(start)
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    model.train()
    return model, make_optimizer(sgd_args(args), model, 92)


def state_error(got: dict, ref: dict, start: dict) -> dict:
    """Two models' states after the same updates, leaf by leaf against
    phase 6's limit: a parameter within STEP_GRAD_TOL of its own largest
    move from ``start`` plus STEP_GRAD_FLOOR of the largest move of any
    leaf; a running statistic within STEP_GRAD_TOL of its largest |value|
    (at least 1); the forward counts equal. Returns the worst leaf's error
    over its limit, its name, and whether every leaf is bit-equal."""
    moves = {k: float((v.float() - start[k].float()).abs().max())
             for k, v in ref.items() if v.is_floating_point()}
    big = max(v for k, v in moves.items()
              if not k.endswith(("running_mean", "running_var")))
    worst, name = 0.0, None
    for k, r in ref.items():
        if not r.is_floating_point():
            e = 0.0 if torch_equal(got[k], r) else float("inf")
        else:
            err = float((got[k].float() - r.float()).abs().max())
            if k.endswith(("running_mean", "running_var")):
                e = err / (STEP_GRAD_TOL * max(float(r.abs().max()), 1.0))
            else:
                e = err / (STEP_GRAD_TOL * moves[k] + STEP_GRAD_FLOOR * big)
        if e >= worst:
            worst, name = e, k
    return {"worst": worst, "leaf": name,
            "bit_equal": all(torch_equal(got[k], r) for k, r in ref.items())}


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def megabatch_vs_sequential(args, start: dict, batch: dict,
                            micro: int) -> dict:
    """The host megabatch ``batch`` through
    ``make_microbatch_train_step`` against ``B // micro`` sequential
    ``make_train_step`` calls on the same rows, from the same state; the
    kernels' launches of the megabatch step."""
    import torch

    from pixelpick_tpu_torch.engine.trainer import (
        batch_to_device, make_microbatch_train_step, make_train_step,
    )
    from pixelpick_tpu_torch.ops import depthwise as dw, fused_ir

    kw = dict(n_classes=N_CLASSES, mean=args.mean, std=args.std)
    model, opt = fresh_model(args, start)
    step = make_microbatch_train_step(model, opt, micro_bs=micro, **kw)
    torch.cuda.synchronize()
    fused_ir.reset_launch_counts()
    dw.reset_launch_counts()
    losses, hist = step(batch)
    torch.cuda.synchronize()
    counts = {**fused_ir.launch_counts, **{f"depthwise_{k}": v for k, v in
                                           dw.launch_counts.items()}}
    got, n_updates = model.state_dict(), opt.step_count
    del model, opt, step

    model, opt = fresh_model(args, start)
    step = make_train_step(model, opt, **kw)
    dev = batch_to_device(batch, DEVICE)
    ref_losses, ref_hist = [], None
    for m in range(batch["x"].shape[0] // micro):
        loss, h = step({k: v[m * micro:(m + 1) * micro]
                        for k, v in dev.items()})
        ref_losses.append(loss)
        ref_hist = h if ref_hist is None else ref_hist + h
    torch.cuda.synchronize()
    losses, ref_losses = losses.cpu().numpy(), torch.stack(ref_losses).cpu() \
        .numpy()
    out = state_error(got, model.state_dict(), start)
    out.update(
        updates=n_updates, ref_updates=opt.step_count, launches=counts,
        loss_rel_err=float(np.max(np.abs(losses - ref_losses)
                                  / np.abs(ref_losses))),
        hist_equal=torch_equal(hist, ref_hist), losses=losses.tolist())
    return out


def phase_microbatch(work: Path, args_cv, bs4: dict) -> dict:
    """The micro-batch step at full width with the kernels: a megabatch of
    48 at micro 4 against 12 sequential steps, a remainder of 31 padded to
    32, an all-pad third micro-batch; then ``main_al`` at bs 48 / micro 4
    for 3 epochs (epoch 2 timed, epoch 3 under the profiler)."""
    import torch

    from pixelpick_tpu_torch.active import driver
    from pixelpick_tpu_torch.engine.trainer import make_microbatch_train_step
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.parallel.mesh import pad_batch_to_devices

    args_cv.fused_ir = True
    try:
        model = get_model(args_cv, DEVICE, seed=11)
        well_conditioned_(model, seed=12)  # phase 6's weights
        start = {k: v.clone() for k, v in model.state_dict().items()}
        del model
        batch = train_batch(np.random.default_rng(8), 48)
        full = megabatch_vs_sequential(args_cv, start, batch, 4)
        print(f"[8] megabatch of 48 at micro 4 against 12 sequential steps: "
              f"worst leaf {full['worst']:.3g} of its limit ({full['leaf']}),"
              f" bit-equal {full['bit_equal']}, losses within "
              f"{full['loss_rel_err']:.3g} relative, confusion matrices "
              f"equal {full['hist_equal']}; launches {full['launches']}")
        check(full["updates"] == full["ref_updates"] == 12,
              f"{full['updates']} updates")
        check(full["launches"]["fused_fwd"] == 12 * 13
              and full["launches"]["fused_bwd"] == 12 * 13
              and full["launches"]["depthwise_kernel"] == 12
              and full["launches"]["depthwise_kernel_dx"] == 12,
              f"megabatch launches {full['launches']}")
        check(full["worst"] <= 1 and full["hist_equal"]
              and full["loss_rel_err"] <= STEP_LOSS_TOL,
              f"megabatch differs from the sequential steps: {full}")

        rem, n_real = pad_batch_to_devices(
            {k: v[:31] for k, v in batch.items()}, pad_label=VOID,
            target_rows=32)
        check(n_real == 31 and not rem["valid"][31:].any(), "padding")
        remainder = megabatch_vs_sequential(args_cv, start, rem, 4)
        print(f"[8] remainder of 31 padded to 32 (8 updates, the last 3 "
              f"real rows and 1 pad row) against 8 sequential steps on the "
              f"same rows: worst leaf {remainder['worst']:.3g} of its limit, "
              f"bit-equal {remainder['bit_equal']}")
        check(remainder["updates"] == 8 and remainder["worst"] <= 1
              and remainder["hist_equal"]
              and remainder["loss_rel_err"] <= STEP_LOSS_TOL,
              f"remainder megabatch: {remainder}")

        # a third micro-batch of pad rows leaves everything as two did;
        # cuDNN's deterministic algorithms, so that two runs of the same
        # updates give the same bits
        pads = {k: v[:12].copy() for k, v in batch.items()}
        pads["valid"][8:] = False
        states = []
        torch.backends.cudnn.deterministic = True
        for b in (pads, {k: v[:8] for k, v in batch.items()}):
            model, opt = fresh_model(args_cv, start)
            losses, _ = make_microbatch_train_step(
                model, opt, micro_bs=4, n_classes=N_CLASSES,
                mean=args_cv.mean, std=args_cv.std)(b)
            states.append((model.state_dict(), opt.step_count,
                           losses.cpu().numpy(), opt.state))
            del model
        torch.backends.cudnn.deterministic = False
        (sa, na, la, oa), (sb, nb, lb, ob) = states
        no_op = (na == nb == 2 and np.isnan(la[2])
                 and np.array_equal(la[:2], lb)
                 and all(torch_equal(sa[k], v) for k, v in sb.items())
                 and all(torch_equal(x, y) for ga, gb in zip(oa, ob)
                         for name in ga for x, y in zip(ga[name], gb[name])))
        print(f"[8] an all-pad third micro-batch: a no-op {no_op} (2 updates, "
              f"losses {la.tolist()})")
        check(no_op, "the all-pad micro-batch moved the state")
        del states, sa, sb, oa, ob
        torch.cuda.empty_cache()
    finally:
        args_cv.fused_ir = False

    cfg = write_cfg(work, "cv_bs48", n_epochs=3, batch_size=48)
    record, opts = {}, []
    make_optimizer = driver.make_optimizer

    def kept(*a, **k):
        opts.append(make_optimizer(*a, **k))
        return opts[-1]

    driver.make_optimizer = kept
    try:
        al, wall_s, counts = run_main_al([
            "-pdc", str(cfg), "--dir_checkpoints", str(work / "micro"),
            "--device", DEVICE, "--fused_ir", "--pallas_dw",
            "--micro_batch_size", "4", "--n_pixels_by_us", "10",
            "--max_budget", "10", "-qs", "margin_sampling",
            "--pool_batch_size", str(POOL_BATCH), "--n_workers", "8",
            "--seed", "0"], record, timed={(0, 2)}, traced={(0, 3)})
    finally:
        driver.make_optimizer = make_optimizer
    updates = opts[0].step_count
    per_epoch = al._iters_per_epoch()
    rows = (work / "micro" / "0_query" / "log_train.txt").read_text() \
        .split()[1:]
    busy, busy_us, by_name = record["busy"]
    ips = N_IMAGES / record["warm_epoch_s"]
    print(f"[8] main_al at bs 48 / micro 4, 3 epochs in {wall_s:.1f} s: "
          f"{updates} optimizer updates ({per_epoch} per epoch); launches "
          f"{counts}; warm epoch {record['warm_epoch_s']:.2f} s = {ips:.1f} "
          f"train images/s (phase 7's bs-4 warm epoch "
          f"{bs4['train_images_per_s']:.1f}); epoch 3 under the profiler "
          f"{record['traced_epoch_s']:.2f} s, device busy "
          + (f"{busy_us / 1e6:.2f} s = {100 * busy_us / 1e6 / record['warm_epoch_s']:.1f}% "
             f"of the untraced warm epoch" if busy is not None
             else "not measured"))
    top = print_top("[8]", by_name)
    check(per_epoch == 92 and updates == 3 * 92,
          f"{updates} updates, {per_epoch} per epoch")
    check(counts["fused_fwd"] == 13 * updates
          and counts["fused_bwd"] == 13 * updates
          and counts["depthwise_kernel_dx"] == updates,
          f"epoch launches {counts}")
    check(len(rows) == 3 and all(np.isfinite(float(r.split(",")[3]))
                                 for r in rows), f"losses {rows}")
    check((work / "micro" / "1_query" / "queries.pkl").is_file(),
          "the round's picks were not written")
    return {"megabatch": full, "remainder": remainder, "all_pad_no_op": no_op,
            "epoch_run_s": wall_s, "updates": updates,
            "updates_per_epoch": per_epoch, "launches": counts,
            "warm_epoch_s": record["warm_epoch_s"], "train_images_per_s": ips,
            "bs4_train_images_per_s": bs4["train_images_per_s"],
            "peak_device_gb": record["peak_device_gb"],
            "traced_epoch_s": record["traced_epoch_s"],
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share_untraced_epoch":
                busy_us / 1e6 / record["warm_epoch_s"],
            "top_device_ms": top}


# ------------------------------ phase 9 ------------------------------

def phase_dense(work: Path) -> dict:
    """``main_al --n_pixels_by_us 0``: the fully supervised stage, 2 epochs
    at bs 4 with the kernels, epoch 2 timed with its peak memory."""
    run = work / "dense"
    cfg = write_cfg(work, "cv_2epochs", n_epochs=2)
    record = {}
    al, wall_s, counts = run_main_al([
        "-pdc", str(cfg), "--dir_checkpoints", str(run), "--device", DEVICE,
        "--fused_ir", "--pallas_dw", "--n_pixels_by_us", "0",
        "--n_workers", "8", "--seed", "0"], record, timed={(-1, 2)})
    n_steps = 2 * -(-N_IMAGES // TRAIN_BATCH)
    stage = run / "fully_sup"
    for f in ("best_miou_model.ckpt", "log_train.txt", "log_val.txt"):
        check((stage / f).is_file(), f"fully_sup/{f} not written")
    check(not (run / "0_query").exists(), "the dense run made a query round")
    rows = (stage / "log_train.txt").read_text().split()[1:]
    losses = [float(r.split(",")[3]) for r in rows]
    ips = N_IMAGES / record["warm_epoch_s"]
    print(f"[9] fully supervised stage, 2 epochs in {wall_s:.1f} s: losses "
          f"{losses}; launches {counts} for {n_steps} steps; warm epoch "
          f"{record['warm_epoch_s']:.2f} s = {ips:.1f} train images/s, peak "
          f"device memory {record['peak_device_gb']:.3f} GB")
    check(len(losses) == 2 and np.isfinite(losses).all(), f"losses {rows}")
    check(al.loader.mode == "train_dense", "not the dense loader")
    check(counts["fused_fwd"] == 13 * n_steps
          and counts["fused_bwd"] == 13 * n_steps
          and counts["depthwise_kernel_dx"] == n_steps,
          f"dense launches {counts}")
    return {"run_s": wall_s, "losses": losses, "launches": counts,
            "n_steps": n_steps, "warm_epoch_s": record["warm_epoch_s"],
            "train_images_per_s": ips,
            "peak_device_gb": record["peak_device_gb"]}


# ------------------------------ phase 10 ------------------------------

MC_STEPS = 20


def phase_committee(model, args, plain: dict) -> dict:
    """The MC-dropout committee's pool sweep (``--use_mc_dropout
    --mc_n_steps 20``, soft vote, margin sampling) at phase 3's weights,
    the pool's images decoded already; one pool batch with the hard vote;
    at p = 0 the committee's picks against the plain sweep's."""
    import copy

    import torch

    from pixelpick_tpu_torch.active.acquisition import make_score_fn
    from pixelpick_tpu_torch.active.selector import QuerySelector
    from pixelpick_tpu_torch.data.factory import get_dataset
    from pixelpick_tpu_torch.data.loader import Loader
    from pixelpick_tpu_torch.models import layers
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.ops import depthwise as dw

    args_mc = copy.copy(args)
    args_mc.use_mc_dropout, args_mc.mc_n_steps = True, MC_STEPS
    committee_model = get_model(args_mc)
    committee_model.load_state_dict(model.state_dict())
    dataset = get_dataset(args_mc, val=False, query=True)
    kw = dict(strategy="margin_sampling", mean=args.mean, std=args.std,
              n_pixels=10, top_n_percent=0.05, reverse_order=False,
              ignore_index=VOID)

    def device_batch(batch):
        return {k: torch.from_numpy(batch[k]).to(DEVICE)
                for k in ("x", "excluded", "y")}

    with Loader(dataset, POOL_BATCH, mode="query",
                n_workers=args.n_workers) as loader:
        first = next(iter(loader))  # decodes the first batch
        for _ in loader:  # and the rest: the sweep below is warm
            pass
        selector = QuerySelector(args_mc, loader, committee_model, DEVICE)
        generator = torch.Generator(device=DEVICE).manual_seed(1)
        committee_model.set_dropout_generator(generator)
        n_batches, n_bad, n_picks = 0, 0, 0
        torch.cuda.synchronize()
        dw.reset_launch_counts()
        t0 = time.perf_counter()
        for batch in loader:
            idx, stats = selector._score_fn(device_batch(batch), generator)
            idx, ok = idx.cpu().numpy(), stats["picked_valid"].cpu().numpy()
            forbidden = (batch["excluded"] | (batch["y"] == VOID)) \
                .reshape(len(idx), -1)
            n_bad += int(np.take_along_axis(forbidden, idx, 1).sum()
                         + (~ok).sum())
            n_picks += sum(len(set(row.tolist())) for row in idx)
            n_batches += 1
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        counts = dict(dw.launch_counts)
    print(f"[10] MC committee ({MC_STEPS} members, soft vote) warm sweep of "
          f"{N_IMAGES} images in {n_batches} batches: {sweep_s:.3f} s = "
          f"{N_IMAGES / sweep_s:.1f} images/s against the single-forward "
          f"sweep's {plain['images_per_s']:.1f} (phase 3; "
          f"{sweep_s / plain['warm_s']:.1f}x its time); launches {counts}; "
          f"{n_picks} distinct picks, {n_bad} on a labelled or void pixel")
    check(counts["kernel"] == 14 * MC_STEPS * n_batches,
          f"{counts['kernel']} depthwise launches for {n_batches} batches")
    check(n_picks == 10 * N_IMAGES and n_bad == 0,
          f"{n_picks} picks, {n_bad} forbidden")

    # the hard vote on one pool batch
    dev = device_batch(first)
    hard = make_score_fn(committee_model, mc_n_steps=MC_STEPS,
                         vote_type="hard", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, stats = hard(dev, torch.Generator(device=DEVICE).manual_seed(2))
    idx = idx.cpu().numpy()
    hard_s = time.perf_counter() - t0
    hard_valid = float(stats["picked_valid"].float().mean())
    distinct = all(len(set(row.tolist())) == 10 for row in idx)
    # labelled and void pixels take the fill value, margin 1, as do the
    # pixels whose members all vote alike: picks may tie into them
    print(f"[10] hard vote, one batch of {len(idx)}: {hard_s:.3f} s; 10 "
          f"distinct picks per image {distinct}; share of picks off "
          f"labelled and void pixels {hard_valid:.4f}")
    check(distinct and idx.min() >= 0
          and idx.max() < IMAGE_HW[0] * IMAGE_HW[1], "hard-vote picks")

    # at p = 0 every member is the plain forward: the same picks
    for m in committee_model.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    soft = make_score_fn(committee_model, mc_n_steps=MC_STEPS,
                         vote_type="soft", **kw)
    single = make_score_fn(committee_model, **kw)
    ours, _ = soft(dev, torch.Generator(device=DEVICE).manual_seed(3))
    ref, _ = single(dev, torch.Generator(device=DEVICE).manual_seed(3))
    same = [set(a.tolist()) == set(b.tolist())
            for a, b in zip(ours.cpu().numpy(), ref.cpu().numpy())]
    print(f"[10] at p = 0 the committee's picks equal the plain sweep's in "
          f"{sum(same)} of {len(same)} images")
    check(all(same), "the p = 0 committee picks other pixels")
    del committee_model
    torch.cuda.empty_cache()
    return {"members": MC_STEPS, "sweep_s": sweep_s,
            "images_per_s": N_IMAGES / sweep_s, "n_batches": n_batches,
            "launches": counts, "plain_warm_s": plain["warm_s"],
            "time_over_plain": sweep_s / plain["warm_s"],
            "hard_vote_batch_s": hard_s,
            "hard_vote_valid_share": hard_valid,
            "p0_control_equal": all(same)}


# ------------------------------ main ------------------------------

# ------------------------------ phase 11 ------------------------------

# phase 11's depth: the stage's epochs (the interruption falls in the last)
TRAIN_CLI_EPOCHS, INTERRUPT_AFTER_STEPS = 2, 10


def state_on_host(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def leaf_diffs(a: dict, b: dict) -> dict:
    """Per leaf, the largest |a - b| (0 for equal integer leaves)."""
    return {k: float((a[k].double() - b[k].double()).abs().max())
            if a[k].numel() else 0.0 for k in a}


def phase_train_cli(work: Path) -> dict:
    """``cli.train.main`` on phase 4's human-labelled rounds (all 367 images,
    20 labelled pixels each): the stage ``1_query`` at full width with
    ``--fused_ir --pallas_dw --stage_ckpt_interval 1`` for
    ``TRAIN_CLI_EPOCHS`` epochs, (a) straight, (b) interrupted after 10
    updates of the last epoch and rerun over its directory, which resumes
    from the snapshot of the epoch before. cuDNN runs its
    deterministic algorithms in every arm (its default weight-gradient
    algorithms may add in any order), so that (b) can equal (a) bit for
    bit; where it does not, (c) a second straight run is made and (b) must
    lie no further from (a), leaf by leaf, than (c) does."""
    import torch

    from pixelpick_tpu_torch.active import driver
    from pixelpick_tpu_torch.cli.train import main as train_main

    cfg = write_cfg(work, "cv_train_cli", n_epochs=TRAIN_CLI_EPOCHS)
    val_hists = []
    running_score, val = driver.RunningScore, driver.ALModel._val

    class Recording(running_score):
        def get_scores(self):
            val_hists.append(np.asarray(self.confusion))
            return super().get_scores()

    def recording_val(self, *a):
        driver.RunningScore = Recording
        try:
            return val(self, *a)
        finally:
            driver.RunningScore = running_score

    def train(run: Path, record: dict, timed=()):
        return run_main_al(
            ["-pdc", str(cfg), "--dir_checkpoints", str(run), "--device",
             DEVICE, "--fused_ir", "--pallas_dw", "--stage_ckpt_interval",
             "1", "--n_workers", "8", "--seed", "0"], record, timed=timed,
            entry=train_main)

    def arm(name: str, record: dict, timed=()):
        """A fresh run directory holding phase 4's two labelled rounds."""
        run = work / f"train_{name}"
        for nth in (0, 1):
            (run / f"{nth}_query").mkdir(parents=True)
            shutil.copy(work / "human" / f"{nth}_query" / "queries.pkl",
                        run / f"{nth}_query" / "queries.pkl")
        return run, train(run, record, timed)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        record = {}
        driver.ALModel._val = recording_val
        try:
            run_a, (al_a, wall_a, counts_a) = arm("a", record,
                                                  timed={(1, 2)})
        finally:
            driver.ALModel._val = val
        straight = state_on_host(al_a.model)
        n_steps = TRAIN_CLI_EPOCHS * -(-N_IMAGES // TRAIN_BATCH)
        check(al_a.human_labels and al_a.dataset.list_labels == []
              and len(al_a.dataset) == N_IMAGES, "not the human-label mode")
        check(counts_a["fused_fwd"] == 13 * n_steps
              and counts_a["fused_bwd"] == 13 * n_steps
              and counts_a["depthwise_kernel_dx"] == n_steps,
              f"arm (a) launches {counts_a} for {n_steps} updates")

        # (b): the first run stops in the last epoch, its snapshot of the
        # epoch before on disk; the rerun resumes from it
        train_epoch = driver.ALModel._train_epoch

        class Interrupted(Exception):
            pass

        def interrupting(self, epoch, step_fn):
            if epoch < TRAIN_CLI_EPOCHS:
                return train_epoch(self, epoch, step_fn)
            n = [0]

            def step(*batch_and_shard):
                if n[0] == INTERRUPT_AFTER_STEPS:
                    raise Interrupted
                n[0] += 1
                return step_fn(*batch_and_shard)

            return train_epoch(self, epoch, step)

        driver.ALModel._train_epoch = interrupting
        try:
            arm("b", {})
            raise SmokeFailure("arm (b) was not interrupted")
        except Interrupted:
            pass
        finally:
            driver.ALModel._train_epoch = train_epoch
        run_b = work / "train_b"
        snap = run_b / "1_query" / "stage_state.ckpt"
        check(snap.is_file(), "no snapshot after the interruption")
        snap_bytes = snap.stat().st_size
        rows_before = (run_b / "1_query" / "log_train.txt").read_text().split()
        al_b, resume_s, counts_b = train(run_b, {})
        resumed = state_on_host(al_b.model)
        check(not snap.exists(), "the snapshot outlived its stage")
        n_epoch = -(-N_IMAGES // TRAIN_BATCH)
        check(counts_b["fused_fwd"] == 13 * n_epoch
              and counts_b["fused_bwd"] == 13 * n_epoch,
              f"the resumed run's launches {counts_b}, not one epoch's")
        logs = {}
        for log in ("log_train.txt", "log_val.txt"):
            rows = (run_b / "1_query" / log).read_text().split()
            logs[log] = rows
            check([r.split(",")[0] for r in rows[1:]]
                  == [str(e) for e in range(1, TRAIN_CLI_EPOCHS + 1)],
                  f"{log} rows {rows}")
        check([r.split(",")[0] for r in rows_before[1:]]
              == [str(e) for e in range(1, TRAIN_CLI_EPOCHS)],
              f"log_train.txt before the rerun: {rows_before}")

        check(list(resumed) == list(straight), "other state_dict keys")
        bit_exact = all(torch.equal(resumed[k], straight[k])
                        for k in straight)
        second = None
        if not bit_exact:
            _, (al_c, _, _) = arm("c", {})
            d_c = leaf_diffs(state_on_host(al_c.model), straight)
            d_b = leaf_diffs(resumed, straight)
            worse = [k for k in straight if d_b[k] > d_c[k]]
            second = {"max_resumed_diff": max(d_b.values()),
                      "max_straight_diff": max(d_c.values()),
                      "leaves_further": worse}
            check(not worse, f"the resumed run lies further from the "
                             f"straight one than a second straight run at "
                             f"{len(worse)} leaves, e.g. {worse[:3]}")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    timing = json.loads((run_a / "1_query" / "timing.json").read_text())
    save_ms = 1e3 * timing["stage_ckpt"]["seconds"] / (TRAIN_CLI_EPOCHS - 1)
    ips = N_IMAGES / record["warm_epoch_s"]
    # the best validation of arm (a): the first of its highest mIoU
    mious = [float(r.split(",")[1]) for r in
             (run_a / "1_query" / "log_val.txt").read_text().split()[1:]]
    check(len(val_hists) == TRAIN_CLI_EPOCHS, f"{len(val_hists)} validations")
    best_hist = val_hists[int(np.argmax(mious))]
    print(f"[11] train CLI, stage 1_query on human labels, "
          f"{TRAIN_CLI_EPOCHS} epochs: "
          f"resumed run {'bit-exact' if bit_exact else 'not bit-exact'} "
          f"against the straight one"
          + ("" if bit_exact else
             f" (resumed max diff {second['max_resumed_diff']:.3e}, a second "
             f"straight run {second['max_straight_diff']:.3e})")
          + f"; snapshot save {save_ms:.1f} ms, {snap_bytes} bytes; log rows "
          f"{logs['log_train.txt'][1:]}; launches straight {counts_a} for "
          f"{n_steps} updates, resume {counts_b}; warm epoch (2) "
          f"{record['warm_epoch_s']:.2f} s = {ips:.1f} train images/s; "
          f"resume {resume_s:.1f} s")
    return {"bit_exact": bit_exact, "second_straight": second,
            "cudnn_deterministic": True,
            "snapshot_save_ms": save_ms, "snapshot_bytes": snap_bytes,
            "log_rows": logs, "launches": counts_a, "launches_resume":
            counts_b, "n_steps": n_steps, "warm_epoch_s":
            record["warm_epoch_s"], "train_images_per_s": ips,
            "straight_s": wall_a, "resume_s": resume_s, "timing": timing,
            "val_mious": mious, "best_val_hist": best_hist.tolist(),
            "best_ckpt": str(run_a / "1_query" / "best_miou_model.ckpt")}


# ------------------------------ phase 12 ------------------------------

def write_flax_checkpoint(state: dict, path: Path) -> None:
    """The JAX package's best-model layout (``save_checkpoint``:
    ``{"params", "batch_stats"}``, kernels HWIO) from a port ``state_dict``,
    through the bridge's inverse (``models/convert.py``) and the msgpack
    writer (``engine/flax_msgpack.py``)."""
    from pixelpick_tpu_torch.engine.flax_msgpack import msgpack_serialize
    from pixelpick_tpu_torch.models.convert import jax_tree_from_state_dict

    params, stats, skipped = jax_tree_from_state_dict(state)
    check(not skipped, f"unwritten: {skipped[:3]}")
    path.write_bytes(msgpack_serialize({"params": params,
                                        "batch_stats": stats}))


def default_args_cv(work: Path):
    """The full-width CamVid configuration on the card, no files written."""
    from pixelpick_tpu_torch.config import default_args

    return default_args(dataset_name="cv", dir_dataset=str(work / "camvid"),
                        device=DEVICE, width_multiplier=1.0, fused_ir=True)


def phase_eval_cli(work: Path, train: dict) -> dict:
    """``cli.eval.main --pallas_dw`` on phase 11's best checkpoint (the
    torch format) and on a JAX-layout msgpack file of the same weights: the
    same confusion matrix from both, and 14 depthwise launches per forward.
    Then the torch file again with ``--fused_ir`` too, the model of the
    stage: its blocks' eval path keeps the library's depthwise conv (as the
    JAX package's ``FusedIRBlock`` does), so only block 0 launches the
    kernel, and it gives the stage's best validation's confusion matrix.
    cuDNN runs its deterministic algorithms, as in phase 11."""
    import torch

    from pixelpick_tpu_torch.cli import eval as eval_cli
    from pixelpick_tpu_torch.engine.checkpoint import load_checkpoint
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.ops import depthwise as dw

    best = Path(train["best_ckpt"])
    state = torch.load(best, map_location="cpu", weights_only=True)["model"]
    flax_ckpt = work / "best_flax.msgpack"
    write_flax_checkpoint(state, flax_ckpt)
    args = default_args_cv(work)
    back = load_checkpoint(str(flax_ckpt), get_model(args)).state_dict()
    check(all(torch.equal(back[k].cpu(), state[k]) for k in state
              if not k.endswith("num_batches_tracked")),
          "the msgpack file does not read back to the checkpoint")

    hists, runs = {}, {}
    running_score = eval_cli.RunningScore

    class Recording(running_score):
        def get_scores(self):
            hists[current] = np.asarray(self.confusion)
            return super().get_scores()

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    eval_cli.RunningScore = Recording
    try:
        for current, ckpt, flags, per_forward in (
                ("torch", best, [], 14), ("msgpack", flax_ckpt, [], 14),
                ("torch_fused_ir", best, ["--fused_ir"], 1)):
            dw.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores, _ = eval_cli.main([
                "-pdc", str(work / "cv_train_cli.yaml"), "--p_state_dict",
                str(ckpt), "--dir_checkpoints", str(work / f"eval_{current}"),
                "--device", DEVICE, "--pallas_dw", "--n_workers", "8",
                "--visualize_interval", "50", *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[current] = {"s": wall, "images_per_s": N_VAL / wall,
                             "miou": scores["Mean IoU"],
                             "launches": dict(dw.launch_counts)}
            check(dw.launch_counts["kernel"] == per_forward * N_VAL,
                  f"{current}: {dw.launch_counts} for {N_VAL} forwards")
            pngs = sorted(p.name for p in (work / f"eval_{current}" / "val")
                          .glob("*.png"))
            check(pngs == ["0.png", "100.png", "50.png"], f"PNGs {pngs}")
    finally:
        eval_cli.RunningScore = running_score
        torch.backends.cudnn.deterministic = deterministic
    check(np.array_equal(hists["torch"], hists["msgpack"]),
          "the two checkpoint formats give other confusion matrices")
    best_hist = np.asarray(train["best_val_hist"])
    check(np.array_equal(hists["torch_fused_ir"], best_hist),
          "the eval CLI's confusion matrix is not the best validation's")
    # pixels whose class moved between the kernel's and the library's
    # depthwise (near-ties of the argmax)
    moved = int(np.abs(hists["torch"] - best_hist).sum()) // 2
    print(f"[12] eval CLI on the best checkpoint: torch file "
          f"{runs['torch']['images_per_s']:.1f} and msgpack file "
          f"{runs['msgpack']['images_per_s']:.1f} validation images/s (each "
          f"run decodes the PNGs), equal confusion matrices, mIoU "
          f"{runs['torch']['miou']:.6f}, launches "
          f"{runs['torch']['launches']}; with --fused_ir "
          f"{runs['torch_fused_ir']['images_per_s']:.1f} images/s, the "
          f"stage's best validation's matrix exactly (mIoU "
          f"{runs['torch_fused_ir']['miou']:.6f}); {moved} of "
          f"{int(best_hist.sum())} pixels change class between the "
          f"kernel's and the library's depthwise")
    return {"runs": runs, "flax_ckpt": str(flax_ckpt),
            "flax_ckpt_bytes": flax_ckpt.stat().st_size,
            "pixels_moved_kernel_vs_library": moved}


# ------------------------------ phase 13 ------------------------------

def phase_resume_and_pretrained(work: Path, flax_ckpt: str) -> dict:
    """``main_al --resume_campaign`` over phase 7's finished campaign: no
    update, no sweep, the same labelled pixels, the logs untouched. Then
    ``main_al --pretrained_ckpt`` with phase 12's msgpack file for one
    ``--debug`` epoch: round 0's weights before its first update are the
    file's."""
    import torch

    from pixelpick_tpu_torch.active import driver
    from pixelpick_tpu_torch.engine.checkpoint import load_checkpoint
    from pixelpick_tpu_torch.models.factory import get_model

    run = work / "campaign"
    cfg = work / "cv_2epochs.yaml"
    logs = sorted(run.glob("*_query/log_*.txt")) \
        + sorted(run.glob("*_query/best_miou_model.ckpt"))
    mtimes = [p.stat().st_mtime_ns for p in logs]
    al, resume_s, counts = run_main_al([
        "-pdc", str(cfg), "--dir_checkpoints", str(run), "--device", DEVICE,
        "--fused_ir", "--pallas_dw", "--n_pixels_by_us", "10",
        "--max_budget", "20", "-qs", "margin_sampling", "--pool_batch_size",
        str(POOL_BATCH), "--n_workers", "8", "--seed", "0",
        "--resume_campaign"], {})
    check(al.model is None, "--resume_campaign trained a stage")
    check(sum(counts.values()) == 0, f"--resume_campaign launched {counts}")
    check(al.dataset.n_pixels_total == 3 * 10 * N_IMAGES,
          f"{al.dataset.n_pixels_total} labelled pixels after the fast-forward")
    check([p.stat().st_mtime_ns for p in logs] == mtimes and len(logs) == 6,
          "--resume_campaign touched a round's logs or checkpoint")

    seen = {}
    train_epoch = driver.ALModel._train_epoch

    def first_epoch(self, epoch, step_fn):
        if not seen:
            seen.update(state_on_host(self.model))
        return train_epoch(self, epoch, step_fn)

    driver.ALModel._train_epoch = first_epoch
    try:
        al2, pre_s, counts2 = run_main_al([
            "-pdc", str(cfg), "--dir_checkpoints", str(work / "pretrained"),
            "--device", DEVICE, "--fused_ir", "--pallas_dw",
            "--n_pixels_by_us", "10", "--max_budget", "10",
            "--pool_batch_size", str(POOL_BATCH), "--n_workers", "8",
            "--seed", "0", "--debug", "--pretrained_ckpt", flax_ckpt], {})
    finally:
        driver.ALModel._train_epoch = train_epoch
    want = load_checkpoint(flax_ckpt, get_model(default_args_cv(work))) \
        .state_dict()
    differ = [k for k in want if not k.endswith("num_batches_tracked")
              and not torch.equal(seen[k], want[k].cpu())]
    check(not differ, f"round 0 starts off the file at {differ[:3]}")
    check(counts2["fused_fwd"] == 13 and counts2["fused_bwd"] == 13,
          f"the --debug epoch's launches {counts2}")
    print(f"[13] --resume_campaign fast-forwarded both rounds in "
          f"{resume_s:.1f} s (no launch, {al.dataset.n_pixels_total} labelled "
          f"pixels, logs untouched); --pretrained_ckpt: round 0 starts at "
          f"the file's {len(want)} tensors; a --debug round in {pre_s:.1f} s, "
          f"launches {counts2}")
    return {"resume_s": resume_s, "resume_launches": counts,
            "pretrained_s": pre_s, "pretrained_launches": counts2}

# ------------------------------ phase 14 ------------------------------

# the card's pipeline against its CPU run on the same draws, as
# tests/test_torch_device_pipeline.py holds the port to JAX: the picks,
# their labels, the valid masks and the overflow exactly; x on the
# normalised scale within PIPE_X_TOL, but for pixels where a round() sits
# on a .5 tie (one grey level apart), fewer than PIPE_TIE_SHARE of them
PIPE_X_TOL, PIPE_TIE_SHARE = 1e-4, 1e-4


def sample_with(pipe, indices, draws) -> dict:
    """``pipe.sample_batch(indices)`` on the given draws."""
    pipe.draw = lambda n, generator, hw=None: draws
    try:
        return pipe.sample_batch(indices, None)
    finally:
        del pipe.draw


def pipeline_card_vs_cpu(pipe, indices, seed: int) -> dict:
    """The device pipeline ``pipe`` (on the card) against its copy on the
    CPU, on the same draws (made on the card), with TF32 on in the process
    during the card's run: the pipeline's products must keep to strict
    f32 whatever the process's setting. ``ok`` says whether it held: a tie
    pixel within one grey level (``1 / (255 std)`` on the normalised
    scale)."""
    import torch

    rows = -(-len(indices) // pipe.pad_multiple) * pipe.pad_multiple
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    if pipe.hw is None:
        draws = pipe.draw(rows, gen)
    else:  # a variable-size set's geometry from each row's true size
        padded = list(indices) + [indices[-1]] * (rows - len(indices))
        draws = pipe.draw(rows, gen, pipe.hw[torch.as_tensor(
            padded, device=DEVICE)])
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = sample_with(pipe, indices, draws)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    host = sample_with(pipe.to("cpu"), indices,
                       {k: v.cpu() for k, v in draws.items()})
    err = (card["x"].cpu() - host["x"]).abs().amax(-1)
    off = err > PIPE_X_TOL
    out = {"rows": rows, "n_real": len(indices),
           "picks_equal": all(torch.equal(card[k].cpu(), host[k])
                              for k in ("coords", "labels", "valid")),
           "overflow": [int(card["overflow"]), int(host["overflow"])],
           "valid_picks": int(host["valid"].sum()),
           "x_max_abs_err": float(err.max()),
           "x_max_abs_err_outside_ties": float(err[~off].max()),
           "tie_pixels": int(off.sum()), "pixels": off.numel()}
    grey_level = 1.0 / (255.0 * float(pipe.std.min()))
    out["ok"] = (out["picks_equal"]
                 and out["overflow"][0] == out["overflow"][1]
                 and out["tie_pixels"] <= PIPE_TIE_SHARE * out["pixels"]
                 and out["x_max_abs_err"] <= grey_level + PIPE_X_TOL)
    return out


def phase_device_augment(work: Path, micro: dict) -> dict:
    """``main_al --device_augment`` at bs 48 / micro 4 for 3 epochs, one
    round (epoch 2 timed, epoch 3 under the profiler), then phase 8's
    host-loader run again for 2 epochs (epoch 2 timed): the host loader,
    the device pipeline and the host loader in turns in one call. The
    card's pipeline against its CPU run on a padded remainder batch; its
    device ms per batch of 48 (CUDA events) and its host ms to enqueue
    one."""
    import torch

    from pixelpick_tpu_torch.active import driver
    from pixelpick_tpu_torch.data import base as data_base, device_pipeline

    cfg = write_cfg(work, "cv_bs48", n_epochs=3, batch_size=48)
    record, opts, waits = {}, [], []
    make_optimizer = driver.make_optimizer
    get_flags = device_pipeline.HostCopy.get

    def kept(*a, **k):
        opts.append(make_optimizer(*a, **k))
        return opts[-1]

    def timed_get(self):
        """The micro-batch step's one wait per megabatch, for its row
        flags."""
        t0 = time.perf_counter()
        out = get_flags(self)
        waits.append(time.perf_counter() - t0)
        return out

    argv = ["--device", DEVICE, "--fused_ir", "--pallas_dw",
            "--micro_batch_size", "4", "--n_pixels_by_us", "10",
            "--max_budget", "10", "-qs", "margin_sampling",
            "--pool_batch_size", str(POOL_BATCH), "--n_workers", "8",
            "--seed", "0"]
    dropped = data_base.SPARSE_OVERFLOW_PIXELS
    driver.make_optimizer = kept
    device_pipeline.HostCopy.get = timed_get
    try:
        al, wall_s, counts = run_main_al(
            ["-pdc", str(cfg), "--dir_checkpoints", str(work / "devaug"),
             *argv, "--device_augment"], record, timed={(0, 2)},
            traced={(0, 3)})
    finally:
        driver.make_optimizer = make_optimizer
        device_pipeline.HostCopy.get = get_flags
    overflow = data_base.SPARSE_OVERFLOW_PIXELS - dropped
    pipe = al.device_pipe
    updates, per_epoch = opts[0].step_count, al._iters_per_epoch()
    rows = (work / "devaug" / "0_query" / "log_train.txt").read_text() \
        .split()[1:]
    busy, busy_us, by_name = record["busy"]
    ips = N_IMAGES / record["warm_epoch_s"]
    busy_share = busy_us / 1e6 / record["warm_epoch_s"]
    check(pipe is not None, "--device_augment built no pipeline")
    check(per_epoch == 92 and updates == 3 * 92,
          f"{updates} updates, {per_epoch} per epoch")
    check(counts["fused_fwd"] == 13 * updates
          and counts["fused_bwd"] == 13 * updates
          and counts["depthwise_kernel_dx"] == updates,
          f"device-augment launches {counts}")
    check(overflow == 0, f"the pipeline dropped {overflow} labelled pixels")
    check(len(rows) == 3 and all(np.isfinite(float(r.split(",")[3]))
                                 for r in rows), f"losses {rows}")
    for f in ("1_train.png", "3_train.png"):
        check((work / "devaug" / "0_query" / f).is_file(), f"{f} not written")
    check((work / "devaug" / "1_query" / "queries.pkl").is_file(),
          "the round's picks were not written")

    plan = al.loader.batch_index_plan(4)
    gens = [(torch.Generator(device=DEVICE).manual_seed(i),)
            for i in range(4)]
    pipe_ms = time_ms(lambda g: pipe.sample_batch(plan[0], g), gens, reps=10)
    enqueue_ms = []  # each from an idle device, so no full queue blocks it
    for g, in gens:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.sample_batch(plan[0], g)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(enqueue_ms)
    torch.cuda.synchronize()
    # the epoch's remainder (31 rows) cut to 11, padded to 12
    cmp = pipeline_card_vs_cpu(pipe, plan[-1][:11], seed=5)
    staged = pipe.staged_bytes
    del pipe, al
    torch.cuda.empty_cache()

    host_record = {}
    _, host_wall_s, host_counts = run_main_al(
        ["-pdc", str(write_cfg(work, "cv_bs48_2ep", n_epochs=2,
                               batch_size=48)),
         "--dir_checkpoints", str(work / "hostaug"), *argv], host_record,
        timed={(0, 2)})
    host_ips = N_IMAGES / host_record["warm_epoch_s"]
    check(host_counts["fused_fwd"] == 13 * 2 * 92
          and host_counts["depthwise_kernel_dx"] == 2 * 92,
          f"host-loader launches {host_counts}")
    print(f"[14] main_al --device_augment at bs 48 / micro 4, 3 epochs in "
          f"{wall_s:.1f} s: {updates} updates ({per_epoch} per epoch), "
          f"overflow {overflow}, launches {counts}; staged {staged} bytes; "
          f"warm epoch {record['warm_epoch_s']:.2f} s = {ips:.1f} train "
          f"images/s; in turns, the host loader's: phase 8 "
          f"{micro['train_images_per_s']:.1f}, again after it {host_ips:.1f};"
          f" epoch 3 under the profiler {record['traced_epoch_s']:.2f} s, "
          f"device busy {busy_us / 1e6:.2f} s = {100 * busy_share:.1f}% of "
          f"the untraced warm epoch (phase 8: "
          f"{100 * micro['device_busy_share_untraced_epoch']:.1f}%)")
    print(f"[14] the pipeline, a batch of 48: {pipe_ms:.3f} ms on the "
          f"device (CUDA events), {host_ms:.2f} ms of host time to enqueue; "
          f"the step's {len(waits)} reads of its row flags (one per "
          f"megabatch) waited {1e3 * sum(waits):.2f} ms in all, at most "
          f"{1e3 * max(waits):.3f} ms")
    print(f"[14] the card's pipeline against its CPU run, {cmp['n_real']} "
          f"rows padded to {cmp['rows']} (TF32 on in the process): picks "
          f"equal {cmp['picks_equal']} ({cmp['valid_picks']} valid), "
          f"overflow {cmp['overflow']}, x within "
          f"{cmp['x_max_abs_err_outside_ties']:.3g} outside "
          f"{cmp['tie_pixels']} tie pixels of {cmp['pixels']} (largest "
          f"{cmp['x_max_abs_err']:.3g})")
    top = print_top("[14]", by_name)
    check(cmp["ok"], f"the card's pipeline differs from its CPU run: {cmp}")
    return {"run_s": wall_s, "updates": updates,
            "updates_per_epoch": per_epoch, "launches": counts,
            "overflow": overflow, "staged_bytes": staged,
            "warm_epoch_s": record["warm_epoch_s"],
            "train_images_per_s": ips,
            "host_loader_images_per_s": [micro["train_images_per_s"],
                                         host_ips],
            "host_loader_run_s": host_wall_s,
            "host_loader_launches": host_counts,
            "peak_device_gb": record["peak_device_gb"],
            "traced_epoch_s": record["traced_epoch_s"],
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share_untraced_epoch": busy_share,
            "pipeline_ms_per_batch": pipe_ms,
            "pipeline_host_ms_per_batch": host_ms,
            "row_flag_waits_ms": [1e3 * w for w in waits],
            "card_vs_cpu": cmp, "top_device_ms": top}


# ------------------------------ phase 15 ------------------------------

CS_HW, CS_TRAIN, CS_VAL = (1024, 2048), 50, 6
CS_IDS = np.arange(34)  # labelIds 0-33; 19 of them are train ids


def make_synthetic_cityscapes(root: Path, seed: int = 0) -> None:
    """The raw Cityscapes layout at 1024x2048, city "aachen":
    leftImg8bit/{train,val}/ and gtFine/{train,val}/ PNGs, labelIds drawn
    from 0-33 in 64x128-pixel tiles, a colour per id (no noise, which
    would make the PNGs slow to write and read)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (len(CS_IDS), 3))
    h, w = CS_HW
    for split, count in (("train", CS_TRAIN), ("val", CS_VAL)):
        dx = root / "leftImg8bit" / split / "aachen"
        dy = root / "gtFine" / split / "aachen"
        dx.mkdir(parents=True)
        dy.mkdir(parents=True)
        for i in range(count):
            tiles = rng.choice(CS_IDS, (h // 64, w // 128))
            lab = np.repeat(np.repeat(tiles, 64, 0), 128, 1).astype(np.uint8)
            img = palette[lab]
            stem = f"aachen_{i:06d}_000019"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                dx / f"{stem}_leftImg8bit.png", compress_level=1)
            Image.fromarray(lab).save(dy / f"{stem}_gtFine_labelIds.png",
                                      compress_level=1)


def phase_cityscapes(work: Path) -> dict:
    """``main_al --dataset_name cs --device_augment`` at bs 48 / micro 4,
    2 epochs, one round with its sweep, on a synthetic 1024x2048 tree: the
    ds-4 train and the ds-2 val caches built by the dataset; every cached
    label a train id or void; 10 picks per image, none void; the
    kernels' launches."""
    import torch
    from PIL import Image

    from pixelpick_tpu_torch.active import codec, driver
    from pixelpick_tpu_torch.data.cityscapes import IGNORE

    root = work / "cityscapes"
    t0 = time.perf_counter()
    make_synthetic_cityscapes(root)
    write_s = time.perf_counter() - t0
    cfg = write_cfg(work, "cs_bs48", dataset="cs", n_epochs=2, batch_size=48,
                    dir_dataset=str(root))
    opts = []
    make_optimizer = driver.make_optimizer

    def kept(*a, **k):
        opts.append(make_optimizer(*a, **k))
        return opts[-1]

    driver.make_optimizer = kept
    try:
        al, wall_s, counts = run_main_al([
            "-pdc", str(cfg), "--dir_checkpoints", str(work / "cs_run"),
            "--device", DEVICE, "--fused_ir", "--pallas_dw",
            "--micro_batch_size", "4", "--device_augment",
            "--n_pixels_by_us", "10", "--max_budget", "10",
            "-qs", "margin_sampling", "--pool_batch_size", str(POOL_BATCH),
            "--n_workers", "8", "--seed", "0"], {})
    finally:
        driver.make_optimizer = make_optimizer
    updates, per_epoch = opts[0].step_count, al._iters_per_epoch()
    labels = {}
    for factor in (4, 2):
        for p in sorted(Path(f"{root}_d{factor}").glob("gtFine/*/*/*.png")):
            y = np.asarray(Image.open(p))
            labels[p] = int(y.max())
            check(y.max() <= IGNORE, f"{p}: label {y.max()} outside 0-19")
    n_cached = {f: len(list(Path(f"{root}_d{f}").glob("leftImg8bit/*/*/*")))
                for f in (4, 2)}
    check(n_cached == {4: CS_TRAIN + CS_VAL, 2: CS_TRAIN + CS_VAL},
          f"cached images {n_cached}")
    check(tuple(al.dataset.crop_size) == (256, 512)
          and al.dataset_val._load_x(0).shape == (512, 1024, 3),
          "the ds-4 train / ds-2 val sizes")
    with open(work / "cs_run" / "1_query" / "queries.pkl", "rb") as f:
        masks = codec.decode_queries(pkl.load(f), return_as_dict=True)
    check(len(masks) == CS_TRAIN, f"{len(masks)} images picked")
    for p, m in masks.items():
        gt = np.asarray(al.dataset._load_y(al.dataset.list_inputs.index(p)))
        check(int(m.sum()) == 10, f"{p}: {int(m.sum())} picks")
        check(not (gt[m] == IGNORE).any(), f"{p}: a void pick")
    check(per_epoch == 13 and updates == 2 * 13,
          f"{updates} updates, {per_epoch} per epoch")
    check(counts["fused_fwd"] == 13 * updates
          and counts["fused_bwd"] == 13 * updates
          and counts["depthwise_kernel_dx"] == updates,
          f"cityscapes launches {counts}")
    timing = json.loads((work / "cs_run" / "0_query" / "timing.json")
                        .read_text())
    staged = al.device_pipe.staged_bytes
    print(f"[15] synthetic Cityscapes {CS_HW[0]}x{CS_HW[1]} ({CS_TRAIN} "
          f"train, {CS_VAL} val) written in {write_s:.1f} s; main_al --"
          f"dataset_name cs --device_augment, 2 epochs and the sweep in "
          f"{wall_s:.1f} s (the ds-4 and ds-2 caches built inside it): "
          f"{updates} updates, launches {counts}; staged {staged} bytes; "
          f"{len(labels)} cached label maps in 0-19; 10 picks per image, "
          f"none void; train phase {timing['train']}")
    del al
    torch.cuda.empty_cache()
    return {"write_s": write_s, "run_s": wall_s, "updates": updates,
            "launches": counts, "staged_bytes": staged,
            "cached_label_maps": len(labels), "timing": timing}


# ------------------------------ phase 16 ------------------------------

VOC_TRAIN, VOC_VAL = 100, 20
# (h, w) at VOC's spread: landscape, portrait, wide and square
VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 500))


def make_synthetic_voc(root: Path, seed: int = 0) -> None:
    """A ``VOCdevkit/VOC2012`` tree: JPEGs at ``VOC_SIZES`` in turn,
    palette-mode (``P``) PNG labels of 64x64 class blocks 0-20 whose
    borders are void (255, 3 pixels wide), images coloured by class plus
    noise; ``VOC_TRAIN`` train and ``VOC_VAL`` val names."""
    from PIL import Image

    from pixelpick_tpu_torch.utils.palettes import PALETTE_VOC

    base = root / "VOCdevkit" / "VOC2012"
    for d in ("ImageSets/Segmentation", "JPEGImages", "SegmentationClass"):
        (base / d).mkdir(parents=True, exist_ok=True)
    palette = np.zeros((256, 3), np.uint8)
    for k, c in PALETTE_VOC.items():
        palette[k] = c
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (21, 3))
    names = []
    for i in range(VOC_TRAIN + VOC_VAL):
        h, w = VOC_SIZES[i % len(VOC_SIZES)]
        tiles = rng.integers(0, 21, (-(-h // 64), -(-w // 64)))
        lab = np.kron(tiles, np.ones((64, 64), np.int64))[:h, :w]
        edge = np.zeros((h, w), bool)
        edge[1:] |= lab[1:] != lab[:-1]
        edge[:, 1:] |= lab[:, 1:] != lab[:, :-1]
        for _ in range(1):  # widen the borders to 3 pixels
            edge[1:] |= edge[:-1].copy()
            edge[:, 1:] |= edge[:, :-1].copy()
            edge[:-1] |= edge[1:].copy()
        x = np.clip(colours[lab] + rng.normal(0, 25, (h, w, 3)), 0, 255)
        name = f"2012_{i:06d}"
        Image.fromarray(x.astype(np.uint8)).save(
            base / "JPEGImages" / f"{name}.jpg", quality=90)
        y = Image.frombytes("P", (w, h),
                            np.where(edge, 255, lab).astype(np.uint8).tobytes())
        y.putpalette(palette.reshape(-1).tolist())
        y.save(base / "SegmentationClass" / f"{name}.png")
        names.append(name)
    for split, part in (("train", names[:VOC_TRAIN]),
                        ("val", names[VOC_TRAIN:])):
        (base / "ImageSets" / "Segmentation" / f"{split}.txt").write_text(
            "\n".join(part) + "\n")


# the library's dense products by kernel name: cuDNN's convolutions (direct,
# implicit-GEMM, FFT and Winograd, their data and weight gradients) and
# cuBLAS's GEMMs (the 1x1 convs, resizes and the FFT convs' complex GEMMs)
PRODUCT_KERNELS = ("gemm", "xmma", "fft", "conv", "dgrad", "wgrad",
                   "winograd", "region_transform", "cudnn")


def product_share(by_name: dict) -> float:
    """The share of a trace's kernel time in the library's products."""
    total = sum(t for t, _ in by_name.values())
    prod = sum(t for name, (t, _) in by_name.items()
               if any(k in name.lower() for k in PRODUCT_KERNELS))
    return prod / total if total else float("nan")


def voc_round(work: Path, name: str, flags: list):
    """``main_al`` on the synthetic VOC tree at bs 10 and 320x320 crops, 3
    epochs and one round with its sweep (``flags`` choose the network):
    epoch 2 timed with the peak device memory, epoch 3 under the profiler;
    the sweep timed. Checks the artifacts, finite losses and 10 non-void
    picks per image inside the image (none in a bucket's padding).
    Returns (the measures, the driver)."""
    from PIL import Image

    from pixelpick_tpu_torch.active import driver

    run = work / name
    cfg = write_cfg(work, "voc_bs10", dataset="voc", n_epochs=3,
                    dir_dataset=str(work / "voc"))
    record, sweeps = {}, []
    call = driver.QuerySelector.__call__

    def timed_sweep(self, *a, **k):
        import torch

        t0 = time.perf_counter()
        out = call(self, *a, **k)
        torch.cuda.synchronize()
        sweeps.append(time.perf_counter() - t0)
        return out

    driver.QuerySelector.__call__ = timed_sweep
    try:
        al, wall_s, counts = run_main_al([
            "-pdc", str(cfg), "--dir_checkpoints", str(run), "--device",
            DEVICE, *flags, "--n_pixels_by_us", "10", "--max_budget", "10",
            "-qs", "margin_sampling", "--pool_batch_size", str(POOL_BATCH),
            "--n_workers", "8", "--seed", "0"], record,
            timed={(0, 2)}, traced={(0, 3)})
    finally:
        driver.QuerySelector.__call__ = call
    for f in ("0_query/log_train.txt", "0_query/log_val.txt", "0_query/best_miou_model.ckpt",
              "0_query/timing.json", "0_query/query_stats.pkl",
              "1_query/label.pkl"):
        check((run / f).is_file(), f"{name}: {f} not written")
    rows = (run / "0_query" / "log_train.txt").read_text().split()[1:]
    check(len(rows) == 3 and all(np.isfinite(float(r.split(",")[3]))
                                 for r in rows), f"{name} losses {rows}")
    # the initial picks, cached beside the data by the first run
    with open(work / "voc" / "init_labelled_pixels_0.pkl", "rb") as f:
        first = pkl.load(f)
    with open(run / "1_query" / "label.pkl", "rb") as f:
        merged = pkl.load(f)
    check(len(merged) == VOC_TRAIN, f"{name}: {len(merged)} masks")
    for i, (q0, q1) in enumerate(zip(first, merged)):
        y = Image.open(al.dataset.list_labels[i])
        gt = np.asarray(y.resize(q1.shape[::-1], Image.NEAREST))
        new = q1 & ~q0
        check(q0.sum() == 10 and int(new.sum()) == 10 and (q0 <= q1).all(),
              f"{name} image {i}: {int(new.sum())} new picks")
        check(not (gt[new] == 255).any(), f"{name} image {i}: a void pick")
    steps = 3 * (VOC_TRAIN // VOC_BATCH)
    busy, busy_us, by_name = record["busy"]
    timing = json.loads((run / "0_query" / "timing.json").read_text())
    out = {"run_s": wall_s, "launches": counts, "steps": steps,
           "warm_epoch_s": record["warm_epoch_s"],
           "train_images_per_s": VOC_TRAIN / record["warm_epoch_s"],
           "peak_device_gb": record["peak_device_gb"],
           "traced_epoch_s": record["traced_epoch_s"],
           "device_busy_share": busy,
           "device_ms_per_step": busy_us / 1e3 / (VOC_TRAIN // VOC_BATCH),
           "device_busy_share_untraced_epoch":
               busy_us / 1e6 / record["warm_epoch_s"],
           "sweep_s": sweeps[0], "sweep_images_per_s": VOC_TRAIN / sweeps[0],
           "val_images_per_s": timing["val"]["items_per_sec"],
           "best_miou": max(float(r.split(",")[1]) for r in (
               run / "0_query" / "log_val.txt").read_text().split()[1:]),
           "product_share": product_share(by_name),
           "top_device_ms": print_top(f"[{name}]", by_name, 8)}
    print(f"[{name}] {wall_s:.1f} s for 3 epochs and the sweep; warm epoch "
          f"{out['train_images_per_s']:.1f} train images/s, "
          f"{out['device_ms_per_step']:.1f} device ms per step, device busy "
          + (f"{100 * busy:.1f}% (traced), "
             f"{100 * out['device_busy_share_untraced_epoch']:.1f}% of the "
             f"untraced epoch" if busy is not None else "not measured")
          + f", {100 * out['product_share']:.1f}% of it in the library's "
          f"convolutions and GEMMs; peak {out['peak_device_gb']:.2f} GB; sweep "
          f"{out['sweep_images_per_s']:.1f} images/s, validation "
          f"{out['val_images_per_s']:.1f} images/s; launches {counts}; 10 "
          f"non-void picks per image, none in padding")
    return out, al


def phase_voc_deeplab(work: Path) -> dict:
    """``main_al --dataset_name voc --fused_ir --pallas_dw``: the three
    kernels at VOC's shapes on the main path (13 fused launches of each
    kind and one depthwise dx per update)."""
    t0 = time.perf_counter()
    make_synthetic_voc(work / "voc")
    write_s = time.perf_counter() - t0
    out, _ = voc_round(work, "voc_deeplab", ["--fused_ir", "--pallas_dw"])
    c, steps = out["launches"], out["steps"]
    check(c["fused_fwd"] == 13 * steps and c["fused_bwd"] == 13 * steps
          and c["depthwise_kernel_dx"] == steps
          and c["depthwise_kernel"] >= steps, f"VOC launches {c}")
    out["write_s"] = write_s
    return out


# ------------------------------ phase 17 ------------------------------

def phase_voc_fpn(work: Path) -> dict:
    """``main_al --network_name FPN --n_layers 50`` (dilated) on phase 16's
    tree; the eval CLI on its best checkpoint (the stage's best mIoU
    again); a --debug round with ``--pretrained_ckpt`` from a file the
    port's convert CLI wrote from a random torchvision-layout ResNet-50
    (every encoder entry overlaid, the stem's weights the file's)."""
    import torch

    from pixelpick_tpu_torch.active import driver
    from pixelpick_tpu_torch.cli.eval import main as eval_main
    from pixelpick_tpu_torch.models import convert
    from pixelpick_tpu_torch.models.resnet import ResNetBackbone

    fpn = ["--network_name", "FPN", "--n_layers", "50"]
    out, _ = voc_round(work, "voc_fpn", fpn)
    check(sum(out["launches"].values()) == 0,
          f"the FPN path launched {out['launches']}")
    cfg = work / "voc_bs10.yaml"
    t0 = time.perf_counter()
    scores, _ = eval_main([
        "-pdc", str(cfg), "--dir_checkpoints", str(work / "voc_fpn_eval"),
        "--device", DEVICE, *fpn, "--n_workers", "8", "--p_state_dict",
        str(work / "voc_fpn" / "0_query" / "best_miou_model.ckpt")])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    check(abs(scores["Mean IoU"] - out["best_miou"]) <= 1e-4,
          f"eval CLI mIoU {scores['Mean IoU']} vs the stage's best "
          f"{out['best_miou']}")

    g = torch.Generator().manual_seed(5)
    tv = {k.replace("prefix.", ""): torch.randn(v.shape, generator=g)
          if v.is_floating_point() else v
          for k, v in ResNetBackbone(50).state_dict().items()}
    tv["fc.weight"] = torch.randn((1000, 2048), generator=g)
    tv["fc.bias"] = torch.zeros(1000)
    torch.save(tv, work / "resnet50_tv.pth")
    ckpt = convert.main([str(work / "resnet50_tv.pth"),
                         str(work / "resnet50.ckpt"), "--kind", "resnet"])
    seen = {}
    load = driver.load_pretrained_ckpt

    def kept(model, path):
        seen["keys"] = load(model, path)
        seen["encoder"] = [k for k in model.state_dict()
                           if k.startswith("encoder.")]
        seen["stem"] = model.encoder.base.prefix.conv1.weight.detach().cpu() \
            .clone()
        return seen["keys"]

    driver.load_pretrained_ckpt = kept
    try:
        _, pre_s, _ = run_main_al([
            "-pdc", str(cfg), "--dir_checkpoints", str(work / "voc_fpn_pre"),
            "--device", DEVICE, *fpn, "--n_pixels_by_us", "10",
            "--max_budget", "10", "--pool_batch_size", str(POOL_BATCH),
            "--n_workers", "8", "--seed", "0", "--debug",
            "--pretrained_ckpt", ckpt], {})
    finally:
        driver.load_pretrained_ckpt = load
    check(sorted(seen["keys"]) == sorted(seen["encoder"]),
          f"{len(seen['keys'])} entries overlaid, the encoder has "
          f"{len(seen['encoder'])}")
    check(torch.equal(seen["stem"], tv["conv1.weight"]),
          "the stem's weights are not the file's")
    print(f"[17] eval CLI on the best checkpoint: mIoU "
          f"{scores['Mean IoU']:.4f} (the stage's best {out['best_miou']:.4f})"
          f", {VOC_VAL / eval_s:.1f} validation images/s with the model "
          f"build; --pretrained_ckpt from the convert CLI's resnet file: "
          f"{len(seen['keys'])} entries overlaid = the encoder's, a --debug "
          f"round in {pre_s:.1f} s")
    out.update(eval_s=eval_s, eval_miou=scores["Mean IoU"],
               pretrained_s=pre_s, pretrained_keys=len(seen["keys"]))
    return out


# ------------------------------ phase 18 ------------------------------

def phase_voc_device_augment(work: Path, voc: dict) -> dict:
    """``main_al --dataset_name voc --device_augment --fused_ir
    --pallas_dw`` on phase 16's tree, phase 16's measures beside its host
    loader's in the same call: the train set staged padded to the largest
    base-resized size beside the true sizes, 13 fused launches of each
    kind and one depthwise dx per update, no labelled pixel dropped; the
    card's pipeline against its CPU run on a padded remainder (TF32 on in
    the process); the pipeline's device ms per batch of 10 (CUDA events)
    and its host ms to enqueue one."""
    import torch

    from pixelpick_tpu_torch.data import base as data_base

    dropped = data_base.SPARSE_OVERFLOW_PIXELS
    out, al = voc_round(work, "voc_devaug",
                        ["--fused_ir", "--pallas_dw", "--device_augment"])
    overflow = data_base.SPARSE_OVERFLOW_PIXELS - dropped
    pipe = al.device_pipe
    c, steps = out["launches"], out["steps"]
    check(pipe is not None and pipe.hw is not None,
          "--device_augment on VOC staged no variable-size pipeline")
    check(c["fused_fwd"] == 13 * steps and c["fused_bwd"] == 13 * steps
          and c["depthwise_kernel_dx"] == steps
          and c["depthwise_kernel"] >= steps, f"VOC device launches {c}")
    check(overflow == 0, f"the pipeline dropped {overflow} labelled pixels")
    hw = pipe.hw.cpu().numpy()
    staging = tuple(pipe.images.shape[1:3])
    check(staging == tuple(hw.max(0)) and (hw.max(1) == 400).all(),
          f"staging {staging}, true sizes {sorted(set(map(tuple, hw)))}")
    plan = al.loader.batch_index_plan(4)
    gens = [(torch.Generator(device=DEVICE).manual_seed(i),)
            for i in range(4)]
    pipe_ms = time_ms(lambda g: pipe.sample_batch(plan[0], g), gens, reps=10)
    enqueue_ms = []
    for g, in gens:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.sample_batch(plan[0], g)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(enqueue_ms)
    torch.cuda.synchronize()
    pipe.pad_multiple = 4  # a remainder of 7 padded to 8
    cmp = pipeline_card_vs_cpu(pipe, plan[1][:7], seed=5)
    staged = pipe.staged_bytes
    del pipe, al
    torch.cuda.empty_cache()
    out.update(overflow=overflow, staged_bytes=staged, staging_hw=staging,
               pipeline_ms_per_batch=pipe_ms,
               pipeline_host_ms_per_batch=host_ms, card_vs_cpu=cmp,
               host_loader_images_per_s=voc["train_images_per_s"],
               host_loader_busy_share=voc["device_busy_share_untraced_epoch"])
    print(f"[18] VOC --device_augment: {out['train_images_per_s']:.1f} train "
          f"images/s, device busy "
          f"{100 * out['device_busy_share_untraced_epoch']:.1f}% of the "
          f"untraced warm epoch; phase 16's host loader in this call "
          f"{voc['train_images_per_s']:.1f} images/s, "
          f"{100 * voc['device_busy_share_untraced_epoch']:.1f}%; staged "
          f"{staged} bytes at {staging[0]}x{staging[1]}; the pipeline "
          f"{pipe_ms:.3f} device ms and {host_ms:.2f} host ms per batch of "
          f"{VOC_BATCH}; overflow {overflow}")
    print(f"[18] the card's pipeline against its CPU run, {cmp['n_real']} "
          f"rows padded to {cmp['rows']} (TF32 on in the process): picks "
          f"equal {cmp['picks_equal']} ({cmp['valid_picks']} valid), "
          f"overflow {cmp['overflow']}, x within "
          f"{cmp['x_max_abs_err_outside_ties']:.3g} outside "
          f"{cmp['tie_pixels']} tie pixels of {cmp['pixels']} (largest "
          f"{cmp['x_max_abs_err']:.3g})")
    check(cmp["ok"], f"the card's VOC pipeline differs from its CPU run: "
                     f"{cmp}")
    return out


# ------------------------------ phase 19 ------------------------------

DP_WORLD, DP_BATCH, DP_TIMEOUT = 2, 8, 600
DP_TRAIN, DP_VAL = 48, 8
# the files a main_al round writes into its {n}_query directory
STAGE_FILES = ("1_train.png", "1_val.png", "best_miou_model.ckpt",
               "log_train.txt", "log_val.txt", "queries.pkl",
               "query_stats.pkl", "timing.json")


def dp_args(work: Path, **overrides):
    """The CamVid arguments of phase 19's step (width 1.0, --pallas_dw)."""
    from pixelpick_tpu_torch.config import default_args

    return default_args(
        dataset_name="cv", dir_dataset=str(work / "camvid"),
        dir_checkpoints=str(work / "dp_step"), device=DEVICE, pallas_dw=True,
        width_multiplier=1.0, precision="f32", **overrides)


def run_workers(jobs: list, log: Path) -> None:
    """``chip_smoke.py --worker JOB`` for each job at once; waits for all,
    stops them all if one fails or outlasts DP_TIMEOUT, and fails then
    with the end of their log."""
    procs = []
    with open(log, "w") as out:
        try:
            for job in jobs:
                procs.append(subprocess.Popen(
                    [sys.executable, str(HERE / "chip_smoke.py"), "--worker",
                     json.dumps(job)], cwd=HERE, stdout=out,
                    stderr=subprocess.STDOUT))
            deadline = time.monotonic() + DP_TIMEOUT
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    check(all(rc == 0 for rc in rcs),
          f"ranks exited {rcs}:\n{log.read_text()[-6000:]}")


def _join(job: dict, backend: str = "gloo") -> None:
    from types import SimpleNamespace

    from pixelpick_tpu_torch.parallel import distributed

    distributed.initialize_from_args(SimpleNamespace(
        dist_coordinator=f"localhost:{job['port']}",
        dist_num_processes=job["world"], dist_process_id=job["rank"],
        device=DEVICE, dist_backend=backend, data_parallel=0))


def dp_step(model, args, batch: dict, shard=None) -> dict:
    """One sparse step of ``model`` on ``batch`` (this rank's rows under
    ``shard``), the depthwise kernel's launches counted: the loss, the
    confusion matrix, every gradient and the state after the update, on
    the CPU; then five more steps, each timed to its synchronisation."""
    import torch

    from pixelpick_tpu_torch.engine.optim import make_optimizer
    from pixelpick_tpu_torch.engine.trainer import (
        batch_to_device, make_train_step,
    )
    from pixelpick_tpu_torch.ops import depthwise as dw

    step = make_train_step(model, make_optimizer(args, model, 92),
                           n_classes=N_CLASSES, mean=args.mean, std=args.std)
    dev = batch_to_device(batch, DEVICE)
    torch.cuda.synchronize()
    dw.reset_launch_counts()
    loss, hist = step(dev, shard)
    torch.cuda.synchronize()
    out = {"loss": float(loss), "hist": hist.cpu().numpy(),
           "launches": dict(dw.launch_counts),
           "grads": {n: p.grad.detach().cpu() for n, p in
                     model.named_parameters() if p.grad is not None},
           "state": {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}}
    out["step_ms"] = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(dev, shard)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def dp_model(args, weights):
    """The full-width DeepLab at ``weights`` in train mode, its dropouts on
    a card generator seeded 5."""
    import torch

    from pixelpick_tpu_torch.models.factory import get_model

    model = get_model(args, DEVICE, seed=11)
    model.load_state_dict(weights)
    model.set_dropout_generator(
        torch.Generator(device=DEVICE).manual_seed(5))
    return model.train()


def worker_main(job: dict) -> int:
    """One rank of phase 19, 21 or 23 (``--worker``): ``step`` runs the bs-8
    step on its rows over gloo; ``campaign`` calls ``cli.main_al.main``
    with the ranks' flags, its kernels' launches counted; ``nccl`` joins an
    NCCL world of one and runs its collectives; ``spatial`` runs entry
    points with the ranks' flags (``spatial_ranks``)."""
    import torch

    import_port()
    from pixelpick_tpu_torch.ops import depthwise as dw, fused_ir
    from pixelpick_tpu_torch.parallel import distributed, mesh

    out = {"rank": job["rank"]}
    if job["kind"] == "step":
        _join(job)
        args = dp_args(Path(job["work"]))
        payload = torch.load(job["input"], weights_only=False)
        model = dp_model(args, payload["weights"])
        shard = mesh.row_shard(DP_BATCH)
        res = dp_step(model, args, mesh.shard_batch(payload["batch"], shard),
                      shard)
        out["launches"], out["step_ms"] = res["launches"], res["step_ms"]
        if distributed.is_primary():
            torch.save(res, job["output"])
        distributed.shutdown()
    elif job["kind"] == "campaign":
        from pixelpick_tpu_torch.cli.main_al import main as main_al

        fused_ir.reset_launch_counts()
        dw.reset_launch_counts()
        main_al(job["argv"] + [
            "--dist_coordinator", f"localhost:{job['port']}",
            "--dist_num_processes", str(job["world"]), "--dist_process_id",
            str(job["rank"]), "--dist_backend", "gloo"])
        torch.cuda.synchronize()
        out["launches"] = {**fused_ir.launch_counts, **{
            f"depthwise_{k}": v for k, v in dw.launch_counts.items()}}
    elif job["kind"] == "spatial":
        out.update(spatial_ranks(job))
    else:
        _join(job, backend="auto")
        t = torch.arange(4.0, device=DEVICE)
        torch.distributed.all_reduce(t)
        distributed.barrier()
        out.update(backend=torch.distributed.get_backend(),
                   all_reduce_ok=bool(torch.equal(t.cpu(), torch.arange(4.0))),
                   gathered=distributed.all_gather_object(job["rank"]))
        distributed.shutdown()
    Path(job["report"]).write_text(json.dumps(out))
    return 0


def phase_data_parallel(work: Path) -> dict:
    """Two ranks on the one card over gloo (``--dist_backend gloo``; NCCL
    refuses two ranks on one device): a bs-8 step at full width with
    ``--pallas_dw``, each rank on 4 rows, against the single-process step
    at the same weights, batch and dropout stream (the loss and every
    gradient to phase 6's limits, the running statistics within 1e-4 of
    their scale, the confusion matrices exactly; the depthwise kernel's
    launches on every rank); then ``main_al`` as two ranks, 1 epoch and 2
    rounds on a 48-image CamVid at bs 8, which writes every artifact once;
    then an NCCL world of one through ``init_process_group``. The ranks'
    times share one card: they say nothing of scaling."""
    import torch

    from pixelpick_tpu_torch.parallel.distributed import free_port

    from pixelpick_tpu_torch.models.factory import get_model

    dpw = work / "dp"
    dpw.mkdir()
    args = dp_args(work)
    model = get_model(args, DEVICE, seed=11)
    well_conditioned_(model, seed=12)
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    model = dp_model(args, weights)
    batch = train_batch(np.random.default_rng(19), DP_BATCH)
    torch.save({"weights": weights, "batch": batch}, dpw / "step_in.pt")
    ref = dp_step(model, args, batch)
    del model
    port = free_port()
    jobs = [dict(kind="step", rank=r, world=DP_WORLD, port=port,
                 work=str(work), input=str(dpw / "step_in.pt"),
                 output=str(dpw / "step_out.pt"),
                 report=str(dpw / f"step_{r}.json"))
            for r in range(DP_WORLD)]
    run_workers(jobs, dpw / "step.log")
    got = torch.load(dpw / "step_out.pt", weights_only=False)
    reports = [json.loads((dpw / f"step_{r}.json").read_text())
               for r in range(DP_WORLD)]
    rank_launches = [r["launches"] for r in reports]
    single_ms = statistics.median(ref["step_ms"])
    ranks_ms = statistics.median(reports[0]["step_ms"])
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    grad_err = max(float((got["grads"][n] - g).abs().max())
                   / (STEP_GRAD_TOL * float(g.abs().max())
                      + STEP_GRAD_FLOOR * gmax)
                   for n, g in ref["grads"].items())
    stat_err = max(float((got["state"][k] - v).abs().max())
                   / (1e-4 * max(float(v.abs().max()), 1.0))
                   for k, v in ref["state"].items()
                   if k.endswith(("running_mean", "running_var")))
    print(f"[19] a bs-{DP_BATCH} step on two ranks of one card (gloo) "
          f"against one process: loss {got['loss']:.7f} vs "
          f"{ref['loss']:.7f} (relative {loss_err:.3g}); the worst "
          f"gradient leaf at {grad_err:.3g} of its limit, the running "
          f"statistics at {stat_err:.3g} of theirs; confusion matrices "
          f"equal {np.array_equal(got['hist'], ref['hist'])}; depthwise "
          f"launches per rank {rank_launches} (one process "
          f"{ref['launches']}); a step of 8 rows {ranks_ms:.2f} ms on the "
          f"two ranks sharing the card (median of 5), {single_ms:.2f} ms in "
          f"one process: not a measure of scaling")
    check(set(got["grads"]) == set(ref["grads"]), "gradient leaves differ")
    check(loss_err <= STEP_LOSS_TOL, f"loss {got['loss']} vs {ref['loss']}")
    check(grad_err <= 1, f"gradients off: {grad_err}")
    check(stat_err <= 1, f"running statistics off: {stat_err}")
    check(np.array_equal(got["hist"], ref["hist"]), "histograms differ")
    check(all(c == ref["launches"] and c["kernel"] > 0 and c["kernel_dx"] > 0
              for c in rank_launches), f"depthwise launches {rank_launches}")

    make_synthetic_camvid(work / "camvid_dp", DP_TRAIN, DP_VAL, seed=3)
    cfg = write_cfg(work, "cv_dp", n_epochs=1, batch_size=DP_BATCH,
                    dir_dataset=str(work / "camvid_dp"))
    run = work / "dp_campaign"
    argv = ["-pdc", str(cfg), "--dir_checkpoints", str(run), "--device",
            DEVICE, "--pallas_dw", "--n_pixels_by_us", "10", "--max_budget",
            "20", "-qs", "margin_sampling", "--pool_batch_size",
            str(POOL_BATCH), "--n_workers", "4", "--seed", "0"]
    port = free_port()
    jobs = [dict(kind="campaign", rank=r, world=DP_WORLD, port=port,
                 argv=argv, report=str(dpw / f"campaign_{r}.json"))
            for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    run_workers(jobs, dpw / "campaign.log")
    campaign_s = time.perf_counter() - t0
    camp_launches = [json.loads((dpw / f"campaign_{r}.json").read_text())
                     ["launches"] for r in range(DP_WORLD)]
    files = sorted(str(p.relative_to(run)) for p in run.rglob("*")
                   if p.is_file())
    want = sorted(["args.txt", "2_query/queries.pkl",
                   *(f"{r}_query/{f}" for r in (0, 1) for f in STAGE_FILES)])
    rows = {f"{r}_query/{f}": (run / f"{r}_query" / f).read_text().split()
            for r in (0, 1) for f in ("log_train.txt", "log_val.txt")}
    print(f"[19] main_al as two ranks, 1 epoch and 2 rounds at bs "
          f"{DP_BATCH} on {DP_TRAIN} images: {campaign_s:.1f} s with the "
          f"ranks' start; {len(files)} files (each log one row per epoch: "
          f"{ {k: len(v) - 1 for k, v in rows.items()} }); launches per rank "
          f"{camp_launches}")
    check(files == want, f"campaign files {files}")
    check(all(len(v) == 2 and np.isfinite(float(v[1].split(",")[-1]))
              for v in rows.values()), f"campaign logs {rows}")
    # the primary alone renders the train PNGs, with the eval step
    check(all(c["depthwise_kernel"] > 0 and c["depthwise_kernel_dx"] > 0
              and c["depthwise_kernel_dx"]
              == camp_launches[0]["depthwise_kernel_dx"]
              for c in camp_launches), f"campaign launches {camp_launches}")

    jobs = [dict(kind="nccl", rank=0, world=1, port=free_port(),
                 report=str(dpw / "nccl.json"))]
    run_workers(jobs, dpw / "nccl.log")
    nccl = json.loads((dpw / "nccl.json").read_text())
    print(f"[19] an NCCL world of one: backend {nccl['backend']}, "
          f"all-reduce {nccl['all_reduce_ok']}, gathered {nccl['gathered']}")
    check(nccl["backend"] == "nccl" and nccl["all_reduce_ok"]
          and nccl["gathered"] == [0], f"NCCL world of one: {nccl}")
    return {"step_loss": [got["loss"], ref["loss"]], "loss_rel_err": loss_err,
            "grad_err_over_tol": grad_err, "stat_err_over_tol": stat_err,
            "step_launches_per_rank": rank_launches,
            "step_launches_single": ref["launches"],
            "step_ms_two_ranks_one_card": [r["step_ms"] for r in reports],
            "step_ms_single": ref["step_ms"],
            "campaign_s": campaign_s, "campaign_launches": camp_launches,
            "campaign_files": files, "nccl": nccl}


# ------------------------------ phase 20 ------------------------------

# the s2d sweep against phase 3's path. The picks are a random sub-sample
# of each image's k best-scored pixels (top_n_percent): where the two
# sides' candidate sets are equal their picks must be; where they differ,
# every pixel in one set only must score, on either side, within
# PICK_TIE_TOL of that side's k-th score (a near-tie at the boundary, which
# may change the whole sub-sample). Margins lie in [0, 1]; the logits of
# the two paths differ by about 1e-5 of their scale (phase 3's MODEL_TOL)
PICK_TIE_TOL = 1e-4


def step_check(model, batch: dict, args) -> dict:
    """Phase 6's check on ``model`` (train mode, dropout off): the sparse
    loss of ``batch`` and every parameter gradient, the running statistics
    after the forward, and the kernels' launches in it."""
    import torch

    from pixelpick_tpu_torch.engine.trainer import (
        normalize_images, sparse_ce_and_hist,
    )
    from pixelpick_tpu_torch.ops import depthwise as dw, fused_ir

    torch.cuda.synchronize()
    fused_ir.reset_launch_counts()
    dw.reset_launch_counts()
    x = normalize_images(batch["x"], args.mean, args.std)
    loss, _ = sparse_ce_and_hist(model(x, upsample=False)["pred"],
                                 batch["coords"], batch["labels"],
                                 batch["valid"], IMAGE_HW, N_CLASSES)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    return {"loss": float(loss.detach()),
            "grads": {n: g.detach() for n, g in zip(names, grads)},
            "stats": {k: v.detach().clone() for k, v in
                      model.state_dict().items()
                      if k.endswith(("running_mean", "running_var",
                                     "num_batches_tracked"))},
            "launches": {**fused_ir.launch_counts,
                         **{f"depthwise_{k}": v
                            for k, v in dw.launch_counts.items()}}}


def step_errors(got: dict, ref: dict) -> dict:
    """``got`` against ``ref`` at phase 6's limits: the loss relative, each
    gradient over STEP_GRAD_TOL of its own largest |value| plus
    STEP_GRAD_FLOOR of the largest gradient, each running statistic over
    1e-4 of its largest |value| (at least 1), as phase 19; the worst leaf
    of each, and whether the forward counts agree."""
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    grads = sorted(((float((got["grads"][n] - g).abs().max())
                     / (STEP_GRAD_TOL * float(g.abs().max())
                        + STEP_GRAD_FLOOR * gmax), n)
                    for n, g in ref["grads"].items()), reverse=True)
    stats = sorted(((float((got["stats"][k] - v).abs().max())
                     / (1e-4 * max(float(v.abs().max()), 1.0)), k)
                    for k, v in ref["stats"].items()
                    if v.is_floating_point()), reverse=True)
    return {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_worst": grads[0], "stats_worst": stats[0],
            "counts_equal": all(int(got["stats"][k]) == int(v)
                                for k, v in ref["stats"].items()
                                if not v.is_floating_point())}


def leafwise_within(got: dict, ref: dict, noise: dict) -> bool:
    """Every gradient and running statistic of ``got`` no further from
    ``ref`` than ``noise`` (a second run of ``ref``'s build) is."""
    return all(float((got[part][k] - v).abs().max())
               <= float((noise[part][k] - v).abs().max())
               for part in ("grads", "stats") for k, v in ref[part].items()
               if v.is_floating_point())


def sweep_picks(model, dataset, args) -> dict:
    """The round's scoring over the pool at its present masks with the
    selector's round-0 draws: each image's picks (flat indices) and its
    candidates' ranking scores (what ``_select_topk`` ranks), and the
    depthwise kernel's launches. Nothing is labelled."""
    import torch

    from pixelpick_tpu_torch.active import acquisition
    from pixelpick_tpu_torch.active.selector import QuerySelector
    from pixelpick_tpu_torch.data.loader import Loader
    from pixelpick_tpu_torch.ops import depthwise as dw

    scores = []
    select = acquisition._select_topk

    def recording(uc_flat, *a, strategy, **k):
        signed = uc_flat if strategy in acquisition.MAXIMIZING else -uc_flat
        scores.append(signed.detach())
        return select(uc_flat, *a, strategy=strategy, **k)

    picks = []
    generator = torch.Generator(device=DEVICE).manual_seed(
        (args.seed * 1_000_003) & 0x7FFFFFFF)  # QuerySelector's round 0
    with Loader(dataset, POOL_BATCH, mode="query",
                n_workers=args.n_workers) as loader:
        score_fn = QuerySelector(args, loader, model, DEVICE)._score_fn
        acquisition._select_topk = recording
        try:
            torch.cuda.synchronize()
            dw.reset_launch_counts()
            n_forwards = 0
            for batch in loader:
                dev = {k: torch.from_numpy(batch[k]).to(DEVICE)
                       for k in ("x", "excluded", "y")}
                picks.append(score_fn(dev, generator)[0])
                n_forwards += 1
            torch.cuda.synchronize()
            counts = dict(dw.launch_counts)
        finally:
            acquisition._select_topk = select
    return {"picks": torch.cat(picks).cpu().numpy(),
            "scores": torch.cat(scores), "n_forwards": n_forwards,
            "launches": counts}


def as_masks(idx, shape):
    """(N, n) flat indices -> (N, H*W) bool masks on the card."""
    import torch

    idx = torch.as_tensor(idx, device=DEVICE)
    return torch.zeros(shape, dtype=torch.bool, device=DEVICE).scatter_(
        1, idx, True)


def picks_agree(got: dict, ref: dict, k: int) -> dict:
    """Two sweeps' picks under the rule at PICK_TIE_TOL: the images whose
    candidate sets differ, those whose picks differ, the largest distance
    of a pixel in one candidate set only from its side's k-th score, and
    whether picks differ where the candidate sets do not."""
    import torch

    shape = ref["scores"].shape
    cand = {}
    for name, sw in (("got", got), ("ref", ref)):
        top = torch.topk(sw["scores"], k, dim=1)
        cand[name] = (as_masks(top.indices, shape), top.values[:, -1:])
    only = cand["got"][0] ^ cand["ref"][0]
    picks_differ = (as_masks(got["picks"], shape)
                    ^ as_masks(ref["picks"], shape)).any(1)
    cands_differ = only.any(1)
    gap = torch.zeros((), device=DEVICE)
    for sw, (_, kth) in ((got, cand["got"]), (ref, cand["ref"])):
        gap = torch.maximum(gap, torch.where(
            only, (sw["scores"] - kth).abs(), torch.zeros_like(kth)).max())
    unexplained = int((picks_differ & ~cands_differ).sum())
    gap = float(gap)
    return {"candidates_differ": int(cands_differ.sum()),
            "picks_differ": int(picks_differ.sum()),
            "picks_differ_equal_candidates": unexplained,
            "worst_tie_gap": gap,
            "ok": unexplained == 0 and gap <= PICK_TIE_TOL}


def picks_reproduced(picks: np.ndarray, ref: dict, k: int) -> dict:
    """Phase 3's written picks against a sweep of its path again: equal,
    but on an image whose k-th and (k+1)-th scores lie within
    PICK_TIE_TOL (a tie at the boundary)."""
    import torch

    shape = ref["scores"].shape
    differ = (as_masks(picks, shape) ^ as_masks(ref["picks"], shape)).any(1)
    top = torch.topk(ref["scores"], k + 1, dim=1).values
    tie = (top[:, -2] - top[:, -1]).abs() <= PICK_TIE_TOL
    return {"picks_differ": int(differ.sum()),
            "ok": not bool((differ & ~tie).any())}


def phase_rewrites(work: Path, model, args, step: dict, oracle: dict) -> dict:
    """The TPU-only rewrites of the default math at full width (CamVid
    360x480, width 1.0, f32). (a) A bs-4 train step with ``--s2d_backbone
    --conv3x3_matmul --fused_ir --pallas_dw`` at phase 6's weights and
    batch against the library path (no rewrites, no kernels): the loss and
    every gradient to phase 6's limits, the running statistics beside
    them, 12 + 12 fused launches (block 2 runs s2d) and no depthwise
    launch (block 0 runs s2d). (b) The same step on the library build with
    ``remat_blocks``, cuDNN's deterministic algorithms on: bit-equal to the
    plain build, or no further from it, leaf by leaf, than a second run of
    the plain build is (the loss's sums may add in any order on the card),
    every running statistic's EMA applied once. (c) A ``--s2d_backbone
    --pallas_dw`` sweep at phase 3's weights over phase 3's pool (its
    initial masks) against phase 3's path, the same draws: the same pick
    sets but for near-ties at the top-k boundary, 12 depthwise launches
    per forward. Then the times: the rewritten step (median of 10) beside
    phase 6's, the s2d sweep's images/s and the device's busy share beside
    phase 3's warm sweep."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pixelpick_tpu_torch.data.factory import get_dataset
    from pixelpick_tpu_torch.engine.optim import make_optimizer
    from pixelpick_tpu_torch.engine.trainer import make_train_step
    from pixelpick_tpu_torch.models import layers
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.models.mobilenet_v2 import InvertedResidual

    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             train_batch(np.random.default_rng(7), TRAIN_BATCH).items()}
    def library_model():
        layers.set_depthwise_impl("xla")
        try:
            return get_model(args, DEVICE, seed=11)
        finally:
            layers.set_depthwise_impl("pallas")

    # phase 6's weights: its seeded init, then well_conditioned_
    library = library_model()
    well_conditioned_(library, seed=12)
    weights = {k: v.detach().clone() for k, v in library.state_dict().items()}
    args.fused_ir = args.s2d_backbone = True
    layers.set_conv3x3_impl("matmul")
    try:
        rewritten = get_model(args, DEVICE, seed=11)
    finally:
        layers.set_conv3x3_impl("xla")
        args.fused_ir = args.s2d_backbone = False
    rewritten.load_state_dict(weights)
    n_matmul = sum(isinstance(m, layers.Conv3x3MatMul)
                   for m in rewritten.modules())
    for m in (library, rewritten):
        for mod in m.modules():
            if isinstance(mod, layers.Dropout):
                mod.p = 0.0  # dropout off for this comparison only
        m.train()
    ref = step_check(library, batch, args)
    got = step_check(rewritten, batch, args)
    err = step_errors(got, ref)
    counts = got["launches"]
    print(f"[20] a bs-{TRAIN_BATCH} step with --s2d_backbone --conv3x3_matmul "
          f"--fused_ir --pallas_dw ({n_matmul} same-shape 3x3 convs as tap "
          f"matmuls) against the library path: loss {got['loss']:.7f} vs "
          f"{ref['loss']:.7f} (relative {err['loss']:.3g}); the worst "
          f"gradient leaf at {err['grad_worst'][0]:.3g} of phase 6's limit "
          f"({err['grad_worst'][1]}), the worst running statistic at "
          f"{err['stats_worst'][0]:.3g} of its limit "
          f"({err['stats_worst'][1]}); launches {counts}")
    check(np.isfinite(got["loss"]), "non-finite loss")
    check(err["loss"] <= STEP_LOSS_TOL, f"loss {got['loss']} vs {ref['loss']}")
    check(err["grad_worst"][0] <= 1, f"gradients off: {err['grad_worst']}")
    check(err["stats_worst"][0] <= 1 and err["counts_equal"],
          f"running statistics off: {err['stats_worst']}")
    check(counts["fused_fwd"] == 12 and counts["fused_bwd"] == 12,
          f"fused launches in the s2d step {counts}")
    check(counts["depthwise_kernel"] == counts["depthwise_kernel_dx"] == 0
          and counts["depthwise_stride2_conv"] == 1,
          f"depthwise launches in the s2d step {counts}")
    check(n_matmul == 5, f"{n_matmul} Conv3x3MatMul modules")

    # (b) remat on the kernel-free build, from the same weights
    library.load_state_dict(weights)
    remat = library_model()
    remat.load_state_dict(weights)
    for mod in remat.modules():
        if isinstance(mod, layers.Dropout):
            mod.p = 0.0
        if isinstance(mod, InvertedResidual):
            mod.remat = True
    remat.train()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain_a = step_check(library, batch, args)
        library.load_state_dict(weights)
        plain_b = step_check(library, batch, args)
        rem = step_check(remat, batch, args)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bit_equal = rem["loss"] == plain_a["loss"] and all(
        torch.equal(rem[part][k], v) for part in ("grads", "stats")
        for k, v in plain_a[part].items())
    within = leafwise_within(rem, plain_a, plain_b)
    once = all(int(v) == 1 for k, v in rem["stats"].items()
               if k.endswith("num_batches_tracked"))
    remat_err = step_errors(rem, plain_a)
    print(f"[20] remat_blocks (17 blocks rematerialised) against the plain "
          f"build: bit-equal {bit_equal}; no further than a second plain "
          f"run, leaf by leaf: {within}; the worst gradient leaf at "
          f"{remat_err['grad_worst'][0]:.3g} of phase 6's limit; every "
          f"EMA applied once: {once}")
    check(bit_equal or within, "remat moved the gradients or statistics")
    check(once, "remat applied a running-statistics update twice")
    del remat, plain_a, plain_b, rem

    # (c) the s2d sweep at phase 3's weights over phase 3's initial pool
    args.s2d_backbone = True
    layers.set_depthwise_impl("pallas")
    try:
        s2d_model = get_model(args)
    finally:
        args.s2d_backbone = False
    s2d_model.load_state_dict(model.state_dict())
    dataset = get_dataset(args, val=False, query=True)
    check(dataset.n_pixels_total == N_IMAGES * args.n_pixels_by_us,
          f"initial queries: {dataset.n_pixels_total} pixels")
    ref_sweep = sweep_picks(model, dataset, args)
    s2d_sweep = sweep_picks(s2d_model, dataset, args)
    # the candidates of a 360x480 image (acquisition.candidate_counts)
    k = max(args.n_pixels_by_us,
            int(IMAGE_HW[0] * IMAGE_HW[1] * args.top_n_percent))
    agree = picks_agree(s2d_sweep, ref_sweep, k)
    with open(Path(args.dir_checkpoints) / "1_query" / "queries.pkl",
              "rb") as f:
        phase3 = pkl.load(f)
    phase3_picks = np.stack([np.sort(
        np.asarray(phase3[p]["y_coords"]) * IMAGE_HW[1]
        + np.asarray(phase3[p]["x_coords"])) for p in dataset.list_inputs])
    agree_phase3 = picks_reproduced(phase3_picks, ref_sweep, k)
    n_fwd = s2d_sweep["n_forwards"]
    sl = s2d_sweep["launches"]
    print(f"[20] --s2d_backbone --pallas_dw sweep over phase 3's pool "
          f"against phase 3's path: {agree['picks_differ']} of {N_IMAGES} "
          f"images pick otherwise, {agree['candidates_differ']} have other "
          f"candidates (the largest distance of a swapped candidate from "
          f"the k-th score {agree['worst_tie_gap']:.3g}, limit "
          f"{PICK_TIE_TOL}), {agree['picks_differ_equal_candidates']} pick "
          f"otherwise from equal candidates; phase 3's path again against "
          f"phase 3's picks: {agree_phase3['picks_differ']} differ; "
          f"launches {sl} for {n_fwd} forwards")
    check(agree["ok"], f"s2d sweep picks differ: {agree}")
    check(agree_phase3["ok"], f"phase 3's picks not reproduced: "
                              f"{agree_phase3}")
    check(sl["kernel"] == 12 * n_fwd and sl["stride2_conv"] == n_fwd,
          f"s2d sweep launches {sl} for {n_fwd} forwards")

    # times: the rewritten step beside phase 6's, the s2d sweep beside
    # phase 3's warm sweep
    opt_step = make_train_step(rewritten, make_optimizer(args, rewritten, 92),
                               n_classes=N_CLASSES, mean=args.mean,
                               std=args.std)
    opt_step(batch)
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        opt_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del opt_step
    t0 = time.perf_counter()
    sweep_picks(s2d_model, dataset, args)
    warm_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep_picks(s2d_model, dataset, args)
        traced_s = time.perf_counter() - t0
    busy, busy_us, by_name = device_busy(prof, traced_s)
    plain = oracle["warm_sweep"]
    med = statistics.median(step_ms)
    print(f"[20] the rewritten step {med:.2f} ms (median of 10; phase 6 in "
          f"this call: {step['median_step_ms']['kernels']:.2f} ms with the "
          f"kernels, {step['median_step_ms']['library']:.2f} ms with the "
          f"library path); the s2d sweep {N_IMAGES / warm_s:.1f} images/s "
          f"warm, device busy "
          + (f"{100 * busy:.1f}%" if busy is not None else "not measured")
          + f" (phase 3's warm sweep {plain['images_per_s']:.1f} images/s, "
          f"busy "
          + (f"{100 * plain['device_busy_share']:.1f}%)"
             if plain["device_busy_share"] is not None else "not measured)"))
    top = print_top("[20]", by_name)
    return {"step_errors": err, "step_launches": counts,
            "conv3x3_matmul_modules": n_matmul,
            "remat": {"bit_equal": bit_equal, "within_plain_noise": within,
                      "ema_once": once, "errors": remat_err},
            "sweep": {"agree": agree, "agree_phase3": agree_phase3,
                      "launches": sl, "n_forwards": n_fwd,
                      "warm_s": warm_s, "images_per_s": N_IMAGES / warm_s,
                      "traced_s": traced_s, "device_busy_share": busy,
                      "device_busy_ms": busy_us / 1e3, "top_device_ms": top},
            "step_ms": step_ms, "median_step_ms": med}


# ------------------------------ phase 21 ------------------------------

# --spatial_query_sharding on two ranks of the one card over gloo, through
# the entry points: the query CLI over the first 64 images of phase 3's
# pool and over 8 images of 1024x2048 at pool batch 4 (phase 3's 11-class
# weights; the images are not resized), each held to the same command
# without the flag in one process; then main_al's round with the flag on
# a 48-image CamVid (phase 19's)
SPATIAL_POOL_IMAGES, SPATIAL_CS_HW, SPATIAL_CS_IMAGES, SPATIAL_CS_BATCH = \
    64, (1024, 2048), 8, 4
SPATIAL_LABELLED = 10  # human-labelled pixels per image before the round


def labelled_round(dir_dataset: Path, n: int, seed: int) -> dict:
    """A human-labelled round's query file for the first ``n`` images of a
    CamVid-layout set: ``SPATIAL_LABELLED`` random non-void pixels per
    image with their labels (``category_id``, as the annotation tools
    write them)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = {}
    for p in sorted((dir_dataset / "train").glob("*.png"))[:n]:
        y = np.asarray(Image.open(dir_dataset / "trainannot" / p.name))
        ys, xs = np.nonzero(y != VOID)
        pick = rng.choice(len(ys), SPATIAL_LABELLED, replace=False)
        out[str(p)] = {"height": y.shape[0], "width": y.shape[1],
                       "y_coords": ys[pick], "x_coords": xs[pick],
                       "category_id": y[ys[pick], xs[pick]].astype(np.int64)}
    return out


def query_run(base: Path, name: str, labelled: dict) -> Path:
    """A fresh run directory holding ``labelled`` as its round 0."""
    run = base / name
    (run / "0_query").mkdir(parents=True)
    with open(run / "0_query" / "queries.pkl", "wb") as f:
        pkl.dump(labelled, f)
    return run


def query_argv(dir_datasets: Path, run: Path, ckpt: Path, pool_batch: int,
               spatial: bool, s2d: bool = False) -> list:
    """The query CLI's arguments: phase 3's strategy (margin sampling, 10
    pixels from the top 5 %, seed 0) with ``--pallas_dw`` (and
    ``--s2d_backbone`` with ``s2d``), and the flag; without it one process
    (``--data_parallel 1``: the default starts a rank on every visible
    card)."""
    return ["--dataset_name", "cv", "--dir_datasets", str(dir_datasets),
            "--dir_checkpoints", str(run), "--p_state_dict", str(ckpt),
            "--device", DEVICE, "--pallas_dw", "-qs", "margin_sampling",
            "--n_pixels_by_us", "10", "--top_n_percent", "0.05", "--seed",
            "0", "--pool_batch_size", str(pool_batch), "--n_workers", "4",
            *(["--s2d_backbone", "true"] if s2d else []),
            *(["--spatial_query_sharding"] if spatial
              else ["--data_parallel", "1"])]


def collectives_timed(fn) -> dict:
    """Run ``fn()`` with the height shard's collectives timed, each between
    two synchronisations (a rank's wait for the other included): {"ms",
    "calls", "mib" sent by this rank}."""
    import torch

    from pixelpick_tpu_torch.parallel import distributed

    acc = {"ms": 0.0, "calls": 0, "mib": 0.0}
    originals = {n: getattr(distributed, n)
                 for n in ("all_gather_tensor", "sum_over_ranks")}

    def timed(f):
        def wrapper(t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(t)
            torch.cuda.synchronize()
            acc["ms"] += (time.perf_counter() - t0) * 1e3
            acc["calls"] += 1
            acc["mib"] += t.numel() * t.element_size() / 2 ** 20
            return out
        return wrapper

    for n, f in originals.items():
        setattr(distributed, n, timed(f))
    try:
        fn()
    finally:
        for n, f in originals.items():
            setattr(distributed, n, f)
    return acc


def observed(entry, argv: list, record: bool = False,
             collectives: bool = False) -> dict:
    """``entry(argv)`` (``cli.query.main`` or ``cli.main_al.main``) with its
    sweeps observed and nothing changed: the depthwise launches (counters
    zeroed just before), those made under a height shard and their input
    shapes, whether each pool batch ran on row stripes, the sweeps' wall
    time (``QuerySelector.__call__``, to its last synchronisation) and the
    call's peak device memory above what was allocated before; with
    ``record``, the ranking scores ``_select_topk`` sees (for the near-tie
    rule); with ``collectives``, the height shard's collectives timed."""
    import torch

    from pixelpick_tpu_torch.active import acquisition, selector
    from pixelpick_tpu_torch.ops import depthwise as dw
    from pixelpick_tpu_torch.parallel import mesh

    out = {"on_stripes": 0, "shapes": [], "sharded": [], "sweep_s": 0.0}
    scores = []
    select, launch = acquisition._select_topk, dw._launch_kernel
    sharded_height = mesh.sharded_height
    call = selector.QuerySelector.__call__

    def recording(uc_flat, *a, strategy, **k):
        signed = uc_flat if strategy in acquisition.MAXIMIZING else -uc_flat
        scores.append(signed.detach())
        return select(uc_flat, *a, strategy=strategy, **k)

    def spy(x, w, dilation, counter="kernel"):
        if mesh.current_height_shard() is not None:
            out["on_stripes"] += 1
            out["shapes"].append(tuple(x.shape))
        return launch(x, w, dilation, counter)

    def noting(shard):
        out["sharded"].append(shard is not None)
        return sharded_height(shard)

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call(self, *a, **k)
        torch.cuda.synchronize()
        out["sweep_s"] += time.perf_counter() - t0
        return res

    if record:
        acquisition._select_topk = recording
    dw._launch_kernel, mesh.sharded_height = spy, noting
    selector.QuerySelector.__call__ = timed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dw.reset_launch_counts()
        if collectives:
            out["collectives"] = collectives_timed(lambda: entry(argv))
        else:
            entry(argv)
        torch.cuda.synchronize()
    finally:
        acquisition._select_topk, dw._launch_kernel = select, launch
        mesh.sharded_height = sharded_height
        selector.QuerySelector.__call__ = call
    out["launches"] = dict(dw.launch_counts)
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    out["scores"] = torch.cat(scores).cpu() if scores else None
    return out


def spatial_ranks(job: dict) -> dict:
    """One rank of phase 21 or 23 or of ``scripts/torch_spatial_sweep.py``:
    each of ``job["calls"]`` (an entry point, its arguments, a port) run
    with the rank's flags and observed; rank 0 saves the recorded
    scores."""
    import torch

    from pixelpick_tpu_torch.cli.main_al import main as main_al
    from pixelpick_tpu_torch.cli.query import main as query_main

    torch.cuda.set_device(job["rank"] % torch.cuda.device_count())
    out, saved = {"device": torch.cuda.current_device()}, {}
    for c in job["calls"]:
        res = observed(query_main if c["entry"] == "query" else main_al,
                       c["argv"] + [
                           "--dist_coordinator", f"localhost:{c['port']}",
                           "--dist_num_processes", str(job["world"]),
                           "--dist_process_id", str(job["rank"]),
                           "--dist_backend", job["backend"],
                           "--data_parallel", str(job["world"])],
                       c.get("record", False), c.get("collectives", False))
        saved[c["name"]] = res.pop("scores")
        out[c["name"]] = res
    if job["rank"] == 0:
        torch.save(saved, job["output"])
    return out


def free_ports(n: int) -> list:
    """``n`` distinct free ports, one for each process group in turn."""
    from pixelpick_tpu_torch.parallel.distributed import free_port

    ports: list = []
    while len(ports) < n:
        p = free_port()
        if p not in ports:
            ports.append(p)
    return ports


def picks_of(run: Path, labelled: dict, n: int) -> np.ndarray:
    """The round's picks that the query CLI wrote to ``run``'s
    ``1_query/queries.pkl``, (images, 10) flat indices in the pool's
    order; each image's 10 picks checked, none on a labelled pixel."""
    from pixelpick_tpu_torch.active import codec

    with open(run / "1_query" / "queries.pkl", "rb") as f:
        masks = codec.decode_queries(pkl.load(f), return_as_dict=True)
    lab = {Path(p).name: v for p, v in labelled.items()}
    check(sorted(Path(p).name for p in masks) == sorted(lab),
          f"{run}: {len(masks)} images picked, not the {len(lab)} labelled")
    picks = []
    for p in sorted(masks, key=lambda p: Path(p).name):
        m, info = masks[p], lab[Path(p).name]
        check(int(m.sum()) == n, f"{p}: {int(m.sum())} picks")
        check(not m[info["y_coords"], info["x_coords"]].any(),
              f"{p}: a labelled pixel picked")
        picks.append(np.flatnonzero(m))
    return np.stack(picks)


def spatial_query_set(root: Path, n: int, hw, seed: int) -> dict:
    """``n`` synthetic CamVid-layout images of ``hw`` under
    ``root/camvid`` and a labelled round over them."""
    make_synthetic_camvid(root / "camvid", n, hw=hw, seed=seed)
    return labelled_round(root / "camvid", n, seed)


def held_to_single(got_run: Path, got_scores, ref_run: Path, ref_scores,
                   labelled: dict, hw) -> dict:
    """The ranks' written picks against one process's (``picks_agree``:
    near-ties at the top-k boundary set aside)."""
    k = max(10, int(hw[0] * hw[1] * 0.05))
    return picks_agree(
        {"picks": picks_of(got_run, labelled, 10),
         "scores": got_scores.to(DEVICE)},
        {"picks": picks_of(ref_run, labelled, 10),
         "scores": ref_scores.to(DEVICE)}, k)


def stripe_kernel_checks(batch: int, hw, bounds, rank: int,
                         skip: int = 0) -> list:
    """The kernel on rank ``rank``'s halo-padded stripe (``bounds`` the
    rows at full size, as ``parallel/mesh.py:height_shard`` splits images
    of ``hw``) of each of a forward's stride-1 depthwise inputs after the
    first ``skip`` (the ones the s2d blocks take), the pad rows between
    stripes the neighbour's and those at the image's edges its zero pad,
    against its plain version (phase 2's limits and times) and against
    the rows of the kernel's output on the whole padded map (every output
    reads the same inputs: equal, or within twice phase 2's limit)."""
    import torch

    from pixelpick_tpu_torch.ops import depthwise as dw
    from pixelpick_tpu_torch.parallel.mesh import HeightShard

    shard = HeightShard(tuple(bounds), rank, 16)
    results = []
    for i, ((b, hp, wp, c), d) in enumerate(
            expected_dw_shapes(batch, hw)[skip:]):
        s = next(s for s in (1, 2, 4, 8, 16)
                 if -(-hw[0] // s) == hp - 2 * d)
        lo, hi = shard.rows_at(s)
        g = torch.Generator(device=DEVICE).manual_seed(300 + 50 * rank + i)
        inner = torch.randn((b, hp - 2 * d, wp - 2 * d, c), device=DEVICE,
                            generator=g)
        full = torch.nn.functional.pad(inner, (0, 0, d, d, d, d))
        w = torch.randn((3, 3, c), device=DEVICE, generator=g) / 3.0
        stripe = full[:, lo:hi + 2 * d].contiguous()
        r = _measure(stripe, w, d, dw)
        diff = (dw.depthwise_conv3x3(stripe, w, 1, d, 0)
                - dw.depthwise_conv3x3(full, w, 1, d, 0)[:, lo:hi]).abs()
        mag = dw.depthwise_reference_torch(stripe.abs(), w.abs(), d)
        r["level"], r["rank"] = s, rank
        r["whole_rows_max_abs_diff"] = float(diff.max())
        r["whole_rows_ok"] = bool((diff <= 2 * F32_TOL * mag).all())
        results.append(r)
    return results


def held_stripes(tag: str, reports: list, part: str, checks: list) -> None:
    """Print ``stripe_kernel_checks``' results for each rank and fail
    unless each passed and the kernel inputs of ``part``'s first forward
    on each rank are the shapes checked."""
    for r, rank_checks in enumerate(checks):
        for c in rank_checks:
            print(f"[{tag}] rank {r} stripe x{tuple(c['x'])} "
                  f"d={c['dilation']} (level {c['level']}): err "
                  f"{c['max_abs_err']:.3g}, against the whole map's rows "
                  f"{c['whole_rows_max_abs_diff']:.3g}; kernel "
                  f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f}, library "
                  f"{c['library_ms']:.4f}, bound {c['bound_ms']:.4f}")
            check(c["ok"] and c["whole_rows_ok"],
                  f"kernel on a halo-padded stripe: {c}")
        want = [tuple(c["x"]) for c in rank_checks]
        seen = [tuple(x) for x in reports[r][part]["shapes"][:len(want)]]
        check(seen == want, f"phase {tag} {part}: rank {r}'s kernel inputs "
                            f"{seen} are not the stripes {want}")


# the full-size row bounds of the two ranks' stripes, as
# parallel/mesh.py:height_shard splits 360 and 364 rows at stride 16
POOL_STRIPES = (0, 192, IMAGE_HW[0])


def phase_spatial(work: Path, model, args) -> dict:
    """``--spatial_query_sharding`` at full width (f32, ``--pallas_dw``,
    phase 3's weights) on two ranks sharing the card over gloo, through
    the entry points, each rank given its coordinator flags and
    ``--data_parallel 2`` (``--worker``): (a) the query CLI over the first
    64 images of phase 3's pool (360x480: stripes [0, 192) and
    [192, 360)), a labelled round before it, held to the same command
    without the flag in one process (pick sets, near-ties at the top-k
    boundary set aside as in phase 20), 14 depthwise launches per forward
    on every rank, on stripes; (b) the same over 8 images of 1024x2048 at
    pool batch 4, each rank's peak device memory beside the single
    process's; (c) ``main_al`` with the flag, 1 epoch and one round on a
    48-image CamVid: the step sharded by images, the sweep by rows, the
    primary writing the round's files. Each query part runs again timed,
    the pool once more with its collectives timed. The kernel also runs
    on each rank's halo-padded stripes of the 14 inputs against its plain
    version. The ranks' times share one card: they say what the halos
    cost there, nothing of scaling."""
    import torch

    from pixelpick_tpu_torch.active import codec
    from pixelpick_tpu_torch.cli.query import main as query_main
    from pixelpick_tpu_torch.engine.checkpoint import save_checkpoint

    spw = work / "spatial"
    spw.mkdir()
    ckpt = spw / "model.ckpt"
    save_checkpoint(str(ckpt), model)
    parts = {"pool": (work, labelled_round(work / "camvid",
                                           SPATIAL_POOL_IMAGES, 21),
                      POOL_BATCH, IMAGE_HW),
             "cs": (spw / "big", spatial_query_set(
                 spw / "big", SPATIAL_CS_IMAGES, SPATIAL_CS_HW, 22),
                 SPATIAL_CS_BATCH, SPATIAL_CS_HW)}
    calls = []
    for part, (root, labelled, pb, _) in parts.items():
        runs = [(part, {"record": True}), (f"{part}_warm", {})]
        if part == "pool":
            runs.append(("pool_collectives", {"collectives": True}))
        for name, extra in runs:
            calls.append(dict(name=name, entry="query", argv=query_argv(
                root, query_run(spw, name, labelled), ckpt, pb, True),
                **extra))
    make_synthetic_camvid(spw / "camvid_al", DP_TRAIN, DP_VAL, seed=3)
    cfg = write_cfg(spw, "cv_al", n_epochs=1, batch_size=DP_BATCH,
                    dir_dataset=str(spw / "camvid_al"))
    al_run = spw / "al"
    calls.append(dict(name="al", entry="main_al", argv=[
        "-pdc", str(cfg), "--dir_checkpoints", str(al_run), "--device",
        DEVICE, "--pallas_dw", "--n_pixels_by_us", "10", "--max_budget",
        "10", "-qs", "margin_sampling", "--pool_batch_size",
        str(POOL_BATCH), "--n_workers", "4", "--seed", "0",
        "--spatial_query_sharding"]))
    for c, port in zip(calls, free_ports(len(calls))):
        c["port"] = port
    jobs = [dict(kind="spatial", rank=r, world=DP_WORLD, backend="gloo",
                 calls=calls, output=str(spw / "scores.pt"),
                 report=str(spw / f"rank_{r}.json"))
            for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    run_workers(jobs, spw / "ranks.log")
    ranks_s = time.perf_counter() - t0
    got = torch.load(spw / "scores.pt", weights_only=False)
    reports = [json.loads((spw / f"rank_{r}.json").read_text())
               for r in range(DP_WORLD)]
    out = {"ranks_s": ranks_s, "ranks": reports,
           "rank_launches": [r[c["name"]]["launches"]
                             for r in reports for c in calls]}
    for part, (root, labelled, pb, hw) in parts.items():
        ref = observed(query_main, query_argv(
            root, query_run(spw, f"{part}_single", labelled), ckpt, pb,
            False), record=True)
        warm = observed(query_main, query_argv(
            root, query_run(spw, f"{part}_single_warm", labelled), ckpt, pb,
            False))
        agree = held_to_single(spw / part, got[part], spw / f"{part}_single",
                               ref["scores"], labelled, hw)
        n_img, n_fwd = len(labelled), -(-len(labelled) // pb)
        mine = [r[part] for r in reports]
        counts = [m["launches"] for m in mine]
        out[part] = {
            "agree": agree, "n_images": n_img, "launches": counts,
            "on_stripes": [m["on_stripes"] for m in mine],
            "single_launches": ref["launches"],
            "ranks_peak_mib": [m["peak_mib"] for m in mine],
            "single_peak_mib": ref["peak_mib"],
            "ranks_sweep_s": [r[f"{part}_warm"]["sweep_s"] for r in reports],
            "single_sweep_s": warm["sweep_s"],
            "single_images_per_s": n_img / warm["sweep_s"],
            "ranks_images_per_s": n_img / max(
                r[f"{part}_warm"]["sweep_s"] for r in reports)}
        print(f"[21] {part}: the query CLI over {n_img} images of "
              f"{hw[0]}x{hw[1]} on two ranks (height stripes, gloo, one "
              f"card) against one process: {agree['picks_differ']} pick "
              f"otherwise, {agree['candidates_differ']} have other "
              f"candidates (worst tie gap {agree['worst_tie_gap']:.3g}, "
              f"limit {PICK_TIE_TOL}), "
              f"{agree['picks_differ_equal_candidates']} pick otherwise "
              f"from equal candidates; depthwise launches per rank "
              f"{counts}, on stripes {out[part]['on_stripes']}, for "
              f"{n_fwd} forwards (one process {ref['launches']}); peak "
              f"device memory per rank "
              f"{[round(m, 1) for m in out[part]['ranks_peak_mib']]} MiB, "
              f"one process {ref['peak_mib']:.1f} MiB; warm sweep "
              f"{out[part]['ranks_images_per_s']:.1f} images/s on the two "
              f"ranks, {out[part]['single_images_per_s']:.1f} in one "
              f"process (PNG decode included)")
        check(agree["ok"], f"phase 21 {part} picks differ: {agree}")
        check(all(r[name]["sharded"] == [True] * n_fwd for r in reports
                  for name in (part, f"{part}_warm")),
              f"phase 21 {part} did not shard: {reports}")
        check(ref["on_stripes"] == 0 and ref["launches"]["kernel"]
              == 14 * n_fwd, f"phase 21 {part} one process {ref}")
        check(all(m["launches"]["kernel"] == m["on_stripes"] == 14 * n_fwd
                  and m["launches"]["stride2_conv"] == 3 * n_fwd
                  for m in mine), f"phase 21 {part} launches {mine}")
    coll = [r["pool_collectives"]["collectives"] for r in reports]
    out["pool"]["collectives"] = coll
    print(f"[21] pool: the collectives per rank {coll} (ms between "
          f"synchronisations, waits included; MiB sent by the rank) in a "
          f"sweep of {[round(r['pool_collectives']['sweep_s'] * 1e3, 1) for r in reports]}"
          f" ms with them timed, "
          f"{[round(s * 1e3, 1) for s in out['pool']['ranks_sweep_s']]} ms "
          f"untimed")

    # (c) main_al with the flag: the round's files once, its picks valid,
    # the sweep's two pool batches on stripes on both ranks
    files = sorted(str(p.relative_to(al_run)) for p in al_run.rglob("*")
                   if p.is_file())
    want = sorted(["args.txt", "1_query/queries.pkl",
                   *(f"0_query/{f}" for f in STAGE_FILES)])
    with open(al_run / "1_query" / "queries.pkl", "rb") as f:
        picked = codec.decode_queries(pkl.load(f), return_as_dict=True)
    with open(al_run / "0_query" / "queries.pkl", "rb") as f:
        before = codec.decode_queries(pkl.load(f), return_as_dict=True)
    with open(al_run / "0_query" / "query_stats.pkl", "rb") as f:
        stats = pkl.load(f)
    al = [r["al"] for r in reports]
    n_fwd = -(-DP_TRAIN // POOL_BATCH)
    print(f"[21] main_al --spatial_query_sharding as two ranks, 1 epoch and "
          f"one round at bs {DP_BATCH} on {DP_TRAIN} images: {len(files)} "
          f"files, {len(picked)} images picked, average entropy "
          f"{stats['avg_entropy']:.4f}; per rank the sweep's batches on "
          f"stripes {[a['sharded'] for a in al]}, depthwise launches "
          f"{[a['launches'] for a in al]}, on stripes "
          f"{[a['on_stripes'] for a in al]}")
    check(files == want, f"phase 21 main_al files {files}")
    check(sorted(picked) == sorted(before) and len(picked) == DP_TRAIN
          and all(int(m.sum()) == 10 and not (m & before[p]).any()
                  for p, m in picked.items()), "phase 21 main_al picks")
    check(np.isfinite(stats["avg_entropy"]), f"stats {stats}")
    check(all(a["sharded"] == [True] * n_fwd
              and a["on_stripes"] == 14 * n_fwd
              and a["launches"]["kernel_dx"] > 0 for a in al),
          f"phase 21 main_al ranks {al}")
    out["al"] = {"files": files, "ranks": al,
                 "avg_entropy": stats["avg_entropy"]}

    # each rank's kernel inputs: a stripe of the whole padded map plus 2d
    # halo rows
    stripes = [stripe_kernel_checks(POOL_BATCH, IMAGE_HW, POOL_STRIPES, r)
               for r in range(DP_WORLD)]
    held_stripes("21", reports, "pool", stripes)
    out["stripe_kernel"] = stripes
    return out



# ------------------------------ phase 22 ------------------------------

ORBAX_FIXTURE = HERE / "tests" / "torch_fixtures" / "jax_orbax"


def tree_hashes(tree: dict, prefix=()) -> dict:
    """``scripts/torch_make_orbax_fixture.py``'s ``hashes.json`` entries of
    a nested dict of arrays."""
    import hashlib

    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(tree_hashes(v, prefix + (k,)))
        else:
            a = np.ascontiguousarray(v)
            out["/".join(prefix + (k,))] = {
                "dtype": a.dtype.str, "shape": list(a.shape),
                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def optimizer_on_host(opt) -> dict:
    return {"step_count": opt.step_count,
            "state": [{k: [t.detach().cpu().clone() for t in ts]
                       for k, ts in st.items()} for st in opt.state]}


def same_optimizer(a: dict, b: dict) -> bool:
    return a["step_count"] == b["step_count"] and len(a["state"]) \
        == len(b["state"]) and all(
        sorted(ga) == sorted(gb) and all(
            len(ga[k]) == len(gb[k]) and all(torch_equal(x, y) for x, y in
                                              zip(ga[k], gb[k]))
            for k in ga) for ga, gb in zip(a["state"], b["state"]))


def phase_orbax(work: Path) -> dict:
    """JAX orbax checkpoints and JAX stage snapshots on the card's machine,
    which has neither orbax nor tensorstore:

    (a) the committed JAX-written fixture (OCDBT, zstd) decoded, every
        leaf's sha256 against ``hashes.json``;
    (b) one ``main_al`` round (``--debug`` length) at the main path's
        configuration with ``--ckpt_backend orbax --stage_ckpt_interval
        1``: the best model as ``best_miou_model.ckpt.orbax/step_00000000/``
        and nothing else, no tmp directory; two more saves of it number on
        and prune as JAX's do (steps 1 and 2 left), timed with the load;
        the query CLI with ``--pallas_dw`` from that directory and from a
        torch file of the same weights: bit-equal ``state_dict`` and picks,
        14 depthwise launches per forward each;
    (c) the round's epoch-1 snapshot rewritten in the JAX package's layout
        (``save_jax_stage_state``: the msgpack writer and
        ``optimizer_state_to_jax``) and resumed by ``main_al --fused_ir
        --pallas_dw``: the model and optimizer after the load bit-equal to
        those the port's own snapshot loads, and the stage finishes with
        its fused and depthwise launches counted."""
    import torch

    from pixelpick_tpu_torch.active import driver
    from pixelpick_tpu_torch.cli import query as query_cli
    from pixelpick_tpu_torch.engine import checkpoint as ckpt_mod
    from pixelpick_tpu_torch.engine import orbax
    from pixelpick_tpu_torch.engine.optim import make_optimizer
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.ops import depthwise as dw

    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    out = {"card": card}

    # (a) the fixture
    with open(ORBAX_FIXTURE / "hashes.json") as f:
        want = json.load(f)
    t0 = time.perf_counter()
    tree = orbax.read_latest(str(ORBAX_FIXTURE / "best_miou_model.ckpt.orbax"))
    out["fixture_decode_ms"] = (time.perf_counter() - t0) * 1e3
    check(tree_hashes(tree) == want, "the JAX orbax fixture decodes to other "
                                     "arrays than hashes.json names")
    print(f"[22] (a) the JAX orbax fixture (OCDBT, zstd): {len(want)} leaves "
          f"decoded in {out['fixture_decode_ms']:.1f} ms, every sha256 as "
          f"written ({card})")

    # (b) a round that writes orbax
    base = work / "orbax"
    cfg = work / "cv_2epochs.yaml"
    run = base / "round"
    flags = ["-pdc", str(cfg), "--device", DEVICE, "--fused_ir",
             "--pallas_dw", "--n_pixels_by_us", "10", "--max_budget", "10",
             "-qs", "margin_sampling", "--pool_batch_size", str(POOL_BATCH),
             "--n_workers", "8", "--seed", "0", "--debug",
             "--stage_ckpt_interval", "1"]
    port_snapshot = base / "port_stage_state.ckpt"
    save_stage_state = driver.save_stage_state

    def keep_snapshot(path, *a, **k):
        save_stage_state(path, *a, **k)
        shutil.copyfile(path, port_snapshot)

    driver.save_stage_state = keep_snapshot
    try:
        al, round_s, counts = run_main_al(
            flags + ["--dir_checkpoints", str(run), "--ckpt_backend",
                     "orbax"], {})
    finally:
        driver.save_stage_state = save_stage_state
    check(counts["fused_fwd"] == 13 and counts["fused_bwd"] == 13
          and counts["depthwise_kernel_dx"] == 1, f"the round's {counts}")
    stage = run / "0_query"
    root = stage / "best_miou_model.ckpt.orbax"
    check(not (stage / "best_miou_model.ckpt").exists()
          and sorted(os.listdir(root)) == ["step_00000000"],
          f"orbax layout {sorted(os.listdir(root))}")
    check(port_snapshot.is_file() and not (stage / "stage_state.ckpt")
          .exists(), "the epoch-1 snapshot was not written, or outlived "
                     "its stage")
    with open(root / "step_00000000" / "_METADATA") as f:
        check(json.load(f)["use_ocdbt"] is False, "not the plain layout")

    args = default_args_cv(work)
    model = ckpt_mod.load_checkpoint(str(stage / "best_miou_model.ckpt"),
                                     get_model(args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):  # numbered on, and pruned as JAX prunes
        ckpt_mod.save_checkpoint(str(stage / "best_miou_model.ckpt"), model,
                                 backend="orbax")
    ckpt_mod.wait_for_checkpoints()
    out["orbax_write_ms"] = (time.perf_counter() - t0) * 1e3 / 2
    steps = sorted(os.listdir(root))
    check(steps == ["step_00000001", "step_00000002"], f"steps {steps}")
    t0 = time.perf_counter()
    again = ckpt_mod.load_checkpoint(str(stage / "best_miou_model.ckpt"),
                                     get_model(args))
    torch.cuda.synchronize()
    out["orbax_read_ms"] = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), again.state_dict().values())),
        "the orbax directory reads back to other weights")
    torch_file = base / "model.ckpt"
    ckpt_mod.save_checkpoint(str(torch_file), model)

    loaded, picks, query_counts = {}, {}, {}
    load = query_cli.load_checkpoint

    def recording(path, m):
        m = load(path, m)
        loaded[current] = state_on_host(m)
        return m

    query_cli.load_checkpoint = recording
    try:
        for current, p in (("orbax", stage / "best_miou_model.ckpt"),
                           ("torch", torch_file)):
            qrun = base / f"query_{current}"
            for r in ("0_query", "1_query"):
                (qrun / r).mkdir(parents=True)
                shutil.copyfile(work / "human" / r / "queries.pkl",
                                qrun / r / "queries.pkl")
            dw.reset_launch_counts()
            path = query_cli.main([
                "--dataset_name", "cv", "--dir_datasets", str(work),
                "--dir_checkpoints", str(qrun), "--p_state_dict", str(p),
                "--device", DEVICE, "--pallas_dw", "--n_pixels_by_us", "10",
                "--pool_batch_size", str(POOL_BATCH), "--n_workers", "8"])
            query_counts[current] = dict(dw.launch_counts)
            picks[current] = Path(path).read_bytes()
    finally:
        query_cli.load_checkpoint = load
    n_forwards = -(-N_IMAGES // POOL_BATCH)
    for current, c in query_counts.items():
        check(c["kernel"] == 14 * n_forwards, f"{current}: {c} for "
                                              f"{n_forwards} forwards")
    check(list(loaded["orbax"]) == list(loaded["torch"]) and all(
        torch.equal(loaded["orbax"][k], loaded["torch"][k])
        for k in loaded["orbax"]), "the query CLI loads other weights from "
                                   "the orbax directory")
    check(picks["orbax"] == picks["torch"], "the picks differ between the "
                                            "orbax and the torch file")
    print(f"[22] (b) main_al --ckpt_backend orbax --stage_ckpt_interval 1: a "
          f"--debug round in {round_s:.1f} s, launches {counts}; layout "
          f"step_00000000 alone, no tmp; two more saves leave {steps}; a "
          f"full-width orbax save {out['orbax_write_ms']:.1f} ms, load "
          f"{out['orbax_read_ms']:.1f} ms ({card}); the query CLI from the "
          f"orbax directory and from a torch file: the same state_dict and "
          f"picks, launches {query_counts['orbax']} each")

    # (c) resuming a JAX-layout snapshot
    model = get_model(args)
    opt = make_optimizer(args, model, 1)
    gen = torch.Generator(device=DEVICE)
    epoch, best = ckpt_mod.load_stage_state(str(port_snapshot), model, opt,
                                            gen)
    check(epoch == 1, f"the port's snapshot is of epoch {epoch}")
    want_model, want_opt = state_on_host(model), optimizer_on_host(opt)
    jrun = base / "jax_resume"
    (jrun / "0_query").mkdir(parents=True)
    ckpt_mod.save_jax_stage_state(str(jrun / "0_query" / "stage_state.ckpt"),
                                  model, opt, epoch, best)
    got = {}
    load_stage = driver.load_stage_state

    def recording_stage(path, m, o, g, seed=None):
        res = load_stage(path, m, o, g, seed=seed)
        got.update(model=state_on_host(m), opt=optimizer_on_host(o),
                   epoch=res[0])
        return res

    driver.load_stage_state = recording_stage
    try:
        al, resume_s, resume_counts = run_main_al(
            flags + ["--dir_checkpoints", str(jrun)], {})
    finally:
        driver.load_stage_state = load_stage
    check(got.get("epoch") == 1, "main_al did not resume the JAX snapshot")
    # JAX keeps no BatchNorm update count (the reference's
    # num_batches_tracked, which no computation reads): it restarts at 0
    check(list(got["model"]) == list(want_model) and all(
        torch.equal(got["model"][k], want_model[k]) for k in want_model
        if not k.endswith("num_batches_tracked")),
        "the JAX snapshot loads other weights than the port's")
    check(same_optimizer(got["opt"], want_opt),
          "the JAX snapshot loads another optimizer state than the port's")
    check(resume_counts["fused_fwd"] == 13 and resume_counts["fused_bwd"]
          == 13 and resume_counts["depthwise_kernel_dx"] == 1
          and resume_counts["depthwise_kernel"] >= 1 + n_forwards,
          f"the resumed stage's launches {resume_counts}")
    check(not (jrun / "0_query" / "stage_state.ckpt").exists()
          and (jrun / "1_query" / "queries.pkl").is_file(),
          "the resumed stage did not finish")
    out.update(round_s=round_s, round_launches=counts,
               query_launches=query_counts, resume_s=resume_s,
               resume_launches=resume_counts,
               phase_s=time.perf_counter() - t_phase)
    print(f"[22] (c) a JAX-layout stage_state.ckpt of epoch 1 resumed by "
          f"main_al --fused_ir --pallas_dw in {resume_s:.1f} s: model and "
          f"optimizer bit-equal to the port's snapshot's, launches "
          f"{resume_counts}; phase 22 took {out['phase_s']:.1f} s ({card})")
    return out


# ------------------------------ phase 23 ------------------------------

# --s2d_backbone under --spatial_query_sharding: phase 21's two ranks and
# query CLI with blocks 0-3 in s2d layout on row stripes. At 360x480 the
# 1/4 map has 90 rows (stripes of 48 and 42): blocks 0-3 run s2d, 12
# depthwise launches and 1 stride-2 grouped conv per forward. At 364x480
# it has 91 (48 and 43): blocks 2-3 run the standard way on both ranks, as
# the whole map decides, 13 launches and 2 stride-2 convs
S2D_ODD_HW, S2D_ODD_IMAGES = (364, 480), 8
S2D_ODD_STRIPES = (0, 192, S2D_ODD_HW[0])
S2D_PARTS = {"pool": (IMAGE_HW, 12, 1), "odd": (S2D_ODD_HW, 13, 2)}


def phase_spatial_s2d(work: Path, model, spatial: dict) -> dict:
    """``--s2d_backbone --spatial_query_sharding --data_parallel 2`` at
    full width (f32, ``--pallas_dw``, phase 3's weights) on two ranks
    sharing the card over gloo (``--worker``, one launch), through the
    query CLI: (a) over phase 21's 64 images of 360x480, (b) over 8
    synthetic images of 364x480 at pool batch 32, each held to the same
    command with ``--s2d_backbone`` in one process (pick sets, near-ties
    at the top-k boundary set aside as in phase 20), the depthwise
    launches per forward on every rank, on stripes, and each rank's peak
    device memory beside the single process's. (a) runs again warm on the
    ranks for its images/s beside phase 21's, and once more with its
    collectives timed. The kernel runs on each rank's halo-padded stripes
    of (b)'s 13 inputs against its plain version; (a)'s 12 are among
    phase 21's 14, checked there."""
    import torch

    from pixelpick_tpu_torch.cli.query import main as query_main
    from pixelpick_tpu_torch.engine.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    sw = work / "spatial_s2d"
    sw.mkdir()
    ckpt = sw / "model.ckpt"
    save_checkpoint(str(ckpt), model)
    sets = {"pool": (work, labelled_round(work / "camvid",
                                          SPATIAL_POOL_IMAGES, 21)),
            "odd": (sw / "odd", spatial_query_set(
                sw / "odd", S2D_ODD_IMAGES, S2D_ODD_HW, 23))}
    calls = []
    for name, part, extra in (("pool", "pool", {"record": True}),
                              ("pool_warm", "pool", {}),
                              ("pool_collectives", "pool",
                               {"collectives": True}),
                              ("odd", "odd", {"record": True})):
        root, labelled = sets[part]
        calls.append(dict(name=name, entry="query", argv=query_argv(
            root, query_run(sw, name, labelled), ckpt, POOL_BATCH, True,
            s2d=True), **extra))
    for c, port in zip(calls, free_ports(len(calls))):
        c["port"] = port
    jobs = [dict(kind="spatial", rank=r, world=DP_WORLD, backend="gloo",
                 calls=calls, output=str(sw / "scores.pt"),
                 report=str(sw / f"rank_{r}.json"))
            for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    run_workers(jobs, sw / "ranks.log")
    ranks_s = time.perf_counter() - t0
    got = torch.load(sw / "scores.pt", weights_only=False)
    reports = [json.loads((sw / f"rank_{r}.json").read_text())
               for r in range(DP_WORLD)]
    out = {"ranks_s": ranks_s, "ranks": reports,
           "rank_launches": [r[c["name"]]["launches"]
                             for r in reports for c in calls]}
    for part, (hw, per_fwd, s2_per_fwd) in S2D_PARTS.items():
        root, labelled = sets[part]
        ref = observed(query_main, query_argv(
            root, query_run(sw, f"{part}_single", labelled), ckpt,
            POOL_BATCH, False, s2d=True), record=True)
        agree = held_to_single(sw / part, got[part], sw / f"{part}_single",
                               ref["scores"], labelled, hw)
        n_img, n_fwd = len(labelled), -(-len(labelled) // POOL_BATCH)
        mine = [r[part] for r in reports]
        counts = [m["launches"] for m in mine]
        out[part] = {
            "agree": agree, "n_images": n_img, "hw": hw, "launches": counts,
            "on_stripes": [m["on_stripes"] for m in mine],
            "single_launches": ref["launches"],
            "ranks_peak_mib": [m["peak_mib"] for m in mine],
            "single_peak_mib": ref["peak_mib"]}
        print(f"[23] {part}: the query CLI with --s2d_backbone over {n_img} "
              f"images of {hw[0]}x{hw[1]} on two ranks (height stripes, "
              f"gloo, one card) against one process: "
              f"{agree['picks_differ']} pick otherwise, "
              f"{agree['candidates_differ']} have other candidates (worst "
              f"tie gap {agree['worst_tie_gap']:.3g}, limit {PICK_TIE_TOL}),"
              f" {agree['picks_differ_equal_candidates']} pick otherwise "
              f"from equal candidates; depthwise launches per rank "
              f"{counts}, on stripes {out[part]['on_stripes']}, for "
              f"{n_fwd} forwards (one process {ref['launches']}); peak "
              f"device memory per rank "
              f"{[round(m, 1) for m in out[part]['ranks_peak_mib']]} MiB, "
              f"one process {ref['peak_mib']:.1f} MiB")
        check(agree["ok"], f"phase 23 {part} picks differ: {agree}")
        check(all(r[part]["sharded"] == [True] * n_fwd for r in reports),
              f"phase 23 {part} did not shard: {reports}")
        check(ref["on_stripes"] == 0 and ref["launches"]["kernel"]
              == per_fwd * n_fwd, f"phase 23 {part} one process {ref}")
        check(all(m["launches"]["kernel"] == m["on_stripes"]
                  == per_fwd * n_fwd
                  and m["launches"]["stride2_conv"] == s2_per_fwd * n_fwd
                  for m in mine), f"phase 23 {part} launches {mine}")
    check(all(r[name]["sharded"] == [True] * 2 for r in reports
              for name in ("pool_warm", "pool_collectives")),
          f"phase 23 pool_warm did not shard: {reports}")
    # each rank's kernel inputs: (a)'s the last 12 of phase 21's stripes,
    # (b)'s checked here
    skip = len(expected_dw_shapes(1)) - S2D_PARTS["pool"][1]
    held_stripes("23", reports, "pool",
                 [c[skip:] for c in spatial["stripe_kernel"]])
    odd_batch = min(S2D_ODD_IMAGES, POOL_BATCH)
    skip = len(expected_dw_shapes(1, S2D_ODD_HW)) - S2D_PARTS["odd"][1]
    odd = [stripe_kernel_checks(odd_batch, S2D_ODD_HW, S2D_ODD_STRIPES, r,
                                skip) for r in range(DP_WORLD)]
    held_stripes("23", reports, "odd", odd)
    out["odd"]["stripe_kernel"] = odd
    n_img = out["pool"]["n_images"]
    out["pool"]["ranks_sweep_s"] = [r["pool_warm"]["sweep_s"]
                                    for r in reports]
    out["pool"]["ranks_images_per_s"] = n_img / max(
        out["pool"]["ranks_sweep_s"])
    coll = [r["pool_collectives"]["collectives"] for r in reports]
    out["pool"]["collectives"] = coll
    print(f"[23] pool: the collectives per rank {coll} (ms between "
          f"synchronisations, waits included; MiB sent by the rank) in a "
          f"sweep of {[round(r['pool_collectives']['sweep_s'] * 1e3, 1) for r in reports]}"
          f" ms with them timed; phase 21's without --s2d_backbone "
          f"{spatial['pool']['collectives']}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[23] pool: warm sweep {out['pool']['ranks_images_per_s']:.1f} "
          f"images/s on the two ranks with --s2d_backbone, "
          f"{spatial['pool']['ranks_images_per_s']:.1f} in phase 21 "
          f"without (PNG decode included); the ranks' launch "
          f"{ranks_s:.1f} s, phase 23 {out['phase_s']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for chip_smoke.json")
    ap.add_argument("--worker", default="",
                    help="run one rank of phase 19, 21 or 23 (a JSON job) "
                         "and exit")
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if opts.worker:
        return worker_main(json.loads(opts.worker))
    import_port()
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models.factory import get_model

    card = phase_card()

    work = HERE / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_camvid(work / "camvid", N_IMAGES, N_VAL)
    print(f"[3] wrote the synthetic pool in {time.perf_counter() - t0:.1f} s")
    args = default_args(
        dataset_name="cv", dir_datasets=str(work),
        dir_dataset=str(work / "camvid"),
        dir_checkpoints=str(work / "run"), write_files=True, device=DEVICE,
        pallas_dw=True, precision="f32", width_multiplier=1.0,
        query_strategy="margin_sampling", n_pixels_by_us=10,
        top_n_percent=0.05, pool_batch_size=POOL_BATCH, n_workers=4, seed=0)
    model = get_model(args)

    t_start = time.perf_counter()
    kernels = phase_kernels(model)
    oracle = phase_oracle_round(work, model, args)
    human = phase_human_cli(work, model, args)
    fused = phase_fused_kernels()
    step = phase_train_step(args)
    campaign = phase_campaign(work)
    micro = phase_microbatch(work, args, campaign)
    dense = phase_dense(work)
    committee = phase_committee(model, args, oracle["warm_sweep"])
    train_cli = phase_train_cli(work)
    eval_cli = phase_eval_cli(work, train_cli)
    resume = phase_resume_and_pretrained(work, eval_cli["flax_ckpt"])
    devaug = phase_device_augment(work, micro)
    city = phase_cityscapes(work)
    voc = phase_voc_deeplab(work)
    voc_fpn = phase_voc_fpn(work)
    voc_dev = phase_voc_device_augment(work, voc)
    dp = phase_data_parallel(work)
    t_rewrites = time.perf_counter()
    rewrites = phase_rewrites(work, model, args, step, oracle)
    rewrites["phase_s"] = time.perf_counter() - t_rewrites
    t_spatial = time.perf_counter()
    spatial = phase_spatial(work, model, args)
    spatial["phase_s"] = time.perf_counter() - t_spatial
    phases_2_21_s = time.perf_counter() - t_start
    orbax = phase_orbax(work)
    s2d_spatial = phase_spatial_s2d(work, model, spatial)
    phases_s = time.perf_counter() - t_start
    # phase 19's, 21's and 23's ranks count in their own processes
    dp_counts = [{f"depthwise_{k}": v for k, v in c.items()}
                 for c in dp["step_launches_per_rank"]] \
        + dp["campaign_launches"] \
        + [{f"depthwise_{k}": v for k, v in c.items()}
           for c in (*spatial["rank_launches"],
                     *s2d_spatial["rank_launches"])]

    f32 = kernels["float32"]
    entry = {
        "name": "depthwise3x3_s1_nhwc",
        "route": "cuda",
        "source": "pixelpick_tpu_torch/csrc/depthwise.cu",
        "replaces": "pixelpick_tpu/ops/depthwise.py:73",
        # every main-path run: the sweeps of phases 3 and 10, the
        # campaign of phase 7, the epoch runs of phases 8 and 9, the train
        # CLI's straight and resumed runs of phase 11, the eval CLI's of
        # phase 12, the --pretrained_ckpt round of phase 13 and the
        # device-augment runs of phases 14 and 15, phase 16's and 18's VOC
        # runs, phase 19's ranks, phase 20's s2d step and sweep and phase
        # 21's ranks (every entry-point run, on stripes), phase 22's
        # round, query CLI runs and resumed stage and phase 23's ranks (s2d
        # blocks on stripes)
        "launches": sum(c[f"{pre}kernel"] + c[f"{pre}kernel_dx"]
                        for c, pre in ((oracle["launches"], ""),
                                       (committee["launches"], ""),
                                       (campaign["launches"], "depthwise_"),
                                       (micro["launches"], "depthwise_"),
                                       (dense["launches"], "depthwise_"),
                                       (train_cli["launches"], "depthwise_"),
                                       (train_cli["launches_resume"],
                                        "depthwise_"),
                                       (eval_cli["runs"]["torch"]["launches"],
                                        ""),
                                       (eval_cli["runs"]["msgpack"]
                                        ["launches"], ""),
                                       (eval_cli["runs"]["torch_fused_ir"]
                                        ["launches"], ""),
                                       (resume["pretrained_launches"],
                                        "depthwise_"),
                                       (devaug["launches"], "depthwise_"),
                                       (devaug["host_loader_launches"],
                                        "depthwise_"),
                                       (city["launches"], "depthwise_"),
                                       (voc["launches"], "depthwise_"),
                                       (voc_dev["launches"], "depthwise_"),
                                       (rewrites["step_launches"],
                                        "depthwise_"),
                                       (rewrites["sweep"]["launches"], ""),
                                       (orbax["round_launches"],
                                        "depthwise_"),
                                       (orbax["query_launches"]["orbax"],
                                        ""),
                                       (orbax["query_launches"]["torch"],
                                        ""),
                                       (orbax["resume_launches"],
                                        "depthwise_"),
                                       *((c, "depthwise_")
                                         for c in dp_counts))),
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        # per forward of the main path: the 14 launches at batch 32, f32
        "ms": sum(r["ms"] for r in f32),
        "plain_ms": sum(r["plain_ms"] for r in f32),
        "bound_ms": sum(r["bound_ms"] for r in f32),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in f32)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in f32),
    }
    # the fused kernels: per train step of the main path, the 13 blocks at
    # batch 4 in f32, summed; launches over the main-path train runs of
    # phases 7, 8, 9, 11 (both arms), 13, 14, 15, 16 and 18, phase 20's
    # s2d step and phase 22's round and resumed stage
    f32 = fused["float32"]
    fused_entries = []
    for k, name, line in (("fwd", "fused_ir_fwd", 221),
                          ("bwd", "fused_ir_bwd", 241)):
        bound_by = {r[f"{k}_bound_by"] for r in f32}
        fused_entries.append({
            "name": name, "route": "cuda",
            "source": "pixelpick_tpu_torch/csrc/fused_ir.cu",
            "replaces": f"pixelpick_tpu/ops/fused_ir.py:{line}",
            "launches": sum(c[f"fused_{k}"] for c in (
                campaign["launches"], micro["launches"], dense["launches"],
                train_cli["launches"], train_cli["launches_resume"],
                resume["pretrained_launches"], devaug["launches"],
                devaug["host_loader_launches"], city["launches"],
                voc["launches"], voc_dev["launches"],
                rewrites["step_launches"], orbax["round_launches"],
                orbax["resume_launches"], *dp["campaign_launches"])),
            "max_abs_err": max(r["y_max_abs_err" if k == "fwd"
                                 else "grad_max_abs_err"] for r in f32),
            "ms": sum(r[f"{k}_ms"] for r in f32),
            "plain_ms": sum(r[f"plain_{k}_ms"] for r in f32),
            "bound_ms": sum(r[f"{k}_bound_ms"] for r in f32),
            "bound_by": bound_by.pop() if len(bound_by) == 1
            else "operations",
            "library_ms": sum(r[f"library_{k}_ms"] for r in f32),
        })
    print(f"[23] phase 20 took {rewrites['phase_s']:.1f} s, phase 21 "
          f"{spatial['phase_s']:.1f} s, phase 22 {orbax['phase_s']:.1f} s, "
          f"phase 23 {s2d_spatial['phase_s']:.1f} s; phases 2-21 took "
          f"{phases_2_21_s:.1f} s, phases 2-23 {phases_s:.1f} s")
    out = Path(opts.out)
    if not out.is_absolute():
        out = HERE / out
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "kernels": kernels, "oracle_round": oracle,
                   "human_cli": human, "fused_kernels": fused,
                   "train_step": step, "campaign": campaign,
                   "microbatch": micro, "dense": dense,
                   "committee": committee, "train_cli": train_cli,
                   "eval_cli": eval_cli, "resume_pretrained": resume,
                   "device_augment": devaug, "cityscapes": city,
                   "voc_deeplab": voc, "voc_fpn": voc_fpn,
                   "voc_device_augment": voc_dev, "data_parallel": dp,
                   "rewrites": rewrites, "spatial": spatial,
                   "orbax": orbax, "spatial_s2d": s2d_spatial,
                   "phases_2_21_s": phases_2_21_s,
                   "phases_s": phases_s,
                   "summary": [entry, *fused_entries]}, f, indent=1)
    shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [entry, *fused_entries]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
