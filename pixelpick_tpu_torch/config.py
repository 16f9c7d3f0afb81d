"""Configuration / flag surface.

The same flags as ``pixelpick_tpu.config`` (same names, defaults and
choices, which follow the reference ``args.py:10-205``), the per-dataset
hyper-parameter blocks, the YAML overlay and the experiment-name builder —
kept here as an own copy so the port imports nothing of the JAX package.

Two flags are the port's own: ``--device {cuda,cpu}`` (default ``cuda``)
and ``--dist_backend {auto,nccl,gloo}`` (``parallel/distributed.py``).

Every flag of the JAX package runs its own code path, in every combination
the JAX package runs, and nothing quietly runs another path in its place.
"""

from __future__ import annotations

import os
import random
from argparse import ArgumentParser, Namespace
from pprint import pformat

import numpy as np
import yaml


def build_parser() -> ArgumentParser:
    parser = ArgumentParser("PixelPick-Torch")

    # generic (reference args.py:14-21)
    parser.add_argument("--debug", "-d", action="store_true", default=False)
    parser.add_argument("--dir_root", type=str, default="..")
    parser.add_argument("--dir_checkpoints", type=str, default="")
    parser.add_argument("--gpu_ids", type=str, nargs="+", default="0",
                        help="kept for CLI compatibility; ignored (use "
                             "--device)")
    parser.add_argument("--n_workers", type=int, default=4)
    parser.add_argument("--network_name", type=str, default="deeplab",
                        choices=["deeplab", "FPN"])
    parser.add_argument("--seed", "-s", type=int, default=0)
    parser.add_argument("--suffix", type=str, default="")

    # active learning (args.py:24-28)
    parser.add_argument("--n_pixels_by_us", type=int, default=10,
                        help="# pixels selected by uncertainty sampling per round")
    parser.add_argument("--top_n_percent", type=float, default=0.05)
    parser.add_argument("--query_strategy", "-qs", type=str, default="margin_sampling",
                        choices=["least_confidence", "margin_sampling", "entropy", "random"])
    parser.add_argument("--reverse_order", action="store_true", default=False)

    # MC-dropout committee (args.py:31-34)
    parser.add_argument("--use_mc_dropout", action="store_true", default=False)
    parser.add_argument("--mc_dropout_p", type=float, default=0.2)
    parser.add_argument("--mc_n_steps", type=int, default=20)
    parser.add_argument("--vote_type", type=str, default="soft", choices=["soft", "hard"])
    parser.add_argument("--mc_dropout2d_committee", action="store_true",
                        default=False,
                        help="also activate the MobileNetV2 Dropout2d sites "
                             "during MC-committee scoring (see "
                             "pixelpick_tpu.config)")

    # budget (args.py:37-39)
    parser.add_argument("--n_init_pixels", type=int, default=0)
    parser.add_argument("--max_budget", type=int, default=100,
                        help="maximum budget in pixels per image")
    parser.add_argument("--nth_query", type=int, default=1)

    # dataset (args.py:42-47)
    parser.add_argument("--dataset_name", type=str, default="cv",
                        choices=["cs", "cv", "voc", "custom"])
    parser.add_argument("--dir_datasets", type=str, default="/datasets")
    parser.add_argument("--downsample", type=int, default=4,
                        help="downsample factor for the Cityscapes training set")
    parser.add_argument("--use_aug", type=lambda s: s not in ("0", "false", "False"),
                        default=True)
    parser.add_argument("--use_augmented_dataset", action="store_true", default=False)
    parser.add_argument("--dir_augmented_dataset", type=str, default="",
                        help="root of the augmented VOC train set "
                             "({root}/images, {root}/annot pairs); defaults to "
                             "{dir_dataset}/VOCdevkit/VOC2012/train_aug "
                             "(reference args.py:133)")

    # encoder (args.py:50-55)
    parser.add_argument("--n_layers", type=int, default=50, choices=[18, 34, 50, 101])
    parser.add_argument("--use_dilated_resnet", type=lambda s: s not in ("0", "false", "False"),
                        default=True)
    parser.add_argument("--weight_type", type=str, default="supervised",
                        choices=["random", "supervised", "moco_v2"])
    parser.add_argument("--width_multiplier", type=float, default=1.0)

    # flags the reference only defines in tool __main__s (train.py:187-195,
    # query.py:364-367, eval.py:104-109) — first-class here
    parser.add_argument("--p_dataset_config", "-pdc", type=str, default=None)
    parser.add_argument("--p_state_dict", type=str, default="")
    parser.add_argument("--eval_interval", type=int, default=1)
    parser.add_argument("--visualize_interval", type=int, default=100,
                        help="standalone eval CLI: write a 6-panel PNG "
                             "every N val images (reference eval.py:133 "
                             "hard-codes 100)")

    # ---- extensions of the JAX package (no reference equivalent) ----
    parser.add_argument("--precision", type=str, default="f32",
                        choices=["f32", "bf16"],
                        help="compute dtype for conv/matmul inside the model")
    parser.add_argument("--bn_group_size", type=int, default=0,
                        help="ghost BatchNorm group size for training "
                             "(eval-mode BN uses running statistics)")
    parser.add_argument("--val_batch_size", type=int, default=1,
                        help="validation batch size (reference uses 1, "
                             "utils.py:75-109)")
    parser.add_argument("--pool_batch_size", type=int, default=32,
                        help="images per device step during pool scoring "
                             "(reference uses batch-size 1, query.py:159)")
    parser.add_argument("--micro_batch_size", type=int, default=0,
                        help="execute each train batch as sequential "
                             "optimizer updates of this size; 0 = one "
                             "update per batch")
    parser.add_argument("--prng", type=str, default="auto",
                        choices=["auto", "threefry", "rbg"],
                        help="jax PRNG implementation; accepted for flag "
                             "compatibility, unused by the port")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="number of devices on the data axis; 0 = all "
                             "available devices")
    parser.add_argument("--dist_coordinator", type=str, default="",
                        help="multi-host mode: coordinator host:port. "
                             "Empty = single-process")
    parser.add_argument("--dist_num_processes", type=int, default=1,
                        help="total number of processes (one per host)")
    parser.add_argument("--dist_process_id", type=int, default=0,
                        help="this process's rank in [0, dist_num_processes)")
    parser.add_argument("--spatial_query_sharding", action="store_true",
                        default=False,
                        help="shard pool-sweep images over devices by "
                             "HEIGHT stripes instead of by batch")
    parser.add_argument("--pretrained_ckpt", type=str, default="",
                        help="path to a converted pretrained backbone "
                             "checkpoint (a JAX msgpack file), overlaid on "
                             "every round's fresh model")
    parser.add_argument("--device_augment", action="store_true", default=False,
                        help="run the augmentation pipeline on the device")
    parser.add_argument("--pallas_dw", action="store_true", default=False,
                        help="run the stride-1 depthwise 3x3 convs through "
                             "the hand-written kernel (ops/depthwise.py, "
                             "csrc/depthwise.cu) instead of the library's "
                             "grouped conv; the flag keeps the JAX "
                             "package's name")
    parser.add_argument("--s2d_backbone",
                        type=lambda s: s not in ("0", "false", "False"),
                        default=False,
                        help="evaluate the first 4 MobileNetV2 blocks in "
                             "space-to-depth layout (an exact rewrite, "
                             "models/s2d_block.py; DeepLab only, the FPN "
                             "ignores it)")
    parser.add_argument("--fused_ir", action="store_true", default=False,
                        help="in training, run the stride-1 t=6 MobileNetV2 "
                             "blocks through the fused inverted-residual "
                             "kernels (ops/fused_ir.py, csrc/fused_ir.cu)")
    parser.add_argument("--conv3x3_matmul", action="store_true", default=False,
                        help="lower same-shape stride-1 3x3 convs to 9 tap "
                             "channel matmuls (models/layers.py:"
                             "Conv3x3MatMul)")
    parser.add_argument("--ckpt_backend", type=str, default="msgpack",
                        choices=["msgpack", "orbax"],
                        help="best-model checkpoint format: msgpack writes "
                             "the reference's torch file; orbax writes the "
                             "JAX package's <path>.orbax/step_N/ directory "
                             "on a background thread. Loading reads either, "
                             "and the JAX package's msgpack files")
    parser.add_argument("--stage_ckpt_interval", type=int, default=0,
                        help="save a resumable mid-stage snapshot every N "
                             "epochs; 0 = off")
    parser.add_argument("--resume_campaign", action="store_true",
                        default=False,
                        help="fast-forward AL rounds whose next-round "
                             "queries.pkl already exists on disk")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write profiler traces of the train and query "
                             "phases to this directory")

    # ---- the port's own ----
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the model runs; cuda raises if no card "
                             "is visible (nothing falls back to the CPU)")
    parser.add_argument("--dist_backend", type=str, default="auto",
                        choices=["auto", "nccl", "gloo"],
                        help="torch.distributed backend of the ranks: auto "
                             "is nccl on cuda and gloo on the cpu (gloo "
                             "also lets two ranks share one card)")
    return parser


# per-dataset hyper-parameter blocks, mirroring reference args.py:88-152
DATASET_DEFAULTS = {
    "cs": dict(
        batch_size=4,
        ignore_index=19,
        mean=[0.28689554, 0.32513303, 0.28389177],
        std=[0.18696375, 0.19017339, 0.18720214],
        n_classes=19,
        n_epochs=50,
        optimizer_type="Adam",
        lr_scheduler_type="Poly",
        optimizer_params={"lr": 5e-4, "betas": (0.9, 0.999),
                          "weight_decay": 2e-4, "eps": 1e-7},
        dir_dataset_name="cityscapes",
    ),
    "cv": dict(
        batch_size=4,
        downsample=1,
        ignore_index=11,
        mean=[0.41189489566336, 0.4251328133025, 0.4326707089857],
        std=[0.27413549931506, 0.28506257482912, 0.28284674400252],
        n_classes=11,
        n_epochs=50,
        optimizer_type="Adam",
        lr_scheduler_type="MultiStepLR",
        optimizer_params={"lr": 5e-4, "betas": (0.9, 0.999),
                          "weight_decay": 2e-4, "eps": 1e-7},
        dir_dataset_name="camvid",
    ),
    "voc": dict(
        batch_size=10,
        ignore_index=255,
        mean=[0.485, 0.456, 0.406],
        std=[0.229, 0.224, 0.225],
        n_classes=21,
        n_epochs=50,
        size_base=400,
        size_crop=320,
        optimizer_type="SGD",
        lr_scheduler_type="Poly",
        optimizer_params={"lr": 1e-2, "weight_decay": 1e-4, "momentum": 0.9},
        dir_dataset_name="VOC2012",
    ),
}


def finalize_args(args: Namespace, write_files: bool = True) -> Namespace:
    """Apply derived fields, dataset blocks, YAML overlay, naming and seeding
    (reference ``args.py:59-205``; ``pixelpick_tpu.config.finalize_args``
    without its jax set-up). Joins the ranks ``--dist_coordinator`` names
    (``parallel/distributed.py``); only the primary writes ``args.txt``."""
    from pixelpick_tpu_torch.parallel import distributed
    distributed.initialize_from_args(args)
    if args.pallas_dw:
        from pixelpick_tpu_torch.models.layers import set_depthwise_impl
        set_depthwise_impl("pallas")
    if args.conv3x3_matmul:
        from pixelpick_tpu_torch.models.layers import set_conv3x3_impl
        set_conv3x3_impl("matmul")
    args.augmentations = {
        "geometric": {
            "random_scale": args.use_aug,
            "random_hflip": args.use_aug,
            "crop": args.use_aug,
        },
        "photometric": {
            "random_color_jitter": args.use_aug,
            "random_grayscale": args.use_aug,
            "random_gaussian_blur": args.use_aug,
        },
    }
    args.stride_total = 8 if args.use_dilated_resnet else 32

    if getattr(args, "p_dataset_config", None):
        if not os.path.exists(args.p_dataset_config):
            raise FileNotFoundError(args.p_dataset_config)
        with open(args.p_dataset_config) as f:
            overlay = yaml.safe_load(f)
        d = vars(args)
        d.update(overlay)
        args = Namespace(**d)
    else:
        block = DATASET_DEFAULTS.get(args.dataset_name)
        if block is None:
            raise ValueError(f"Unsupported dataset name: {args.dataset_name}; "
                             f"pass --p_dataset_config for a custom dataset")
        for k, v in block.items():
            if k == "dir_dataset_name":
                if not getattr(args, "dir_dataset", None):
                    args.dir_dataset = os.path.join(args.dir_datasets, v)
            else:
                setattr(args, k, v)
    if not getattr(args, "dir_augmented_dataset", ""):
        # reference args.py:133 hardcodes this path under the VOC root
        args.dir_augmented_dataset = os.path.join(
            getattr(args, "dir_dataset", args.dir_datasets),
            "VOCdevkit", "VOC2012", "train_aug")

    # experiment-name builder (args.py:154-180)
    kw = [args.dataset_name]
    if args.dataset_name == "cs":
        kw.append(f"d{args.downsample}")
    kw.append(args.network_name)
    if args.network_name == "FPN":
        kw += [str(args.n_layers), str(args.weight_type)]
    if args.n_pixels_by_us > 0:
        kw.append(args.query_strategy)
        if args.use_mc_dropout:
            kw.append(args.vote_type)
        kw.append(str(args.n_pixels_by_us))
        if args.top_n_percent > 0.0:
            kw.append(f"p{args.top_n_percent}")
        if args.reverse_order:
            kw.append("reverse")
    else:
        kw.append("fully_sup")
    kw.append(str(args.seed))
    if args.suffix:
        kw.append(args.suffix)
    if args.debug:
        kw.append("debug")
    args.experim_name = "_".join(kw)

    if not args.dir_checkpoints:
        args.dir_checkpoints = f"{args.dir_root}/checkpoints/{args.experim_name}"
    if write_files and distributed.is_primary():
        os.makedirs(args.dir_checkpoints, exist_ok=True)
        with open(f"{args.dir_checkpoints}/args.txt", "w") as f:
            f.write(pformat(vars(args)))

    # host-side seeding; device randomness comes from explicit generators
    random.seed(args.seed)
    np.random.seed(args.seed)
    return args


class Arguments:
    """Drop-in replacement for the reference ``Arguments`` class (args.py:10)."""

    def __init__(self):
        self.parser = build_parser()

    def parse_args(self, argv=None, verbose: bool = False) -> Namespace:
        args = self.parser.parse_args(argv)
        args = finalize_args(args)
        if verbose:
            for k, v in sorted(vars(args).items()):
                print(k, v)
        print(f"\nmodel name: {args.experim_name}\n")
        return args


def default_args(dataset_name: str = "cv", write_files: bool = False,
                 **overrides) -> Namespace:
    """Programmatic config: defaults for ``dataset_name`` plus overrides."""
    parser = build_parser()
    args = parser.parse_args([])
    args.dataset_name = dataset_name
    for k, v in overrides.items():
        setattr(args, k, v)
    args = finalize_args(args, write_files=write_files)
    for k, v in overrides.items():  # overrides win over dataset blocks too
        if k in vars(args):
            setattr(args, k, v)
    return args
