"""What every phase shares, and the phase a traffic mix names, found by
name.

A traffic file's ``phase`` names ``portbench/phases/<phase>.py``, which
defines ``Phase``, a subclass of :class:`Phase` here: its ``setup`` (the
port's round driver built over the synthetic dataset, the seeded weights
loaded, every shape the window uses warmed), ``run_window``,
``traced_work`` (the profiled stretch after a ``--trace 1`` window),
``progress`` and ``numbers`` (the comparison with the plain reference that
decides ``correct``), and ``DRIVES``: the port flags, besides those the
configuration's own keys set (:func:`port_overrides`), that its loop
honours. A configuration or traffic file that sets any other port flag is
refused: the phase would time a path it does not drive. A new loop is a
new file there; nothing here names one.
"""

from __future__ import annotations

import gc
import importlib.util
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pb import data, weights as weights_mod
from pb.trace import Spans, Stretch
from reference import augment as ref_aug, steps as ref_steps

PORT_SEED_RANGE = 40000  # the port's loader seeds numpy with seed * 100003
CALIBRATION_IMAGES = 4
# flags of the port that change no value the reference computes with, and
# that every phase's loop honours
MODEL_FLAGS = frozenset({"n_layers", "fused_ir", "pallas_dw", "n_workers"})
NETWORKS = {"deeplab": "deeplab", "fpn": "FPN"}
OPTIMIZERS = {"adam": "Adam", "sgd": "SGD"}
SCHEDULES = {"multistep": "MultiStepLR", "poly": "Poly"}
OPT_KEYS = {"adam": ("lr", "betas", "eps", "weight_decay"),
            "sgd": ("lr", "momentum", "weight_decay")}


def port_overrides(cfg: dict, traffic: dict, drives) -> dict:
    """The port's arguments for a configuration and traffic mix: every
    value the configuration states once at its top level, mapped to the
    port's flag, plus the ``port_args`` of both files, which may name only
    flags in ``drives``."""
    given = {**cfg.get("port_args", {}), **traffic.get("port_args", {})}
    undriven = sorted(set(given) - set(drives))
    if undriven:
        raise ValueError(f"port flags {undriven} are set for a phase that "
                         f"drives only {sorted(drives)}")
    opt = cfg["optimizer"]
    over = dict(given, network_name=NETWORKS[cfg["network"]],
                optimizer_type=OPTIMIZERS[opt["type"]],
                lr_scheduler_type=SCHEDULES[opt["schedule"]],
                optimizer_params={k: opt[k] for k in OPT_KEYS[opt["type"]]})
    for key in ("n_classes", "ignore_index", "mean", "std", "batch_size",
                "n_epochs", "n_pixels_by_us", "top_n_percent",
                "query_strategy", "pool_batch_size", "val_batch_size",
                "width_multiplier", "precision", "mc_dropout_p",
                "size_base"):
        if key in cfg:
            over[key] = cfg[key]
    if "dilate_scale" in cfg:
        over["use_dilated_resnet"] = cfg["dilate_scale"] == 8
    if "size_base" in cfg:
        over["size_crop"] = cfg["train_hw"][0]
    return over


def agreed(cfg: dict, args, crop_size) -> None:
    """Raise unless the port's round driver took what the configuration
    states where the port fixes a value itself: the two groups' optimizer
    settings, the training crop and TF32."""
    from pixelpick_tpu_torch.engine.optim import param_group_table

    opt, table = cfg["optimizer"], param_group_table(args)
    want = {"backbone": opt["backbone_lr"], "heads": opt["lr"]}
    for group, lr in want.items():
        got = table[group]
        pairs = [(got["lr"], lr), (got["wd"], opt["weight_decay"])]
        pairs += [(got["momentum"], opt["momentum"])] if "momentum" in opt \
            else [(tuple(got["betas"]), tuple(opt["betas"])),
                  (got["eps"], opt["eps"])]
        if any(a != b for a, b in pairs):
            raise ValueError(f"the port's {group} optimizer settings {got} "
                             f"are not the configuration's {opt}")
    if tuple(crop_size) != tuple(cfg["train_hw"]):
        raise ValueError(f"the port crops {tuple(crop_size)}, the "
                         f"configuration states {cfg['train_hw']}")
    if torch.backends.cudnn.allow_tf32 != cfg["tf32"] \
            or torch.backends.cuda.matmul.allow_tf32 != cfg["tf32"]:
        raise ValueError("TF32 is not as the configuration states")


class LoaderProxy:
    """A port ``Loader`` that times the wait for each batch (span
    ``loader_wait``), stops giving batches at ``deadline`` (once ``given``
    has reached ``at_least``) or after ``limit`` batches of one epoch, and
    keeps the (epoch, dataset indices) of the batch it gave last;
    ``feed`` replaces its batches by given ones. Every other attribute is
    the loader's."""

    def __init__(self, loader, spans: Spans):
        self.loader, self.spans = loader, spans
        self.deadline: Optional[float] = None
        self.limit: Optional[int] = None
        self.at_least = 0
        self.given = 0
        self.last_plan = None
        self.feed = None

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return len(self.loader)

    def _open(self) -> bool:
        return self.deadline is None or self.given < self.at_least \
            or time.perf_counter() < self.deadline

    def __iter__(self):
        if self.feed is not None:
            yield from self.feed
            return
        epoch = self.loader.epoch
        plan = self.loader.batch_index_plan(epoch) \
            if self.loader.mode == "train" else None
        it, n = iter(self.loader), 0
        while (self.limit is None or n < self.limit) and self._open():
            with self.spans.span("loader_wait"):
                batch = next(it, None)
            if batch is None:  # the epoch's end: no batch waited for
                self.spans.drop_last("loader_wait")
                return
            self.last_plan = (epoch, plan[n]) if plan is not None else None
            n += 1
            self.given += 1
            yield batch


class Phase:
    """Set-up, window and what they leave for the metrics and the check."""

    DRIVES = MODEL_FLAGS

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device, workdir: Path, fault: Optional[str] = None):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds = seed, seconds
        self.device = torch.device(device)
        self.workdir = workdir
        self.fault = fault
        self.spans = Spans()
        self.stretch = Stretch(self.spans) if trace else None
        self.window = {}

    # ----------------------------- set-up -----------------------------

    def build(self) -> None:
        from pixelpick_tpu_torch.active.driver import ALModel
        from pixelpick_tpu_torch.config import default_args
        from pixelpick_tpu_torch.models.factory import get_model
        from pixelpick_tpu_torch.ops import build

        cfg = self.cfg
        over = port_overrides(cfg, self.traffic, self.DRIVES)
        if self.device.type == "cuda":
            build.build_all(["depthwise", "fused_ir"])
        reads = self.traffic["reads"]
        counts = {"train": cfg["n_train"] if reads == "train" else 1,
                  "val": cfg["n_val"] if reads == "val" else 1}
        self.data = data.write(cfg, self.seed, self.workdir / "data", counts,
                               self.device)
        self.port_seed = self.seed % PORT_SEED_RANGE
        over.update(dir_dataset=str(self.data.root), device=self.device.type,
                    dir_checkpoints=str(self.workdir / "run"),
                    seed=self.port_seed, debug=False)
        self.args = default_args(cfg["dataset"], **over)
        self.al = ALModel(self.args)
        self.weights = weights_mod.make(cfg, self.seed, self.device)
        if reads == "val" or self.traffic["phase"] == "sweep":
            x = torch.from_numpy(np.stack(
                self.data.images[reads][:CALIBRATION_IMAGES])).to(self.device)
            self.weights.update(ref_steps.calibrated_running_stats(
                self.weights, x, cfg))
        self.model = get_model(self.args, self.device, seed=self.port_seed)
        self.model.load_state_dict(self.weights)
        agreed(cfg, self.args, self.al.dataset.crop_size)
        self.al.model = self.model
        self.al.nth_query = 0
        self.al.log_train = str(self.workdir / "run" / "log_train.txt")
        self.al.log_val = str(self.workdir / "run" / "log_val.txt")
        (self.workdir / "run").mkdir(parents=True, exist_ok=True)

    def labelled_masks(self, salt: int):
        """The labelled pixels of the rounds before, drawn by the benchmark
        from the seed (``data.labelled_masks``) at the size the port's
        train and pool samples start from, and handed to the port."""
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed ^ salt) & ((1 << 63) - 1))
        labels = [ref_aug.base_resized_label(y, self.cfg)
                  for y in self.data.labels["train"]]
        self.masks = data.labelled_masks(labels,
                                         self.cfg["labelled_per_image"],
                                         self.cfg["ignore_index"], gen)
        self.al.dataset.queries = self.al.dataset_query.queries = \
            list(self.masks)

    def fill_cache(self, dataset) -> None:
        """Decode every image and label of ``dataset`` into the port's RAM
        cache, as a round's first epoch or pass does."""
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(lambda i: (dataset._load_x(i), dataset._load_y(i)),
                          range(len(dataset))))

    @staticmethod
    def launches() -> dict:
        """The port's kernel launch counters (``ops/fused_ir.py``,
        ``ops/depthwise.py``)."""
        from pixelpick_tpu_torch.ops import depthwise, fused_ir

        return {**fused_ir.launch_counts,
                **{f"depthwise_{k}": v
                   for k, v in depthwise.launch_counts.items()}}

    def open_window(self) -> float:
        """The window's start: the set-up's spans dropped."""
        self.spans.clear()
        return time.perf_counter()

    def run_stretch(self) -> None:
        """With ``--trace 1``, after the window: the profiler over a short
        stretch of the same loop (``traced_work``), so that neither its
        start, which takes seconds, nor its cost per launch falls in the
        window that the host spans and the rates are read from."""
        st = self.stretch
        if st is None:
            return
        st.start()
        st.work.update({"from": self.progress(),
                        "launches_from": self.launches()})
        self.traced_work()
        st.stop()
        st.work.update(to=self.progress(), launches_to=self.launches())

    def free_program(self) -> None:
        """Release the port's round driver and model before the reference
        runs."""
        self.al.close()
        self.al = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def make(cell, **kw) -> Phase:
    """The ``Phase`` of ``portbench/phases/<phase>.py``, for the phase the
    cell's traffic names."""
    name = cell.traffic["phase"]
    path = cell.bench_dir / "phases" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_phase_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Phase(cell, **kw)
