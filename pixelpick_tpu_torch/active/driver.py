"""The active-learning driver — reference ``model.py:14 Model``.

Counterpart of ``pixelpick_tpu/active/driver.py``, on one device. Each of
``max_budget // n_pixels_by_us`` rounds (``__call__``, ``driver.py:134-175``)
trains a fresh model for ``n_epochs`` with a validation and a best-mIoU
checkpoint after each epoch (``_run_stage``), sweeps the pool for the next
pixels (``active/selector.py``), oracle-labels them and dumps the round's
artifacts: ``queries.pkl``, ``query_stats.pkl``, ``log_{train,val}.txt``,
``{epoch}_{train,val}.png``, ``best_miou_model.ckpt``, ``timing.json``. The
last round queries and labels before it stops, so ``{n}_query/queries.pkl``
exists, as the reference's (``model.py:82-87``).

Each round's model weights come from a generator seeded with
``(seed * 7919 + nth_query + 1) & 0x7FFFFFFF`` (``driver.py:199``), and its
dropout masks from one seeded with that value ``^ 0x5EED``. The loss and the
confusion matrix stay on the device through an epoch and are read once at
its end.

Round modes: ``--micro_batch_size M`` trains each loader batch as
sequential bs-M updates (``engine/trainer.py:make_microbatch_train_step``;
``driver.py:207-217, 390-437``); ``--n_pixels_by_us 0`` runs one fully
supervised stage, ``fully_sup``, with the dense step and no query
(``driver.py:135-137``); ``--use_mc_dropout`` scores the pool with the
MC-dropout committee (``active/acquisition.py``).

Checkpoints (``driver.py:143-162, 178-205, 270-294``):
``--pretrained_ckpt`` overlays a JAX msgpack file on every round's fresh
model; ``--ckpt_backend orbax`` saves each best model as JAX's orbax
``best_miou_model.ckpt.orbax/step_N/`` on a background thread, waited for
before the query (``driver.py:298-300``); ``--stage_ckpt_interval N``
snapshots a stage after validation every N epochs and resumes it from
``{stage}/stage_state.ckpt`` on a rerun, the port's snapshot or the JAX
package's;
``--resume_campaign`` fast-forwards a round whose next ``queries.pkl``
exists. Human labels (``human_labels``, ``cli/train.py``) train on merged
per-image label maps.

``--device_augment`` (``driver.py:108-120, 235-236, 438-449``) stages the
train set on the device (``data/device_pipeline.py``) and draws each sparse
batch there; the host only plans the batches' indices. Each batch's draws
come from a generator seeded with (round seed, epoch, batch index), so a
resumed stage draws the straight run's augmentations. The flag is inert in
the dense and human-label stages, as in the JAX package.

Variable-size datasets (VOC) validate and sweep the pool through bucketed
loaders (``data/loader.py``, ``driver.py:80-104``): each batch is padded to
its bucket, a multiple of ``stride_total``, with ignore-index labels and
excluded pixels, and the eval step reads it as it is (``driver.py:450-470``).
With ``--device_augment`` they stage padded images beside their true sizes
(``data/device_pipeline.py``).

Data parallelism (``parallel/``; JAX ``driver.py:91-101, 193-563``): every
rank builds the same datasets, loaders and round models from the same
seeds, holds each global batch and computes its rows of it. A remainder
train batch pads to a multiple of the world size when the full batches
shard (``_train_pad_multiple``); the validation batch rounds up to a
multiple of it, its remainder padded with ignore-labelled rows, and its
confusion matrix is summed over the ranks, so that every rank takes the
same best-mIoU decisions. Logs, PNGs, ``best_miou_model.ckpt``, stage
snapshots, ``timing.json`` and the round's picks are written by the
primary rank only.
"""

from __future__ import annotations

import math
import os
import pickle as pkl
import time

import numpy as np
import torch

from pixelpick_tpu_torch.active.selector import QuerySelector
from pixelpick_tpu_torch.data import base as data_base
from pixelpick_tpu_torch.data.device_pipeline import DevicePipeline
from pixelpick_tpu_torch.data.factory import get_dataset
from pixelpick_tpu_torch.data.loader import Loader
from pixelpick_tpu_torch.engine.checkpoint import (
    load_stage_state, save_checkpoint, save_stage_state,
    wait_for_checkpoints,
)
from pixelpick_tpu_torch.engine.optim import make_optimizer
from pixelpick_tpu_torch.engine.trainer import (
    batch_to_device, make_dense_train_step, make_eval_step,
    make_microbatch_train_step, make_train_step,
)
from pixelpick_tpu_torch.models.convert import load_pretrained_ckpt
from pixelpick_tpu_torch.models.factory import get_model, resolve_device
from pixelpick_tpu_torch.parallel import distributed, mesh
from pixelpick_tpu_torch.parallel.mesh import pad_batch_to_devices
from pixelpick_tpu_torch.utils.logging import write_log
from pixelpick_tpu_torch.utils.metrics import AverageMeter, RunningScore
from pixelpick_tpu_torch.utils.profiling import (
    PhaseTimer, enabled as tracing, span, trace,
)
from pixelpick_tpu_torch.utils.visualiser import Visualiser, render_vis_panels


def round_seed(seed: int, nth_query: int) -> int:
    return (seed * 7919 + nth_query + 1) & 0x7FFFFFFF


class ALModel:
    def __init__(self, args, human_labels: bool = False,
                 human_inputs=None, human_maps=None):
        """``human_inputs``/``human_maps``: the merged human-labelled image
        paths and label maps of ``cli/train.py``, installed before the
        loaders plan their batches (``driver.py:45-71``)."""
        self.args = args
        self.device = resolve_device(args.device)
        self.dir_checkpoints = args.dir_checkpoints
        self.experim_name = args.experim_name
        self.best_miou = -1.0
        self.nth_query = -1
        self.stage_seed = 0  # the running stage's round seed
        self.human_labels = human_labels

        self.dataset = get_dataset(args, val=False, query=False)
        self.dataset_query = get_dataset(args, val=False, query=True,
                                         generate_init_queries=False)
        if human_inputs is not None:
            if not human_labels:
                raise ValueError("human_inputs needs human_labels=True")
            self.dataset.set_human_inputs(human_inputs, human_maps)
            self.dataset_query.set_human_inputs(human_inputs, human_maps)
        else:
            self.dataset_query.queries = self.dataset.queries
            self.dataset_query.n_pixels_total = self.dataset.n_pixels_total
        self.dataset_val = get_dataset(args, val=True, query=False)

        self.fully_sup = args.n_pixels_by_us == 0
        self.device_pipe = None
        if getattr(args, "device_augment", False):
            if self.fully_sup or human_labels:
                print("--device_augment is inert in the "
                      f"{'dense' if self.fully_sup else 'human-label'} "
                      "stage: the host loader augments its batches")
            else:
                self.device_pipe = DevicePipeline(self.dataset, args,
                                                  self.device)
                # a remainder megabatch pads to a micro multiple, and to a
                # world-size multiple when the full batches shard
                self.device_pipe.pad_multiple = self._micro_bs() or 1
                self.device_pipe.micro_bs = self._micro_bs()
                self.device_pipe.pad_to_devices = \
                    args.batch_size % distributed.world_size() == 0
        self.loader = Loader(self.dataset, args.batch_size,
                             mode="train_dense" if self.fully_sup else "train",
                             shuffle=True, n_workers=args.n_workers,
                             seed=args.seed, human_labels=human_labels,
                             drop_unit=self._micro_bs() or None)
        # variable-size datasets (VOC) load val and query in shape buckets
        bucket = args.stride_total \
            if getattr(self.dataset_val, "variable_size", False) else None
        self.loader_query = Loader(self.dataset_query, args.pool_batch_size,
                                   mode="query", n_workers=args.n_workers,
                                   human_labels=human_labels,
                                   bucket_stride=bucket,
                                   pad_label=args.ignore_index)
        # under data parallelism the validation batch rounds up to a
        # multiple of the world size (driver.py:91-101)
        world = distributed.world_size()
        val_bs = -(-getattr(args, "val_batch_size", 1) // world) * world
        self.loader_val = Loader(self.dataset_val, val_bs,
                                 mode="val", n_workers=args.n_workers,
                                 bucket_stride=bucket,
                                 pad_label=args.ignore_index)
        self.vis = Visualiser(args.dataset_name)
        self.running_loss = AverageMeter()
        self.model = None

    def close(self) -> None:
        """Release the loaders' worker threads."""
        for ld in (self.loader, self.loader_query, self.loader_val):
            ld.close()

    # ----------------------------- rounds -----------------------------

    def __call__(self):
        args = self.args
        if self.fully_sup:
            self._run_stage("fully_sup")
            return
        n_stages = args.max_budget // args.n_pixels_by_us
        n_stages += 1 if args.n_init_pixels > 0 else 0
        print("n_stages:", n_stages)
        profile_dir = getattr(args, "profile_dir", "")
        distributed.barrier()  # every rank reads the same files below
        for nth_query in range(n_stages):
            self.nth_query = nth_query
            # a round whose next queries.pkl exists ran to its end: merge
            # its recorded picks, with no training and no new artifacts
            next_pkl = f"{self.dir_checkpoints}/{nth_query + 1}_query/" \
                "queries.pkl"
            if getattr(args, "resume_campaign", False) \
                    and os.path.isfile(next_pkl):
                print(f"resume_campaign: round {nth_query} is complete; "
                      f"fast-forwarding past its training and query")
                with open(next_pkl, "rb") as f:
                    self.dataset.label_queries(pkl.load(f), None)
                if nth_query == n_stages - 1:
                    break
                continue
            model = self._run_stage(f"{nth_query}_query")
            selector = QuerySelector(args, self.loader_query, model,
                                     self.device)
            with trace(f"{profile_dir}/query" if profile_dir
                       and nth_query == 0 else None):
                queries = selector(nth_query, human_labels=self.human_labels)
            if tracing() and distributed.is_primary():
                # the stage's timing.json again, with the sweep's spans
                self.timer.dump(f"{self.dir_checkpoints}/{nth_query}_query/"
                                "timing.json")
            self.dataset.label_queries(queries, nth_query + 1)
            # the reference queries and labels before breaking on the last
            # stage (model.py:82-87)
            if nth_query == n_stages - 1:
                break

    def _run_stage(self, stage_name: str) -> torch.nn.Module:
        args = self.args
        dir_stage = f"{self.dir_checkpoints}/{stage_name}"
        os.makedirs(dir_stage, exist_ok=True)
        self.log_train = f"{dir_stage}/log_train.txt"
        self.log_val = f"{dir_stage}/log_val.txt"
        stage_ckpt = int(getattr(args, "stage_ckpt_interval", 0) or 0)
        p_stage_state = f"{dir_stage}/stage_state.ckpt"
        distributed.barrier()
        resuming = stage_ckpt > 0 and os.path.isfile(p_stage_state)
        if not resuming and distributed.is_primary():
            # a resumed stage appends to its logs
            write_log(self.log_train,
                      header=["epoch", "mIoU", "pixel_acc", "loss"])
            write_log(self.log_val, header=["epoch", "mIoU", "pixel_acc"])

        # a fresh model per round (model.py:163)
        seed = self.stage_seed = round_seed(args.seed, self.nth_query)
        model = get_model(args, self.device, seed=seed)
        if getattr(args, "pretrained_ckpt", ""):
            load_pretrained_ckpt(model, args.pretrained_ckpt)
        distributed.check_replicated(model)
        # the dropout masks' one stateful stream; a snapshot carries its
        # state, so a resumed stage draws the masks of the straight run
        generator = torch.Generator(device=self.device).manual_seed(
            seed ^ 0x5EED)
        model.set_dropout_generator(generator)
        self.model = model
        micro = self._micro_bs()
        optimizer = make_optimizer(args, model, self._iters_per_epoch())
        kw = dict(n_classes=args.n_classes, mean=args.mean, std=args.std)
        if self.fully_sup:
            step_fn = make_dense_train_step(
                model, optimizer, ignore_index=args.ignore_index, **kw)
        elif micro:
            step_fn = make_microbatch_train_step(
                model, optimizer, micro_bs=micro,
                normalize=self.device_pipe is None, **kw)
        else:
            step_fn = make_train_step(model, optimizer,
                                      normalize=self.device_pipe is None,
                                      **kw)
        if self.device_pipe is not None:
            self.device_pipe.set_queries(self.dataset.queries)
        eval_fn = make_eval_step(model, n_classes=args.n_classes,
                                 mean=args.mean, std=args.std)

        self.best_miou = -1.0
        start_epoch = 1
        if resuming:
            done_epoch, self.best_miou = load_stage_state(
                p_stage_state, model, optimizer, generator, seed=seed)
            start_epoch = done_epoch + 1
            print(f"resuming {stage_name} from {p_stage_state}: epoch "
                  f"{start_epoch} (best mIoU so far {self.best_miou:.4f})")
        self.timer = PhaseTimer()
        eval_interval = max(1, getattr(args, "eval_interval", 1))
        profile_dir = getattr(args, "profile_dir", "")
        trace_epoch = min(2, args.n_epochs) if profile_dir \
            and self.nth_query <= 0 else -1
        for epoch in range(start_epoch, 1 + args.n_epochs):
            with self.timer.phase("train", len(self.dataset)), \
                    trace(f"{profile_dir}/train" if epoch == trace_epoch
                          else None):
                last_batch = self._train_epoch(epoch, step_fn)
            if last_batch is not None and not args.debug \
                    and distributed.is_primary():
                with self.timer.phase("vis"):
                    self._visualise(eval_fn, last_batch,
                                    f"{dir_stage}/{epoch}_train.png")
            if epoch % eval_interval == 0 or epoch == args.n_epochs:
                with self.timer.phase("val", len(self.dataset_val)):
                    self._val(epoch, model, eval_fn, dir_stage)
            if stage_ckpt and epoch % stage_ckpt == 0 \
                    and epoch != args.n_epochs:
                # after validation, so that best_miou is current
                with self.timer.phase("stage_ckpt"):
                    save_stage_state(p_stage_state, model, optimizer,
                                     generator, epoch, self.best_miou)
            if args.debug:
                break
        if distributed.is_primary():
            if stage_ckpt and os.path.isfile(p_stage_state):
                os.remove(p_stage_state)  # a complete stage starts afresh
            self.timer.dump(f"{dir_stage}/timing.json")
        wait_for_checkpoints()  # the best model on disk before the query
        return model

    # ----------------------------- epochs -----------------------------

    def _train_epoch(self, epoch: int, step_fn):
        args = self.args
        if not self.fully_sup:
            print(f"training epoch {epoch} of {self.nth_query}th query "
                  f"({self.dataset.n_pixels_total} labelled pixels)")
        self.loader.set_epoch(epoch)
        score = RunningScore(args.n_classes)
        self.running_loss.reset()
        t0 = time.time()
        n_imgs = 0
        losses = []
        overflows = []
        last_batch = None
        micro = self._micro_bs()
        pad_mult = self._train_pad_multiple()
        batches = self._epoch_batches(epoch)
        while True:
            with span("train.load"):
                batch = next(batches, None)
            if batch is None:
                break
            if self.device_pipe is not None:
                n_real = batch["n_real"]
                overflows.append(batch["overflow"])
                loss, hist = step_fn(batch) if micro \
                    else step_fn(batch, batch["shard"])
            else:
                # a remainder batch (CamVid 367 % 48 = 31) pads with inert
                # rows to a micro multiple, and to a world-size multiple
                # when the full batches shard
                with span("train.upload"):
                    batch, n_real = pad_batch_to_devices(
                        batch, pad_label=args.ignore_index, multiple=pad_mult)
                    if not micro:
                        shard = mesh.row_shard(batch["x"].shape[0])
                        dev = batch_to_device(mesh.shard_batch(batch, shard),
                                              self.device)
                if micro:  # the step shards and uploads the megabatch once
                    loss, hist = step_fn(batch)
                else:
                    loss, hist = step_fn(dev, shard)
            losses.append(loss.reshape(-1))
            score.merge(hist)
            n_imgs += n_real
            last_batch = batch
            if args.debug:
                break
        with span("train.close"):
            self._close_epoch(epoch, losses, overflows, score, n_imgs, t0)
        return last_batch

    def _close_epoch(self, epoch, losses, overflows, score, n_imgs, t0):
        # the epoch-mean loss over optimizer updates, read from the device
        # once (model.py:126,147); NaN marks an all-pad micro-batch, which
        # made no update
        if losses:
            for v in torch.cat(losses).cpu().numpy():
                if np.isfinite(v):
                    self.running_loss.update(float(v))
        if overflows:
            # labelled pixels that crops held beyond k_max, read once per
            # epoch (driver.py:364-378): the counters of the host extractor
            n_over = int(torch.stack(overflows).sum())
            if n_over:
                data_base.SPARSE_OVERFLOW_COUNT += 1
                data_base.SPARSE_OVERFLOW_PIXELS += n_over
                print(f"WARNING: device sparse extraction dropped {n_over} "
                      f"labelled pixels (crops exceeded k_max) this epoch")
        scores = score.get_scores()[0]
        miou, pixel_acc = scores["Mean IoU"], scores["Pixel Acc"]
        dt = time.time() - t0
        print(f"({self.experim_name}) Epoch {epoch} | mIoU: {miou:.3f} | "
              f"pixel acc: {pixel_acc:.3f} | loss: {self.running_loss.avg:.3f} "
              f"| {n_imgs / max(dt, 1e-9):.1f} imgs/s")
        if distributed.is_primary():
            write_log(self.log_train, list_entities=[
                epoch, miou, pixel_acc, self.running_loss.avg])

    def _epoch_batches(self, epoch: int):
        """The host loader's batches, or the device pipeline's along
        ``Loader.batch_index_plan`` (the host loader's shuffle and
        drop-last), batch ``bi``'s draws from a generator seeded with
        (round seed, ``epoch``, ``bi``), as JAX folds ``epoch * 100003 +
        bi`` into the round's key. The pipeline runs one batch ahead, so
        that a batch's host copy of its row flags is there when the step
        reads it."""
        if self.device_pipe is None:
            yield from self.loader
            return
        pending = None
        for bi, idxs in enumerate(self.loader.batch_index_plan(epoch)):
            gen = torch.Generator(device=self.device).manual_seed(
                ((self.stage_seed ^ 0x5EED) << 32) + epoch * 100003 + bi)
            batch = self.device_pipe.sample_batch(idxs, gen)
            if pending is not None:
                yield pending
            pending = batch
        if pending is not None:
            yield pending

    def _val(self, epoch: int, model, eval_fn, dir_stage: str):
        args = self.args
        score = RunningScore(args.n_classes)
        last = None
        batches = iter(self.loader_val)
        while True:
            with span("val.load"):
                batch = next(batches, None)
            if batch is None:
                break
            with span("val.upload"):
                # a bucket batch is already padded to a stride multiple, its
                # pad labels the ignore index, which the confusion matrix
                # drops
                feed = {k: v for k, v in batch.items()
                        if k not in ("index", "hw")}
                if distributed.world_size() > 1:
                    # a remainder pads to the full batch with ignore-labelled
                    # rows, so that it shards (driver.py:468-477)
                    feed, _ = pad_batch_to_devices(
                        feed, pad_label=args.ignore_index,
                        target_rows=self.loader_val.batch_size)
                shard = mesh.row_shard(feed["x"].shape[0])
                dev = batch_to_device(mesh.shard_batch(feed, shard),
                                      self.device)
            hist, _, vis = eval_fn(dev, shard=shard)
            score.merge(hist)
            last = (batch, vis)
            if args.debug:
                break
        with span("val.close"):
            self._close_val(epoch, model, score, last, dir_stage)

    def _close_val(self, epoch, model, score, last, dir_stage):
        args = self.args
        scores = score.get_scores()[0]
        miou, pixel_acc = scores["Mean IoU"], scores["Pixel Acc"]
        if miou > self.best_miou:
            save_checkpoint(f"{dir_stage}/best_miou_model.ckpt", model,
                            backend=getattr(args, "ckpt_backend", "msgpack"))
            print(f"best model saved (epoch {epoch} | prev miou "
                  f"{self.best_miou:.4f} => {miou:.4f})")
            self.best_miou = miou
        if distributed.is_primary():
            write_log(self.log_val, list_entities=[epoch, miou, pixel_acc])
        print(f"\n{'=' * 80}\nExperim name: {self.experim_name}\n"
              f"Epoch {epoch} | miou: {miou:.3f} | pixel_acc: {pixel_acc:.3f}\n"
              f"{'=' * 80}\n")
        if last is not None and not args.debug and distributed.is_primary():
            # image 0 of the batch is the primary's first row
            batch, vis = last
            render_vis_panels(self.vis, batch["x"][0], batch["y"][0], vis,
                              f"{dir_stage}/{epoch}_val.png")

    def _micro_bs(self) -> int:
        """--micro_batch_size (0: one update per batch), inert in the fully
        supervised mode; it must divide --batch_size, so that megabatches
        split at the reference's bs-micro boundaries (``driver.py:390-415``).
        On one device the remainder pads to a multiple of it
        (``_train_pad_multiple``, ``driver.py:416-437``)."""
        micro = int(getattr(self.args, "micro_batch_size", 0) or 0)
        if not micro or self.args.n_pixels_by_us == 0:
            return 0
        if self.args.batch_size % micro != 0:
            raise ValueError(
                f"--micro_batch_size {micro} must divide --batch_size "
                f"{self.args.batch_size}: the megabatch scan partitions "
                f"each batch into whole micro-updates (the reference bs-"
                f"{micro} schedule); a non-divisor would pad every batch "
                f"with duplicate rows and change the BN moments")
        return micro

    def _train_pad_multiple(self) -> int:
        """Remainder train batches pad to a multiple of lcm(world size,
        micro-batch size), the world size only when the full batches shard
        (``batch_size % W == 0``): padding every batch of a size W does not
        divide would change its BatchNorm moments (``driver.py:416-437``).
        An all-pad micro-batch this padding can make is a no-op."""
        w = distributed.world_size()
        n = w if self.args.batch_size % w == 0 else 1
        micro = self._micro_bs()
        return math.lcm(n, micro) if micro else n

    def _iters_per_epoch(self) -> int:
        """Optimizer updates per epoch, which the LR schedule steps by:
        ceil(rows / micro) per loader batch under micro-batching lands on
        the reference's bs-micro count (CamVid 367 at bs 48 / micro 4:
        7 x 12 + 8 = 92 = ceil(367 / 4); ``driver.py:207-217``)."""
        micro = self._micro_bs()
        if not micro:
            return len(self.loader)
        return sum(-(-len(ix) // micro)
                   for ix in self.loader.batch_index_plan(0))

    def _visualise(self, eval_fn, batch, fp: str) -> None:
        """6-panel PNG of image 0 of a train batch (model.py:150-158),
        computed by the eval step; sparse-label batches carry no dense
        target, dense ones show theirs. A device pipeline's image is
        normalised f32 on the device: it is brought back to uint8, as JAX's
        ``_image0`` does (``driver.py:532-538``)."""
        x0, y = batch["x"][:1], batch.get("y")
        if isinstance(x0, torch.Tensor):
            x0 = np.clip((x0.cpu().numpy() * np.asarray(self.args.std)
                          + np.asarray(self.args.mean)) * 255.0,
                         0, 255).astype(np.uint8)
        y0 = np.zeros(x0.shape[:3], np.int32) if y is None else y[:1]
        feed = {"x": torch.from_numpy(x0).to(self.device),
                "y": torch.from_numpy(y0.astype(np.int32)).to(self.device)}
        _, _, vis = eval_fn(feed)
        render_vis_panels(self.vis, x0[0], None if y is None else y[0], vis,
                          fp)


def pad_to_stride(batch: dict, stride: int):
    """Reflect-pad a batch's x, bottom and right, to a multiple of
    ``stride`` (VOC evaluation, reference ``model.py:185-191``;
    ``driver.py:569-577``). Returns (batch, the unpadded (h, w))."""
    x = batch["x"]
    h, w = x.shape[1:3]
    ph, pw = (stride - h % stride) % stride, (stride - w % stride) % stride
    if ph or pw:
        x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
    return {**batch, "x": x}, (h, w)
