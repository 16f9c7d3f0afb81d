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
its end. Not ported yet (``config.check_supported`` refuses them): the
fully supervised mode, ``--micro_batch_size``, stage snapshots and
``--resume_campaign``, ``--device_augment``, human labels, and meshes.
"""

from __future__ import annotations

import os
import time

import torch

from pixelpick_tpu_torch.active.selector import QuerySelector
from pixelpick_tpu_torch.data.factory import get_dataset
from pixelpick_tpu_torch.data.loader import Loader
from pixelpick_tpu_torch.engine.checkpoint import save_checkpoint
from pixelpick_tpu_torch.engine.optim import make_optimizer
from pixelpick_tpu_torch.engine.trainer import (
    batch_to_device, make_eval_step, make_train_step,
)
from pixelpick_tpu_torch.models.factory import get_model, resolve_device
from pixelpick_tpu_torch.utils.logging import write_log
from pixelpick_tpu_torch.utils.metrics import AverageMeter, RunningScore
from pixelpick_tpu_torch.utils.profiling import PhaseTimer, trace
from pixelpick_tpu_torch.utils.visualiser import Visualiser, render_vis_panels


def round_seed(seed: int, nth_query: int) -> int:
    return (seed * 7919 + nth_query + 1) & 0x7FFFFFFF


class ALModel:
    def __init__(self, args):
        self.args = args
        self.device = resolve_device(args.device)
        self.dir_checkpoints = args.dir_checkpoints
        self.experim_name = args.experim_name
        self.best_miou = -1.0
        self.nth_query = -1

        self.dataset = get_dataset(args, val=False, query=False)
        self.dataset_query = get_dataset(args, val=False, query=True,
                                         generate_init_queries=False)
        self.dataset_query.queries = self.dataset.queries
        self.dataset_query.n_pixels_total = self.dataset.n_pixels_total
        self.dataset_val = get_dataset(args, val=True, query=False)

        self.loader = Loader(self.dataset, args.batch_size, mode="train",
                             shuffle=True, n_workers=args.n_workers,
                             seed=args.seed)
        self.loader_query = Loader(self.dataset_query, args.pool_batch_size,
                                   mode="query", n_workers=args.n_workers)
        self.loader_val = Loader(self.dataset_val,
                                 getattr(args, "val_batch_size", 1),
                                 mode="val", n_workers=args.n_workers)
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
        n_stages = args.max_budget // args.n_pixels_by_us
        n_stages += 1 if args.n_init_pixels > 0 else 0
        print("n_stages:", n_stages)
        profile_dir = getattr(args, "profile_dir", "")
        for nth_query in range(n_stages):
            self.nth_query = nth_query
            model = self._run_stage(f"{nth_query}_query")
            selector = QuerySelector(args, self.loader_query, model,
                                     self.device)
            with trace(f"{profile_dir}/query" if profile_dir
                       and nth_query == 0 else None):
                queries = selector(nth_query)
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
        write_log(self.log_train, header=["epoch", "mIoU", "pixel_acc", "loss"])
        write_log(self.log_val, header=["epoch", "mIoU", "pixel_acc"])

        # a fresh model per round (model.py:163)
        seed = round_seed(args.seed, self.nth_query)
        model = get_model(args, self.device, seed=seed)
        model.set_dropout_generator(
            torch.Generator(device=self.device).manual_seed(seed ^ 0x5EED))
        self.model = model
        optimizer = make_optimizer(args, model, len(self.loader))
        step_fn = make_train_step(model, optimizer, n_classes=args.n_classes,
                                  mean=args.mean, std=args.std)
        eval_fn = make_eval_step(model, n_classes=args.n_classes,
                                 mean=args.mean, std=args.std)

        self.best_miou = -1.0
        self.timer = PhaseTimer()
        eval_interval = max(1, getattr(args, "eval_interval", 1))
        profile_dir = getattr(args, "profile_dir", "")
        trace_epoch = min(2, args.n_epochs) if profile_dir \
            and self.nth_query <= 0 else -1
        for epoch in range(1, 1 + args.n_epochs):
            with self.timer.phase("train", len(self.dataset)), \
                    trace(f"{profile_dir}/train" if epoch == trace_epoch
                          else None):
                last_batch = self._train_epoch(epoch, step_fn)
            if last_batch is not None and not args.debug:
                with self.timer.phase("vis"):
                    self._visualise(eval_fn, last_batch,
                                    f"{dir_stage}/{epoch}_train.png")
            if epoch % eval_interval == 0 or epoch == args.n_epochs:
                with self.timer.phase("val", len(self.dataset_val)):
                    self._val(epoch, model, eval_fn, dir_stage)
            if args.debug:
                break
        self.timer.dump(f"{dir_stage}/timing.json")
        return model

    # ----------------------------- epochs -----------------------------

    def _train_epoch(self, epoch: int, step_fn):
        args = self.args
        print(f"training epoch {epoch} of {self.nth_query}th query "
              f"({self.dataset.n_pixels_total} labelled pixels)")
        self.loader.set_epoch(epoch)
        score = RunningScore(args.n_classes)
        self.running_loss.reset()
        t0 = time.time()
        n_imgs = 0
        losses = []
        last_batch = None
        for batch in self.loader:
            loss, hist = step_fn(batch_to_device(batch, self.device))
            losses.append(loss)
            score.merge(hist)
            n_imgs += batch["x"].shape[0]
            last_batch = batch
            if args.debug:
                break
        # the epoch-mean loss, read from the device once (model.py:126,147)
        if losses:
            for v in torch.stack(losses).cpu().numpy():
                self.running_loss.update(float(v))
        scores = score.get_scores()[0]
        miou, pixel_acc = scores["Mean IoU"], scores["Pixel Acc"]
        dt = time.time() - t0
        print(f"({self.experim_name}) Epoch {epoch} | mIoU: {miou:.3f} | "
              f"pixel acc: {pixel_acc:.3f} | loss: {self.running_loss.avg:.3f} "
              f"| {n_imgs / max(dt, 1e-9):.1f} imgs/s")
        write_log(self.log_train, list_entities=[
            epoch, miou, pixel_acc, self.running_loss.avg])
        return last_batch

    def _val(self, epoch: int, model, eval_fn, dir_stage: str):
        args = self.args
        score = RunningScore(args.n_classes)
        last = None
        for batch in self.loader_val:
            hist, _, vis = eval_fn(batch_to_device(batch, self.device))
            score.merge(hist)
            last = (batch, vis)
            if args.debug:
                break
        scores = score.get_scores()[0]
        miou, pixel_acc = scores["Mean IoU"], scores["Pixel Acc"]
        if miou > self.best_miou:
            save_checkpoint(f"{dir_stage}/best_miou_model.ckpt", model)
            print(f"best model saved (epoch {epoch} | prev miou "
                  f"{self.best_miou:.4f} => {miou:.4f})")
            self.best_miou = miou
        write_log(self.log_val, list_entities=[epoch, miou, pixel_acc])
        print(f"\n{'=' * 80}\nExperim name: {self.experim_name}\n"
              f"Epoch {epoch} | miou: {miou:.3f} | pixel_acc: {pixel_acc:.3f}\n"
              f"{'=' * 80}\n")
        if last is not None and not args.debug:
            batch, vis = last
            render_vis_panels(self.vis, batch["x"][0], batch["y"][0], vis,
                              f"{dir_stage}/{epoch}_val.png")

    def _visualise(self, eval_fn, batch, fp: str) -> None:
        """6-panel PNG of image 0 of a train batch (model.py:150-158),
        computed by the eval step; train batches carry no dense target."""
        x0 = batch["x"][:1]
        feed = {"x": torch.from_numpy(x0).to(self.device),
                "y": torch.zeros(x0.shape[:3], dtype=torch.int32,
                                 device=self.device)}
        _, _, vis = eval_fn(feed)
        render_vis_panels(self.vis, x0[0], None, vis, fp)
