"""Phase ``val``: whole passes of ``active/driver.py:ALModel._val`` over
the validation split at the configuration's validation batch, each
started before the deadline, with the eval step of
``engine/trainer.py:make_eval_step``; a CUDA event recorded after each step
(no sync) times each image. The weights stay fixed, so after set-up's pass
(which decodes every image into the port's RAM cache and saves the best
model) no pass saves one. A sample of the last pass's images, drawn from
the seed, is kept for the comparison (``numbers``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pb import check
from pb.phase import LoaderProxy, Phase as Base

SAMPLE = 24  # validation images compared with the reference per run


class Phase(Base):
    def setup(self) -> None:
        from pixelpick_tpu_torch.engine.trainer import make_eval_step

        self.build()
        al, args = self.al, self.args
        eval_fn = make_eval_step(self.model, n_classes=args.n_classes,
                                 mean=args.mean, std=args.std)
        n = len(al.dataset_val)
        rng = np.random.RandomState(self.seed % (2 ** 32))
        self.sample = sorted(rng.choice(n, min(SAMPLE, n),
                                        replace=False).tolist())
        self.in_pass = 0
        self.images = 0
        self.events = []
        self.t_window0 = None
        self.kept = {}

        def timed_eval(batch, vis_index=0, valid_hw=None, shard=None):
            with self.spans.span("eval_step"):
                hist, pred, vis = eval_fn(batch, vis_index, valid_hw, shard)
            if self.t_window0 is not None:
                self.events.append(self.mark())
            i = self.in_pass
            if i in self.sample:
                if self.fault == "altered":  # a planted fault, for the check
                    pred = pred.clone()
                    pred.view(-1)[0] = (pred.view(-1)[0] + 1) \
                        % args.n_classes
                self.kept[i] = (pred, hist)
            self.in_pass += 1
            self.images += batch["x"].shape[0]
            return hist, pred, vis

        self.timed_eval = timed_eval
        self.proxy = LoaderProxy(al.loader_val, self.spans)
        al.loader_val = self.proxy
        self.one_pass(0)

    def mark(self):
        """A CUDA event recorded now (no sync), or on the CPU the clock."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def one_pass(self, epoch: int) -> None:
        self.in_pass = 0
        self.al._val(epoch, self.model, self.timed_eval,
                     str(self.workdir / "run"))

    def run_window(self) -> None:
        images0 = self.images
        t0 = self.open_window()
        start = self.mark()
        self.t_window0 = t0
        epoch = 1
        while time.perf_counter() < t0 + self.seconds:
            self.one_pass(epoch)
            epoch += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_image = []
        prev = start
        for ev in self.events:
            per_image.append(prev.elapsed_time(ev) if self.device.type
                             == "cuda" else (ev - prev) * 1e3)
            prev = ev
        self.window = {"seconds": wall, "images": self.images - images0,
                       "passes": epoch - 1, "image_ms": per_image}
        self.t_window0 = None  # no per-image events after the window
        self.next_epoch = epoch
        self.kept = dict(self.kept)  # the window's last pass, compared

    def progress(self) -> int:
        return self.images

    def traced_work(self) -> None:
        """One more whole pass, whose answers are not compared."""
        kept = self.kept
        self.one_pass(self.next_epoch)
        self.kept = kept

    def numbers(self, prec: str = "f32"):
        return check.val_numbers(self, prec)
