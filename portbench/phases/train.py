"""Phase ``train``: epochs of ``active/driver.py:ALModel._train_epoch``,
with the step of ``engine/trainer.py:make_train_step`` and the port's host
loader (no device augmentation, no micro-batching: those flags are
refused). The labelled pixels are the benchmark's, drawn from the seed.

Set-up drives the step through three updates and a remainder batch, by the
window's own call and feed, to warm every shape; then puts the same model,
optimizer and dropout stream back at the seeded start, in place. The
window runs epochs until the loader proxy stops giving batches at the
deadline and the port's loop closes the epoch; its first three updates are
kept for the comparison (``numbers``), and it runs at least those three.
"""

from __future__ import annotations

import time

import torch

from pb import check
from pb.phase import LoaderProxy, Phase as Base

DROPOUT_SALT = 0x5EED
MASK_SALT = 0x7A11
COMPARED = 3  # the window's first updates, followed by the reference


class Phase(Base):
    def setup(self) -> None:
        from pixelpick_tpu_torch.engine.optim import make_optimizer
        from pixelpick_tpu_torch.engine.trainer import make_train_step

        self.build()
        self.labelled_masks(MASK_SALT)
        al, args = self.al, self.args
        self.optimizer = make_optimizer(args, self.model,
                                        al._iters_per_epoch())
        step = make_train_step(self.model, self.optimizer,
                               n_classes=args.n_classes, mean=args.mean,
                               std=args.std)
        self.dropout_seed = (self.seed ^ DROPOUT_SALT) & ((1 << 63) - 1)
        self.dropout = torch.Generator(device=self.device)
        self.model.set_dropout_generator(self.dropout)
        self.names = {id(p): n for n, p in self.model.named_parameters()}
        self.proxy = LoaderProxy(al.loader, self.spans)
        al.loader = self.proxy
        self.n_updates = 0
        self.images = 0
        self.batch_rows = []
        self.capture_from = None
        self.captured = {"batches": [], "plans": [], "losses": []}

        def timed_step(batch, shard=None):
            # planted faults, for the check: a label altered where the data
            # stage makes it; half the batch left out of the step
            if self.fault == "mislabelled":
                batch = dict(batch, labels=(batch["labels"] + 1)
                             % args.n_classes)
            fed = batch
            if self.fault == "half_batch":
                half = batch["x"].shape[0] // 2
                fed = {k: v[:half] for k, v in batch.items()}
            with self.spans.span("step"):
                if self.fault == "unchanged":
                    with torch.no_grad():
                        keep = [p.clone() for p in self.model.parameters()]
                    loss, hist = step(fed, shard)
                    with torch.no_grad():
                        for p, k in zip(self.model.parameters(), keep):
                            p.copy_(k)
                else:
                    loss, hist = step(fed, shard)
            self.n_updates += 1
            self.images += batch["x"].shape[0]
            self.batch_rows.append(batch["x"].shape[0])
            if self.capture_from is not None \
                    and self.n_updates - self.capture_from <= COMPARED:
                self.capture(batch, loss)
            return loss, hist

        self.timed_step = timed_step
        self.reset()
        self.proxy.limit = COMPARED
        al._train_epoch(1, timed_step)
        # a remainder batch is a shape of its own: warm it
        plan = al.loader.batch_index_plan(1)
        if len(plan[-1]) != len(plan[0]):
            self.proxy.feed = [al.loader._make_batch(plan[-1])]
            al._train_epoch(1, timed_step)
            self.proxy.feed = None
        self.proxy.limit = None
        self.reset()

    def reset(self) -> None:
        """The model, the optimizer (moments, update count, so the
        schedule) and the dropout stream at the seeded start, in place."""
        self.model.load_state_dict(self.weights)
        for st in self.optimizer.state:
            for ts in st.values():
                torch._foreach_zero_(ts)
        self.optimizer.step_count = 0
        self.dropout.manual_seed(self.dropout_seed)

    def capture(self, batch, loss) -> None:
        c, k = self.captured, self.n_updates - self.capture_from
        c["batches"].append({n: v.clone() for n, v in batch.items()})
        c["plans"].append(self.proxy.last_plan)
        c["losses"].append(loss.detach().clone())
        if k == 1:
            # the first gradient as the optimizer got it: Adam's first moment
            # is (1 - beta1) g, SGD's trace is g (weight decay included)
            grads = {}
            for (cfg, params), st in zip(self.optimizer.groups,
                                         self.optimizer.state):
                key = "mu" if cfg["opt"] == "adam" else "trace"
                scale = 1.0 / (1 - cfg["betas"][0]) if key == "mu" else 1.0
                for p, m in zip(params, st[key]):
                    grads[self.names[id(p)]] = (m * scale).detach().clone()
            c["first_grad"] = grads
        if k == COMPARED:
            c["params"] = {n: p.detach().clone()
                           for n, p in self.model.named_parameters()}

    def run_window(self) -> None:
        al = self.al
        epoch, images0, updates0 = 2, self.images, self.n_updates
        t0 = self.open_window()
        self.capture_from = self.n_updates
        self.proxy.at_least = self.proxy.given + COMPARED
        self.proxy.deadline = t0 + self.seconds
        while time.perf_counter() < self.proxy.deadline \
                or self.n_updates - updates0 < COMPARED:
            al._train_epoch(epoch, self.timed_step)
            epoch += 1
        self.window = {"seconds": time.perf_counter() - t0,
                       "images": self.images - images0,
                       "updates": self.n_updates - updates0,
                       "epochs": epoch - 2}
        self.next_epoch = epoch

    def progress(self) -> int:
        return self.n_updates

    def traced_work(self) -> None:
        """``trace_seconds`` more of updates, in the next epoch."""
        self.proxy.deadline = time.perf_counter() \
            + self.traffic["trace_seconds"]
        self.al._train_epoch(self.next_epoch, self.timed_step)

    def numbers(self, prec: str = "f32"):
        return check.train_numbers(self, prec)
