"""Phase ``sweep``: whole ``active/selector.py:QuerySelector.__call__``
sweeps of the pool, each started before the deadline, the pool's images
decoded in set-up (as rounds after the first find them), the labelled
pixels of the rounds before (the benchmark's, drawn from the seed) put
back after each sweep. Every pick and its entropy of the last sweep is
kept for the comparison (``numbers``).
"""

from __future__ import annotations

import time

from pb import check
from pb.phase import LoaderProxy, Phase as Base

MASK_SALT = 0x1AB3
NTH_QUERY = 1  # a sweep of the round after the first


class Phase(Base):
    def setup(self) -> None:
        from pixelpick_tpu_torch.active.selector import QuerySelector

        self.build()
        self.labelled_masks(MASK_SALT)
        self.fill_cache(self.al.dataset_query)
        self.proxy = LoaderProxy(self.al.loader_query, self.spans)
        self.selector = QuerySelector(self.args, self.proxy, self.model,
                                      self.device)
        score = self.selector._score_fn
        self.images = 0
        self.batch_shapes = []
        self.kept = []

        def timed_score(batch, generator=None, uniforms=None):
            with self.spans.span("score"):
                idx, stats = score(batch, generator, uniforms)
            if self.fault == "altered":  # a planted fault, for the check
                idx = idx.clone()
                idx[:, 0] = (idx[:, 0] + 1) % idx.new_tensor(
                    batch["x"].shape[1] * batch["x"].shape[2])
            self.kept.append((idx, stats["entropy"]))
            self.batch_shapes.append(tuple(batch["x"].shape[:3]))
            self.images += batch["x"].shape[0]
            return idx, stats

        self.selector._score_fn = timed_score
        self.nth_query = NTH_QUERY
        self.one_sweep()  # every batch shape of the pool, warm

    def one_sweep(self) -> None:
        self.kept = []
        self.selector(self.nth_query)
        # the next sweep is of the same round: the picks just labelled go
        self.al.dataset.queries = self.al.dataset_query.queries = \
            list(self.masks)

    def run_window(self) -> None:
        images0, shapes0 = self.images, len(self.batch_shapes)
        t0 = self.open_window()
        sweeps = 0
        while time.perf_counter() < t0 + self.seconds:
            self.one_sweep()
            sweeps += 1
        self.window = {"seconds": time.perf_counter() - t0,
                       "images": self.images - images0, "sweeps": sweeps,
                       "batches": len(self.batch_shapes) - shapes0}

    def progress(self) -> int:
        return len(self.batch_shapes)

    def traced_work(self) -> None:
        """One more whole sweep, whose picks are not compared."""
        kept = self.kept
        self.one_sweep()
        self.kept = kept

    def numbers(self, prec: str = "f32"):
        return check.sweep_numbers(self, prec)
