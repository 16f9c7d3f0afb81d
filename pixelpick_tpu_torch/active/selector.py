"""QuerySelector — host orchestration of one acquisition round.

Counterpart of ``pixelpick_tpu/active/selector.py`` (reference
``query.py:12-221``): ``QuerySelector(args, loader, model, device)(nth_query,
human_labels)`` scores the pool batch by batch with
``acquisition.make_score_fn``, returns the encoded query dict and, in oracle
mode, dumps the round's stats and labels the pool dataset's masks. With
``--use_mc_dropout`` the MC-dropout committee scores (``mc_n_steps``
members, ``--vote_type``; ``selector.py:55-56``), its dropout masks drawn
from the round's generator. A bucketed pool (VOC) gives batches with
``index`` and ``hw``: rows with index -1 fill a bucket's last batch and are
skipped, and each image's picks are cropped back to its true size before
encoding (``selector.py:74-120``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pixelpick_tpu_torch.active import codec
from pixelpick_tpu_torch.active.acquisition import make_score_fn
from pixelpick_tpu_torch.active.stats import QueryStats


class QuerySelector:
    def __init__(self, args, loader, model, device):
        self.args = args
        self.loader = loader  # mode='query' Loader over the pool
        self.model = model
        self.device = torch.device(device)
        self.seed = args.seed
        self.mc_n_steps = args.mc_n_steps if args.use_mc_dropout else 0
        self._score_fn = make_score_fn(
            model,
            strategy=args.query_strategy,
            mean=args.mean, std=args.std,
            n_pixels=args.n_pixels_by_us,
            top_n_percent=args.top_n_percent,
            reverse_order=args.reverse_order,
            ignore_index=args.ignore_index,
            mc_n_steps=self.mc_n_steps,
            vote_type=args.vote_type,
        )

    def __call__(self, nth_query: int,
                 human_labels: bool = False) -> Dict[str, dict]:
        print(f"Choosing pixels by {self.args.query_strategy}")
        stats = QueryStats(self.args)
        dict_queries: Dict[str, dict] = {}
        generator = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + nth_query) & 0x7FFFFFFF)
        if self.mc_n_steps:
            # the committee's dropout masks draw from the round's stream too
            self.model.set_dropout_generator(generator)

        n_pixels_total = 0
        sample_idx = 0
        ds = self.loader.dataset
        # The remainder batch runs at its own size. The JAX selector pads it
        # to the full batch (pixelpick_tpu/active/selector.py:81-92) only to
        # avoid a second XLA compile; here nothing is compiled per shape,
        # and in eval mode every image is scored independently of the rest
        # of its batch.
        for batch in self.loader:
            dev_batch = {k: torch.from_numpy(batch[k]).to(self.device)
                         for k in ("x", "excluded", "y", "hw") if k in batch}
            indices, dev_stats = self._score_fn(dev_batch, generator)
            indices = indices.cpu().numpy()
            big_h, big_w = batch["x"].shape[1:3]
            index = batch.get("index", np.arange(
                sample_idx, sample_idx + indices.shape[0]))
            rows = [b for b in range(indices.shape[0]) if index[b] >= 0]
            for b in rows:
                q = np.zeros(big_h * big_w, bool)
                q[indices[b]] = True
                q = q.reshape(big_h, big_w)
                h, w = (int(v) for v in batch["hw"][b]) if "hw" in batch \
                    else (big_h, big_w)
                q = q[:h, :w]  # the bucket's padding cropped off
                n_pixels_total += int(q.sum())
                dict_queries.update(codec.encode_query(
                    ds.list_inputs[int(index[b])], (h, w), q))
            if not human_labels:
                stats.update_batch({k: v.cpu().numpy()[rows]
                                    for k, v in dev_stats.items()})
            sample_idx += len(rows)

        if not dict_queries:
            raise RuntimeError("no queries are chosen: the pool is empty")
        if not human_labels:
            stats.save(nth_query)
            print(f"{n_pixels_total} labelled pixels are chosen by "
                  f"{self.args.query_strategy} strategy")
            # keep the pool dataset's masks in sync (query.py:220); as in
            # the JAX selector, nth_query=None leaves the round's existing
            # queries.pkl alone — the caller dumps the picks at
            # {nth+1}_query/queries.pkl (model.py:84)
            ds.label_queries(dict_queries, None)
        return dict_queries
