"""Acquisition analytics (reference ``query.py:250-308 QueryStats``):
label distribution of picked pixels, mean entropy at picks, unique labels
per image, mean pairwise spatial distance — pickled per round to
``{nth}_query/query_stats.pkl``. The per-pixel quantities are computed on
the device by the scoring function (``active/acquisition.py``); this class
only aggregates the small per-image arrays."""

from __future__ import annotations

import os
import pickle as pkl
from typing import List

import numpy as np


class QueryStats:
    def __init__(self, args):
        self.dir_checkpoints = args.dir_checkpoints
        self.n_classes = args.n_classes
        self.list_entropy: List[float] = []
        self.list_n_unique_labels: List[int] = []
        self.list_spatial_coverage: List[float] = []
        self.dict_label_cnt = {l: 0 for l in range(args.n_classes)}

    def update_batch(self, stats: dict) -> None:
        """stats: {'entropy': (B,K), 'labels': (B,K), 'coverage': (B,),
        'picked_valid': (B,K)} numpy arrays from
        ``acquisition.make_score_fn``. ``picked_valid`` masks picks that
        spilled into excluded/void pixels (images with fewer than K
        candidates) out of every aggregate."""
        ent = np.asarray(stats["entropy"])
        labels = np.asarray(stats["labels"])
        cov = np.asarray(stats["coverage"])
        ok = np.asarray(stats.get("picked_valid",
                                  np.ones(ent.shape, bool)))
        for b in range(ent.shape[0]):
            self.list_entropy.extend(ent[b][ok[b]].tolist())
            good = labels[b][ok[b]].tolist()
            self.list_n_unique_labels.append(len(set(good)))
            self.list_spatial_coverage.append(float(cov[b]))
            for l in good:
                if l in self.dict_label_cnt:
                    self.dict_label_cnt[l] += 1

    def save(self, nth_query: int) -> dict:
        cov = self.list_spatial_coverage
        dict_stats = {
            "label_distribution": self.dict_label_cnt,
            "avg_entropy": float(np.mean(self.list_entropy)) if self.list_entropy else float("nan"),
            "avg_n_unique_labels": float(np.mean(self.list_n_unique_labels)) if self.list_n_unique_labels else float("nan"),
            # per-image coverage is NaN below 2 valid picks, exactly as the
            # reference's _spatial_coverage (query.py:269-279); nanmean
            # (deliberate deviation from the reference's np.mean, which one
            # sparse image poisons to NaN) still averages the others
            "avg_spatial_coverage": float(np.nanmean(cov)) if cov and not np.all(np.isnan(cov)) else float("nan"),
        }
        for k, v in dict_stats.items():
            print(f"{k}: {v}")
        d = f"{self.dir_checkpoints}/{nth_query}_query"
        os.makedirs(d, exist_ok=True)
        with open(f"{d}/query_stats.pkl", "wb") as f:
            pkl.dump(dict_stats, f)
        return dict_stats
