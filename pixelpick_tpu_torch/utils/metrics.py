"""Segmentation metrics.

Counterpart of ``pixelpick_tpu/utils/metrics.py`` (reference
``utils/metrics.py:162-207``): pixels whose true label is outside
``[0, n_classes)`` are excluded, mIoU is the nanmean of per-class
``diag / (rowsum + colsum - diag)``. The per-step confusion matrix is
computed on the device and accumulated there; only the (n, n) matrix
crosses to the host, once, when scores are asked for.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(label_true: torch.Tensor, label_pred: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """Device-side (n, n) int64 confusion matrix. Invalid true labels (< 0
    or >= n_classes, e.g. the ignore index) go to an overflow bin that is
    dropped (``_fast_hist``). A bincount written as one ``index_add_``:
    ``torch.bincount`` reads the largest index back to the host, a sync per
    step."""
    lt = label_true.reshape(-1).long()
    lp = label_pred.reshape(-1).long()
    valid = (lt >= 0) & (lt < n_classes)
    idx = torch.where(valid, lt * n_classes + lp,
                      torch.full_like(lt, n_classes * n_classes))
    hist = torch.zeros(n_classes * n_classes + 1, dtype=torch.long,
                       device=lt.device)
    hist.index_add_(0, idx, torch.ones_like(idx))
    return hist[:-1].reshape(n_classes, n_classes)


def scores_from_confusion(hist: np.ndarray):
    """Host-side score finalisation (reference ``utils/metrics.py:179-204``)."""
    hist = np.asarray(hist, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        mean_iu = np.nanmean(iu)
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    cls_iu = dict(zip(range(hist.shape[0]), iu))
    return (
        {"Pixel Acc": acc, "Mean Acc": acc_cls, "FreqW Acc": fwavacc,
         "Mean IoU": mean_iu},
        cls_iu,
    )


class RunningScore:
    """Accumulating scorer: ``merge`` adds a device (or host) confusion
    matrix without a sync; ``get_scores`` fetches the sum once."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def merge(self, hist) -> None:
        if isinstance(hist, np.ndarray):
            self._host += hist
        else:
            self._device = hist if self._device is None else self._device + hist

    @property
    def confusion(self) -> np.ndarray:
        total = self._host
        if self._device is not None:
            total = total + self._device.cpu().numpy()
        return total

    def get_scores(self):
        return scores_from_confusion(self.confusion)

    def reset(self) -> None:
        self._host = np.zeros((self.n_classes, self.n_classes), np.float64)
        self._device = None


class AverageMeter:
    """Running average (reference ``utils/metrics.py:85-126``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val, weight=1):
        self.val = val
        self.sum += val * weight
        self.count += weight
        self.avg = self.sum / self.count
