"""Train and eval steps.

Counterpart of ``pixelpick_tpu/engine/trainer.py``:

- :func:`sparse_ce_and_hist`: cross-entropy and confusion matrix at the
  labelled pixels only. The head's logits stay at 1/4 resolution and their
  align-corners interpolation is evaluated at the labelled coordinates
  (``ops/resize.py``), which by linearity equals the reference's
  upsample-then-masked-CE (``model.py:108-116``);
- :func:`make_train_step`: forward in train mode (``upsample=False``), loss,
  backward, optimizer update (``make_train_step``/``_jit_step``,
  ``trainer.py:125-133, 210-226``). The loss and the confusion matrix stay on
  the device; nothing syncs the host per step;
- :func:`make_microbatch_train_step`: sequential bs-M updates over one
  megabatch uploaded once (``trainer.py:136-227``), the reference's bs-M
  schedule at a larger loader batch;
- :func:`make_dense_train_step`: the fully supervised step, cross-entropy
  over the full-resolution label map (``trainer.py:229-255``);
- :func:`make_eval_step`: full-resolution argmax and confusion matrix, and
  one image's visualisation maps (``trainer.py:256-293``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import torch

from pixelpick_tpu_torch.ops.resize import (
    gather_bilinear_align_corners, gather_bilinear_matmul,
    resize_align_corners,
)
from pixelpick_tpu_torch.ops.uncertainty import vis_maps
from pixelpick_tpu_torch.utils.metrics import confusion_matrix

# the batch keys the sparse train step reads
SPARSE_KEYS = ("x", "coords", "labels", "valid")


@lru_cache(maxsize=None)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A small f32 tensor on ``device``, uploaded once: a blocking upload
    waits for the device, a stall per step. Callers must not write to it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize_images(x_uint8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> normalised f32 (torchvision to_tensor + Normalize)."""
    mean = _constant(tuple(float(v) for v in mean), x_uint8.device)
    std = _constant(tuple(float(v) for v in std), x_uint8.device)
    return (x_uint8.float() / 255.0 - mean) / std


def sparse_ce_and_hist(logits_lr, coords, labels, valid, full_hw,
                       n_classes: int, gather_impl: str = "matmul"):
    """Cross-entropy and (n, n) confusion matrix at sparse coordinates.

    logits_lr: (B, h, w, C) low-resolution logits; coords (B, K, 2) int
    full-resolution (y, x), padding arbitrary; labels (B, K); valid (B, K)
    bool, False on padding and on void-labelled picks (CE ``ignore_index``).
    gather_impl: 'matmul' (one-hot selection products) or 'gather'."""
    if tuple(logits_lr.shape[1:3]) == tuple(full_hw):
        bsz, _, w_full, c = logits_lr.shape
        idx = (coords[..., 0] * w_full + coords[..., 1]).long()
        logits = torch.gather(logits_lr.reshape(bsz, -1, c), 1,
                              idx[..., None].expand(-1, -1, c))
    else:
        gather = gather_bilinear_matmul if gather_impl == "matmul" \
            else gather_bilinear_align_corners
        logits = gather(logits_lr, coords, full_hw)
    logits = logits.float()
    logp = torch.log_softmax(logits, -1)
    safe = labels.long().clamp(0, n_classes - 1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    validf = valid.float()
    n_valid = validf.sum().clamp(min=1)
    loss = -(ll * validf).sum() / n_valid
    hist = confusion_matrix(torch.where(valid, labels.long(),
                                        torch.full_like(labels.long(), -1)),
                            logits.argmax(-1), n_classes)
    return loss, hist


def batch_to_device(batch: dict, device) -> dict:
    """Host NumPy batch -> device tensors (uint8 images stay uint8)."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(model, optimizer, *, n_classes: int, mean, std,
                    normalize: bool = True,
                    gather_impl: str = "matmul") -> Callable:
    """Sparse-label train step. batch (device tensors): x uint8 (B, H, W, 3),
    or with ``normalize=False`` the normalised f32 of the device pipeline
    (``data/device_pipeline.py``; ``trainer.py:125-133``), coords (B, K, 2),
    labels (B, K), valid (B, K). Returns (loss, hist), both on the
    device."""

    def train_step(batch):
        model.train()
        x = normalize_images(batch["x"], mean, std) if normalize \
            else batch["x"]
        out = model(x, upsample=False)
        loss, hist = sparse_ce_and_hist(
            out["pred"], batch["coords"], batch["labels"], batch["valid"],
            batch["x"].shape[1:3], n_classes, gather_impl=gather_impl)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach(), hist

    return train_step


def make_microbatch_train_step(model, optimizer, *, micro_bs: int,
                               n_classes: int, mean, std,
                               normalize: bool = True,
                               gather_impl: str = "matmul") -> Callable:
    """Megabatch step: ``B // micro_bs`` sequential bs-``micro_bs`` updates,
    each :func:`make_train_step`'s body on rows ``[m*M, (m+1)*M)``.

    ``train_step(batch)`` takes the HOST batch (NumPy, the sparse keys of
    :func:`make_train_step`, B a multiple of ``micro_bs``; the driver pads a
    remainder with ``parallel/mesh.py:pad_batch_to_devices``), uploads it
    once and returns ``(losses (n_micro,), hist summed)`` on the device. A
    device pipeline's batch (``data/device_pipeline.py:sample_batch``,
    already on the device, padded there, with ``normalize=False``) is used
    as it is.

    As the JAX scan: the same update count, sample order, per-update
    BatchNorm moments, optimizer and schedule stepping and dropout draws
    (from the model's generator, once per update, in update order) as
    ``n_micro`` separate bs-``micro_bs`` steps. Pad rows join the final
    micro-batch's BatchNorm moments (``trainer.py:155-158``). A
    micro-batch with no valid entry is a true no-op: no forward (the
    running statistics stay), no optimizer step (its count, the schedule
    and the moments stay), and NaN in its loss slot, which the driver's
    epoch mean skips. That is decided from the host copy of ``valid``, so
    nothing syncs the device per micro-batch. A device batch has no host
    copy of ``valid``: its ``rows_real`` (which rows hold a valid pick) is
    copied to the host as the batch is drawn and read once per megabatch;
    a real micro-batch whose crops kept no labelled pixel is a no-op too,
    as JAX's scan makes it (``trainer.py:197-201``)."""
    step = make_train_step(model, optimizer, n_classes=n_classes, mean=mean,
                           std=std, normalize=normalize,
                           gather_impl=gather_impl)

    def train_step(batch):
        b = batch["x"].shape[0]
        if b % micro_bs:
            raise ValueError(f"a megabatch of {b} rows is not a multiple of "
                             f"the micro-batch size {micro_bs}")
        device = next(model.parameters()).device
        if "rows_real" in batch:
            rows = batch["rows_real"].get()
            dev = {k: batch[k] for k in SPARSE_KEYS}
        else:
            rows = batch["valid"].any(1)
            dev = batch_to_device(batch, device)
        any_real = rows.reshape(b // micro_bs, -1).any(1)
        losses = []
        hist = torch.zeros((n_classes, n_classes), dtype=torch.long,
                           device=device)
        for m, real in enumerate(any_real):
            if not real:
                losses.append(torch.full((), float("nan"), device=device))
                continue
            rows = slice(m * micro_bs, (m + 1) * micro_bs)
            loss, h = step({k: v[rows] for k, v in dev.items()})
            losses.append(loss)
            hist = hist + h
        return torch.stack(losses), hist

    return train_step


def make_dense_train_step(model, optimizer, *, n_classes: int,
                          ignore_index: int, mean, std) -> Callable:
    """Fully supervised train step (``n_pixels_by_us == 0``; reference
    ``model.py:108-126``): batch keys x uint8 (B, H, W, 3) and y int
    (B, H, W). The train-mode logits, in f32, resized align-corners to the
    full resolution; the mean log-softmax cross-entropy over the pixels
    with ``y != ignore_index`` and ``0 <= y < n_classes``, divided by
    max(their count, 1); the full-resolution confusion matrix; then the
    optimizer update. JAX calls the model with ``upsample=True``, which
    also resizes the embedding the loss never reads; here ``pred`` alone
    is resized, so loss and gradients are the same. Returns (loss, hist) on
    the device."""

    def train_step(batch):
        model.train()
        x = normalize_images(batch["x"], mean, std)
        logits = model(x, upsample=False)["pred"].float()
        if logits.shape[1:3] != x.shape[1:3]:
            logits = resize_align_corners(logits, x.shape[1:3])
        y = batch["y"].long()
        valid = (y != ignore_index) & (y >= 0) & (y < n_classes)
        logp = torch.log_softmax(logits, -1)
        ll = torch.gather(logp, -1, y.clamp(0, n_classes - 1)[..., None])
        validf = valid.float()
        loss = -(ll[..., 0] * validf).sum() / validf.sum().clamp(min=1)
        hist = confusion_matrix(torch.where(valid, y, torch.full_like(y, -1)),
                                logits.argmax(-1), n_classes)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach(), hist

    return train_step


def make_eval_step(model, *, n_classes: int, mean, std) -> Callable:
    """Validation step: full-resolution argmax and device confusion matrix.
    Returns (hist, pred, vis) with ``vis`` the visualisation maps of image
    ``vis_index``, all on the device. ``valid_hw`` crops the logits to the
    unpadded size of an x padded to a stride multiple (``trainer.py:
    256-293``; ``active/driver.py:pad_to_stride``)."""

    @torch.no_grad()
    def eval_step(batch, vis_index: int = 0, valid_hw=None):
        model.eval()
        x = normalize_images(batch["x"], mean, std)
        logits = model(x, upsample=False)["pred"].float()
        if logits.shape[1:3] != x.shape[1:3]:
            logits = resize_align_corners(logits, x.shape[1:3])
        if valid_hw is not None:
            logits = logits[:, :valid_hw[0], :valid_hw[1]]
        pred = logits.argmax(-1)
        hist = confusion_matrix(batch["y"], pred, n_classes)
        return hist, pred, vis_maps(logits[vis_index:vis_index + 1])

    return eval_step
