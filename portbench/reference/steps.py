"""The reference's training steps, evaluation and margin-sampling pick.

- :func:`train_steps`: sparse-label updates as the original PixelPick
  repository computes them (``model.py:108-126``): the logits upsampled to
  the full resolution with aligned corners, the cross-entropy at the
  labelled pixels (void picks ignored, the mean over the valid ones), the
  backward, and ``torch.optim.Adam`` or ``SGD`` with coupled L2 weight
  decay, two parameter groups (the backbone at its own rate) and the
  schedule the configuration states (MultiStep or Poly 0.9);
- :func:`eval_logits`: evaluation-mode logits at the full resolution;
- :func:`margin_picks`: the margin-sampling pick of ``query.py:33-69``: the
  ``top_n_percent`` of pixels with the smallest gap between the two most
  likely classes, labelled and void pixels excluded, then the
  ``n_pixels`` of those with the largest uniform draws;
- :func:`calibrated_running_stats`: every BatchNorm's running statistics set
  to its batch moments on given images, so that an evaluation-mode forward
  of random weights keeps its activations at the scale training gives them.

``precision`` is ``"f32"`` (TF32 off in cuDNN and matmul), ``"tf32"``
(on): the lower precision that the benchmark's control computes in, or
``"f64"``: the weights and images in float64, to tell a leaf whose f32
gradient is rounding from one whose gradient is not.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from reference import nets


@contextlib.contextmanager
def precision(name: str):
    """TF32 on (``"tf32"``) or off (``"f32"``) in cuDNN and matmul for the
    block, restored afterwards."""
    if name not in ("f32", "tf32", "f64"):
        raise ValueError(name)
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    on = name == "tf32"
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def normalise(x_uint8: torch.Tensor, cfg, prec: str = "f32") -> torch.Tensor:
    """uint8 NHWC -> normalised NCHW, f32 (f64 for ``"f64"``)."""
    mean = torch.tensor(cfg["mean"], device=x_uint8.device)
    std = torch.tensor(cfg["std"], device=x_uint8.device)
    x = ((x_uint8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    return x.double() if prec == "f64" else x


def in_precision(weights: Dict[str, torch.Tensor], prec: str):
    """The weight dict, its floating tensors in float64 for ``"f64"``."""
    if prec != "f64":
        return weights
    return {n: t.double() if t.is_floating_point() else t
            for n, t in weights.items()}


def _param_names(cfg) -> List[str]:
    return [n for n, (_, kind) in nets.spec_of(cfg).items()
            if not kind.startswith(("bn_mean", "bn_var", "bn_count"))]


def lr_factor(cfg, step: int) -> float:
    """The schedule's factor at update ``step`` (from 0): Poly
    ``(1 - step / N) ** 0.9`` over ``N = n_epochs * updates per epoch``;
    MultiStep drops by 10 at epochs 22 and 42 (the reference passes
    ``epoch - 1`` to a scheduler with milestones 20 and 40)."""
    opt = cfg["optimizer"]
    per_epoch = math.ceil(cfg["n_train"] / cfg["batch_size"])
    if opt["schedule"] == "poly":
        total = cfg["n_epochs"] * per_epoch
        return (1.0 - min(step, total) / total) ** 0.9
    epoch = step // per_epoch + 1
    return 0.1 ** sum(epoch >= m + 2 for m in (20, 40))


def train_steps(weights: Dict[str, torch.Tensor], batches: List[dict], cfg,
                dropout_seed: int, prec: str = "f32") -> dict:
    """Follow ``len(batches)`` updates from ``weights``. Each batch holds
    x uint8 (B, H, W, 3), coords (B, K, 2) as (row, column), labels (B, K)
    and valid (B, K), on the device. Returns the losses, every parameter's
    first gradient as the optimizer receives it (weight decay included),
    and every parameter after the last update."""
    dev = batches[0]["x"].device
    names = _param_names(cfg)
    weights = in_precision(weights, prec)
    params = {n: weights[n].detach().clone().requires_grad_(True)
              for n in names}
    bufs = {n: t for n, t in weights.items() if n not in params}
    opt_cfg = cfg["optimizer"]
    backbone = tuple(opt_cfg["backbone_prefixes"])
    groups = [
        {"params": [params[n] for n in names if n.startswith(backbone)],
         "lr": opt_cfg["backbone_lr"]},
        {"params": [params[n] for n in names if not n.startswith(backbone)],
         "lr": opt_cfg["lr"]}]
    for g in groups:
        g["base_lr"] = g["lr"]
    if opt_cfg["type"] == "adam":
        opt = torch.optim.Adam(groups, betas=tuple(opt_cfg["betas"]),
                               eps=opt_cfg["eps"],
                               weight_decay=opt_cfg["weight_decay"],
                               foreach=False)
    else:
        opt = torch.optim.SGD(groups, momentum=opt_cfg["momentum"],
                              weight_decay=opt_cfg["weight_decay"],
                              foreach=False)
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    losses, first_grad = [], None
    with precision(prec):
        for step, b in enumerate(batches):
            for g in opt.param_groups:
                g["lr"] = g["base_lr"] * lr_factor(cfg, step)
            c = nets.Ctx({**bufs, **params}, train=True, generator=gen)
            x = normalise(b["x"], cfg, prec)
            logits = nets.full_res_logits(c, x, cfg)
            bsz = logits.shape[0]
            ys, xs = b["coords"][..., 0].long(), b["coords"][..., 1].long()
            rows = torch.arange(bsz, device=dev)[:, None].expand_as(ys)
            picked = logits.permute(0, 2, 3, 1)[rows, ys, xs]  # (B, K, C)
            logp = F.log_softmax(picked, -1)
            lab = b["labels"].long().clamp(0, cfg["n_classes"] - 1)
            nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
            valid = b["valid"].float()
            loss = (nll * valid).sum() / valid.sum().clamp(min=1.0)
            opt.zero_grad()
            loss.backward()
            if step == 0:
                wd = opt_cfg["weight_decay"]
                first_grad = {n: (params[n].grad
                                  + wd * weights[n]).detach().clone()
                              for n in names}
            opt.step()
            losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first_grad,
            "params": {n: params[n].detach() for n in names}}


@torch.no_grad()
def eval_logits(weights, x_uint8: torch.Tensor, cfg,
                prec: str = "f32") -> torch.Tensor:
    """Evaluation-mode logits (B, C, H, W) at the input's resolution."""
    with precision(prec):
        c = nets.Ctx(in_precision(weights, prec), train=False)
        return nets.full_res_logits(c, normalise(x_uint8, cfg, prec), cfg)


def margins(logits: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) logits -> (B, H, W) gap between the two most likely
    classes' probabilities."""
    p = torch.softmax(logits.float(), 1)
    top2 = torch.topk(p, 2, dim=1).values
    return top2[:, 0] - top2[:, 1]


def margin_picks(margin: torch.Tensor, excluded: torch.Tensor,
                 uniforms: torch.Tensor, n_pixels: int,
                 top_n_percent: float):
    """margin (B, H, W); excluded (B, H, W) bool (labelled or void);
    uniforms (B, H*W). Returns (picks (B, n_pixels) flat indices, the
    margins with the excluded pixels set to 1, the candidate threshold per
    image: the largest margin among the candidates)."""
    bsz = margin.shape[0]
    m = margin.masked_fill(excluded, 1.0).reshape(bsz, -1)
    k = max(n_pixels, int(m.shape[1] * top_n_percent))
    cand_m, cand = torch.topk(m, k, dim=1, largest=False)
    u = torch.gather(uniforms, 1, cand)
    sel = torch.topk(u, n_pixels, dim=1).indices
    return torch.gather(cand, 1, sel), m, cand_m[:, -1]


@torch.no_grad()
def calibrated_running_stats(weights, x_uint8: torch.Tensor, cfg) -> dict:
    """Running statistics from one batch-moment forward over ``x_uint8``
    (dropouts off): {bn name.running_mean / .running_var: tensor}."""
    record = {}
    with precision("f32"):
        c = nets.Ctx(weights, train=False, record=record)
        nets.forward(c, normalise(x_uint8, cfg), cfg)
    out = {}
    for name, (mean, var) in record.items():
        out[f"{name}.running_mean"] = mean
        out[f"{name}.running_var"] = var
    return out


def confusion(label: np.ndarray, pred: np.ndarray, n: int) -> np.ndarray:
    """(n, n) counts of (true, predicted) over pixels whose label is a
    class."""
    label = label.reshape(-1).astype(np.int64)
    pred = pred.reshape(-1).astype(np.int64)
    ok = (label >= 0) & (label < n)
    return np.bincount(n * label[ok] + pred[ok],
                       minlength=n * n).reshape(n, n)
