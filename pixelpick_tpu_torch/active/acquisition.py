"""The acquisition engine — batched pool scoring on the device.

Counterpart of ``pixelpick_tpu/active/acquisition.py`` (reference
``query.py:144-247``): for a batch of pool images, softmax the logits, score
each pixel with the chosen uncertainty strategy, overwrite already-labelled
and void pixels with the strategy's "worst" value, then take the top-k over
the flattened map (k = ``top_n_percent * H*W`` with a random sub-sample of
``n_pixels_by_us``, or directly ``n_pixels_by_us``), optionally through the
``reverse_order`` variant. Only the (B, n_pixels) indices and small stats
tensors leave the device.

With ``mc_n_steps > 0`` the MC-dropout committee scores instead
(``acquisition.py:125-154``, reference ``query.py:177-187``):
``mc_n_steps`` eval-mode forwards with the dropouts on, ``prob`` the mean of
the members' softmaxes (the stats read it), and the uncertainty either the
mean of the members' maps (``vote_type="soft"``) or the strategy's formula
on the mean one-hot argmax votes (``"hard"``).

Randomness (the sub-sample draws, the ``reverse_order`` candidate draws,
the ``random`` strategy's scores) comes from a ``torch.Generator``, or is
injected by the caller, so tests can feed both frameworks the same draws.
The committee's dropout masks come from the model's dropout generator
(``DeepLab.set_dropout_generator``).

A bucketed pool batch (VOC; ``data/loader.py``) carries ``hw``, each
image's true size: the padding beyond it is never picked, and the
candidate pool's size comes from the true area, as the reference computes
``k = int(h * w * top_n_percent)`` from the image itself
(``acquisition.py:49-58, 163-176``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from pixelpick_tpu_torch.engine.trainer import normalize_images
from pixelpick_tpu_torch.ops.resize import resize_align_corners
from pixelpick_tpu_torch.ops.uncertainty import (
    MAXIMIZING, fill_value, uncertainty_map, xlogx,
)


def _full_res_pred(model, x: torch.Tensor, **kw) -> torch.Tensor:
    """Full-resolution f32 logits without the full-resolution emb."""
    pred = model(x, upsample=False, **kw)["pred"].float()
    if pred.shape[1:3] != x.shape[1:3]:
        pred = resize_align_corners(pred, x.shape[1:3])
    return pred


def candidate_counts(n: int, true_n: torch.Tensor, n_pixels: int,
                     top_n_percent: float):
    """Sizes of the candidate pool the sub-sample draws from: a bound
    ``int(n * p)`` in double over the (padded) map of ``n`` pixels, and per
    image ``int(f32(true_n) * f32(p))`` (``true_n`` (B,) the true pixel
    counts), both clamped to >= n_pixels (``acquisition.py:71-80``).
    Returns (bound, (B,) counts)."""
    k_bucket = max(n_pixels, int(n * top_n_percent))
    k_true = (true_n.float() * top_n_percent).long().clamp(min=n_pixels)
    return k_bucket, k_true


def _select_topk(uc_flat: torch.Tensor, uniforms: Optional[torch.Tensor], *,
                 strategy: str, n_pixels: int, top_n_percent: float,
                 reverse_order: bool, pad_mask: Optional[torch.Tensor] = None,
                 true_n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image selection over flattened uncertainty maps (B, n)
    (query.py:33-69). ``uniforms`` (B, n) are U[0,1) draws, one per pixel:
    the sub-sample keys (highest n_pixels among the candidates win, which is
    choice without replacement keyed to pixel identity), or the
    ``reverse_order`` candidate draws. Unused when ``top_n_percent <= 0``.
    ``pad_mask`` (B, n) marks bucket padding, never picked; ``true_n`` (B,)
    the images' true pixel counts (default n).

    Returns (B, n_pixels) int64 flat indices."""
    signed = uc_flat if strategy in MAXIMIZING else -uc_flat
    if pad_mask is not None:
        signed = signed.masked_fill(pad_mask, float("-inf"))
    if top_n_percent <= 0.0:
        return torch.topk(signed, n_pixels, dim=1).indices

    bsz, n = uc_flat.shape
    if true_n is None:
        true_n = torch.full((bsz,), n, device=uc_flat.device)
    k, k_true = candidate_counts(n, true_n, n_pixels, top_n_percent)
    # ranks beyond an image's own count are no candidates
    rank_ok = torch.arange(k, device=uc_flat.device)[None] < k_true[:, None]
    if reverse_order:
        # a uniform candidate subset of the image's count (query.py:39-42),
        # then the top-n_pixels by score among it (query.py:44-54)
        r = uniforms if pad_mask is None \
            else uniforms.masked_fill(pad_mask, float("-inf"))
        cand = torch.topk(r, k, dim=1).indices
        scores = torch.gather(signed, 1, cand).masked_fill(~rank_ok,
                                                           float("-inf"))
        picked = torch.topk(scores, n_pixels, dim=1).indices
        return torch.gather(cand, 1, picked)
    idx = torch.topk(signed, k, dim=1).indices
    r = torch.gather(uniforms, 1, idx).masked_fill(~rank_ok, float("-inf"))
    sel = torch.topk(r, n_pixels, dim=1).indices
    return torch.gather(idx, 1, sel)


def committee(model, x: torch.Tensor, *, strategy: str, mc_n_steps: int,
              vote_type: str, member_scores=None, score=None):
    """The MC-dropout committee over normalised images x (B, H, W, 3):
    ``mc_n_steps`` eval-mode forwards with the dropouts on. Returns (prob,
    uc): the mean of the members' softmaxes, and the mean of their
    uncertainty maps (soft vote) or the strategy's formula on the mean
    one-hot argmax votes (hard vote). The ``random`` strategy reads
    ``member_scores`` (mc_n_steps, B, H, W), one draw per member, and in the
    hard vote ``score`` (B, H, W). The accumulators are (B, H, W, C) and
    (B, H, W) f32, as the JAX scan's carry; the hard vote's replaces the
    soft vote's (B, H, W) one."""
    hard = vote_type == "hard"
    prob = acc = None
    for m in range(mc_n_steps):
        p = torch.softmax(_full_res_pred(model, x, mc_dropout_on=True), -1)
        if hard:
            a = torch.zeros_like(p).scatter_(-1, p.argmax(-1, keepdim=True),
                                             1.0)
        else:
            a = uncertainty_map(p, strategy, None if member_scores is None
                                else member_scores[m])
        prob, acc = (p, a) if prob is None else (prob + p, acc + a)
    prob = prob / mc_n_steps
    if hard:
        return prob, uncertainty_map(acc / mc_n_steps, strategy, score)
    return prob, acc / mc_n_steps


def make_score_fn(model, *, strategy: str, mean, std,
                  n_pixels: int, top_n_percent: float, reverse_order: bool,
                  ignore_index: int, mc_n_steps: int = 0,
                  vote_type: str = "soft") -> Callable:
    """Build the batched pool-scoring function; ``mc_n_steps > 0`` scores
    with the MC-dropout committee (:func:`committee`).

    ``score_batch(batch, generator=None, uniforms=None)``, batch keys (all
    tensors on the model's device):
      x:        (B, H, W, 3) uint8
      excluded: (B, H, W) bool — already-labelled pixels
      y:        (B, H, W) int ground truth (oracle mode; all zeros in
                human-label mode) — the void exclusion and the stats;
      hw:       (B, 2) int, optional — the true sizes of a bucketed batch.
    ``uniforms`` may inject the draws: ``{"select": (B, H*W)}`` and, for the
    random strategy, ``{"score": (B, H, W)}`` (the plain sweep and the hard
    vote) and ``{"member_scores": (mc_n_steps, B, H, W)}`` (the committee's
    members); otherwise they are drawn from ``generator`` (on the batch's
    device).

    Returns (indices (B, n_pixels) int64 flat, stats dict of tensors).
    """
    @torch.no_grad()
    def score_batch(batch: Dict[str, torch.Tensor], generator=None,
                    uniforms: Optional[Dict[str, torch.Tensor]] = None):
        bsz, big_h, big_w = batch["x"].shape[:3]
        dev = batch["x"].device
        if uniforms is None:
            uniforms = {}
            if top_n_percent > 0.0:
                uniforms["select"] = torch.rand(
                    (bsz, big_h * big_w), generator=generator, device=dev)
            if strategy == "random":
                uniforms["score"] = torch.rand(
                    (bsz, big_h, big_w), generator=generator, device=dev)
                if mc_n_steps > 0:
                    uniforms["member_scores"] = torch.rand(
                        (mc_n_steps, bsz, big_h, big_w), generator=generator,
                        device=dev)

        x = normalize_images(batch["x"], mean, std)
        if mc_n_steps > 0:
            prob, uc = committee(model, x, strategy=strategy,
                                 mc_n_steps=mc_n_steps, vote_type=vote_type,
                                 member_scores=uniforms.get("member_scores"),
                                 score=uniforms.get("score"))
        else:
            prob = torch.softmax(_full_res_pred(model, x), -1)
            uc = uncertainty_map(prob, strategy, uniforms.get("score"))
        excluded = batch["excluded"] | (batch["y"] == ignore_index)
        uc = uc.masked_fill(excluded, fill_value(strategy))
        if "hw" in batch:
            hw = batch["hw"].long()
            rows = torch.arange(big_h, device=dev)[None, :, None]
            cols = torch.arange(big_w, device=dev)[None, None, :]
            pad = (rows >= hw[:, 0, None, None]) \
                | (cols >= hw[:, 1, None, None])
            true_n = hw[:, 0] * hw[:, 1]
        else:
            pad = torch.zeros_like(excluded)
            true_n = None
        idx = _select_topk(uc.reshape(bsz, -1), uniforms.get("select"),
                           strategy=strategy, n_pixels=n_pixels,
                           top_n_percent=top_n_percent,
                           reverse_order=reverse_order,
                           pad_mask=pad.reshape(bsz, -1), true_n=true_n)

        # acquisition stats at the picked pixels (QueryStats,
        # query.py:250-308). picked_valid masks picks that spilled into
        # excluded/void/pad pixels (an image with < n_pixels candidates)
        picked_valid = torch.gather((~(excluded | pad)).reshape(bsz, -1), 1,
                                    idx)
        c = prob.shape[-1]
        picked_prob = torch.gather(prob.reshape(bsz, -1, c), 1,
                                   idx[..., None].expand(-1, -1, c))
        picked_ent = -xlogx(picked_prob).sum(-1)
        picked_y = torch.gather(batch["y"].reshape(bsz, -1).long(), 1, idx)
        ys, xs = idx // big_w, idx % big_w
        # mean pairwise distance per image over valid picks (coverage)
        dy = ys[:, :, None] - ys[:, None, :]
        dx = xs[:, :, None] - xs[:, None, :]
        d = torch.sqrt((dy * dy + dx * dx).float())
        pair_ok = (picked_valid[:, :, None] & picked_valid[:, None, :]
                   & ~torch.eye(n_pixels, dtype=torch.bool, device=dev))
        # an image with < 2 valid picks has no pair distances: NaN, as the
        # reference's _spatial_coverage (query.py:269-279)
        n_pairs = pair_ok.sum((1, 2))
        coverage = torch.where(
            n_pairs > 0,
            (d * pair_ok).sum((1, 2)) / n_pairs.clamp(min=1),
            torch.full_like(d[:, 0, 0], float("nan")))

        stats = {"entropy": picked_ent, "labels": picked_y,
                 "coverage": coverage, "picked_valid": picked_valid}
        return idx, stats

    return score_batch
