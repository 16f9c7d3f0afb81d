"""Per-pixel uncertainty scores from softmax probabilities.

Counterpart of ``pixelpick_tpu/ops/uncertainty.py`` (reference
``UncertaintySampler``, ``query.py:224-247``).
"""

from __future__ import annotations

from typing import Optional

import torch

MAXIMIZING = ("entropy", "least_confidence")  # query.py:45,53: largest=True


def xlogx(p: torch.Tensor) -> torch.Tensor:
    """p*log(p) with the p=0 limit (0), avoiding NaN where softmax
    underflows to exact zero."""
    return torch.where(p > 0, p * torch.log(p.clamp(min=1e-30)),
                       torch.zeros_like(p))


def uncertainty_map(prob: torch.Tensor, strategy: str,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel uncertainty from softmax probs (B,H,W,C) -> (B,H,W).

    ``noise`` is the (B,H,W) U[0,1) draw the ``random`` strategy returns;
    the caller draws it from its generator (or injects it, as tests do)."""
    if strategy == "entropy":
        return -xlogx(prob).sum(-1)
    if strategy == "least_confidence":
        return 1.0 - prob.amax(-1)
    if strategy == "margin_sampling":
        top2 = torch.topk(prob, 2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]).abs()
    if strategy == "random":
        if noise is None:
            raise ValueError("the random strategy needs its noise draw")
        return noise
    raise ValueError(strategy)


def fill_value(strategy: str) -> float:
    """The 'never pick this' value (query.py:196-201)."""
    return 0.0 if strategy in MAXIMIZING else 1.0


def vis_maps(logits0: torch.Tensor) -> dict:
    """The visualisation maps of ONE image's full-resolution logits
    (1, H, W, C): prediction and the three uncertainty panels
    (``ops/uncertainty.py:vis_maps``), on the logits' device."""
    prob = torch.softmax(logits0.float(), -1)
    return {
        "pred": prob.argmax(-1)[0],
        "entropy": uncertainty_map(prob, "entropy")[0],
        "least_confidence": uncertainty_map(prob, "least_confidence")[0],
        "margin_sampling": uncertainty_map(prob, "margin_sampling")[0],
    }
