"""Train/eval step functions.

Counterpart of ``pixelpick_tpu/engine/trainer.py``. Only the input
normalisation that the query path shares is ported so far; the sparse-label
train step and the eval step come with the training slice (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import torch


def normalize_images(x_uint8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> normalised f32 (torchvision to_tensor + Normalize)."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x_uint8.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x_uint8.device)
    return (x_uint8.float() / 255.0 - mean) / std
