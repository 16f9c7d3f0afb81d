"""One seeded weight dict, made on the device, for the program and the
reference alike.

Every convolution kernel is He-normal (fan-in, the DeepLab's
initialisation; fan-out, the ResNet's), drawn in one ``randn`` call and cut
into the layers; biases and BatchNorm/GroupNorm shifts are 0, scales 1,
running means 0 and variances 1, as a fresh model's. Evaluation cells then
replace the running statistics with the moments of a batch of their own
images (``reference/steps.py:calibrated_running_stats``), so that an
evaluation forward of random weights sees activations at training's scale.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference import nets

WEIGHT_SALT = 0x9E3779B9


def make(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = nets.spec_of(cfg)
    gen = torch.Generator(device=device).manual_seed(
        (seed ^ WEIGHT_SALT) & ((1 << 63) - 1))
    convs = [(n, shape, kind) for n, (shape, kind) in spec.items()
             if kind.startswith("conv")]
    total = sum(math.prod(shape) for _, shape, _ in convs)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in convs:
        n = math.prod(shape)
        fan = shape[1 if kind == "conv_in" else 0] * shape[2] * shape[3]
        out[name] = (z[at:at + n] * math.sqrt(2.0 / fan)).reshape(shape)
        at += n
    fills = {"bias": 0.0, "bn_w": 1.0, "bn_b": 0.0, "gn_w": 1.0, "gn_b": 0.0,
             "bn_mean": 0.0, "bn_var": 1.0}
    for name, (shape, kind) in spec.items():
        if kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        elif kind in fills:
            out[name] = torch.full(shape, fills[kind], device=device)
    return {n: out[n] for n in spec}
