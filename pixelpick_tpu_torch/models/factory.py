"""Model factory (reference ``utils/utils.py:15-51 get_model``).

Counterpart of ``pixelpick_tpu/models/factory.py``. The model is built and
initialised on the CPU from a seeded ``torch.Generator`` (so its weights do
not depend on the device), then moved to the device in ``channels_last``
memory format and put in eval mode.
"""

from __future__ import annotations

import torch

from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.models.layers import (
    Conv1x1, Conv2d, PallasDepthwise, he_normal_fan_in_,
)


def resolve_device(name) -> torch.device:
    """The device an entry point runs on. Asking for CUDA without a card
    raises: nothing carries on on the CPU in its place."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    return device


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if getattr(args, "precision", "f32") == "bf16" \
        else torch.float32


def init_model(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """He-normal fan-in conv kernels, zero conv biases (``layers.py:17``);
    BatchNorm keeps its constructor init (scale 1, bias 0, mean 0, var 1)."""
    generator = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, (Conv1x1, Conv2d, PallasDepthwise)):
            he_normal_fan_in_(m.weight, generator)
            if getattr(m, "bias", None) is not None:
                torch.nn.init.zeros_(m.bias)
    return model


def get_model(args, device=None, seed=None) -> DeepLab:
    """The DeepLab of ``args``, initialised from ``seed`` (default
    ``args.seed``), on ``device`` (default ``args.device``), in eval mode."""
    # f32 means full f32, as the JAX package's precision="highest"
    # (models/layers.py:304-307, ops/resize.py:75-77): no TF32 in cuDNN's
    # convolutions (on by default) nor in matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.network_name != "deeplab":
        raise NotImplementedError(f"network {args.network_name!r} is not "
                                  "ported yet (ROADMAP.md, Queue 1)")
    model = DeepLab(n_classes=args.n_classes, output_stride=16,
                    width_mult=args.width_multiplier,
                    dtype=compute_dtype(args),
                    mc_dropout_p=getattr(args, "mc_dropout_p", 0.2),
                    bn_groups=int(getattr(args, "bn_group_size", 0) or 0),
                    fused_ir=bool(getattr(args, "fused_ir", False)),
                    mc_dropout=bool(getattr(args, "use_mc_dropout", False)),
                    mc_dropout2d_committee=bool(
                        getattr(args, "mc_dropout2d_committee", False)))
    init_model(model, args.seed if seed is None else seed)
    device = resolve_device(device if device is not None else args.device)
    return model.to(device=device, memory_format=torch.channels_last).eval()
