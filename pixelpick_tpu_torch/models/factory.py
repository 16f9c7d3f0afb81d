"""Model factory (reference ``utils/utils.py:15-51 get_model``).

Counterpart of ``pixelpick_tpu/models/factory.py``: ``--network_name
deeplab`` builds the DeepLabv3+ on MobileNetV2, ``FPN`` the FPN on a
ResNet of ``--n_layers`` (dilated at 8 unless ``--use_dilated_resnet
false``). The model is built and initialised on the CPU from a seeded
``torch.Generator`` (so its weights do not depend on the device), then
moved to the device in ``channels_last`` memory format and put in eval
mode.
"""

from __future__ import annotations

import math

import torch

from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.models.fpn import FPNSeg
from pixelpick_tpu_torch.models.layers import (
    Conv1x1, Conv2d, PallasDepthwise, he_normal_fan_in_,
)
from pixelpick_tpu_torch.parallel import distributed


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


def he_normal_fan_out_(weight: torch.Tensor,
                       generator: torch.Generator) -> None:
    """flax He normal fan-out (``layers.py:19``, the torch ResNet init):
    std sqrt(2 / (out_ch * kh * kw))."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def init_model(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Conv kernels He-normal, fan-in (``layers.py:17``) except the FPN's
    ResNet encoder's, fan-out (``resnet.py``); zero conv biases.
    BatchNorm and GroupNorm keep their constructor init (scale 1, bias 0;
    mean 0, var 1)."""
    generator = torch.Generator().manual_seed(int(seed))
    for name, m in model.named_modules():
        if isinstance(m, (Conv1x1, Conv2d, PallasDepthwise)):
            init = he_normal_fan_out_ if name.startswith("encoder.") \
                else he_normal_fan_in_
            init(m.weight, generator)
            if getattr(m, "bias", None) is not None:
                torch.nn.init.zeros_(m.bias)
    return model


def get_model(args, device=None, seed=None) -> torch.nn.Module:
    """The DeepLab or FPN of ``args``, initialised from ``seed`` (default
    ``args.seed``), on ``device`` (default ``args.device``), in eval
    mode."""
    # f32 means full f32, as the JAX package's precision="highest"
    # (models/layers.py:304-307, ops/resize.py:75-77): no TF32 in cuDNN's
    # convolutions (on by default) nor in matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world = distributed.world_size()
    if getattr(args, "fused_ir", False) and world > 1:
        # the JAX package's rule (pixelpick_tpu/models/factory.py:15-22):
        # its fused kernels have no partitioning rule under a mesh
        raise ValueError(
            "--fused_ir is single-device only, as in the JAX package (a "
            f"pallas_call has no partitioning rule): {world} ranks. Drop "
            "the flag or run on one card.")
    bn_groups = int(getattr(args, "bn_group_size", 0) or 0)
    if args.network_name == "FPN":
        model = FPNSeg(n_classes=args.n_classes, n_layers=args.n_layers,
                       width_multiplier=args.width_multiplier,
                       dilate_scale=8 if args.use_dilated_resnet else 0,
                       dtype=compute_dtype(args), bn_groups=bn_groups)
    elif args.network_name == "deeplab":
        model = DeepLab(
            n_classes=args.n_classes, output_stride=16,
            width_mult=args.width_multiplier, dtype=compute_dtype(args),
            mc_dropout_p=getattr(args, "mc_dropout_p", 0.2),
            bn_groups=bn_groups,
            fused_ir=bool(getattr(args, "fused_ir", False)),
            mc_dropout=bool(getattr(args, "use_mc_dropout", False)),
            mc_dropout2d_committee=bool(
                getattr(args, "mc_dropout2d_committee", False)),
            # --s2d_backbone: the first 4 blocks in s2d layout, DeepLab only
            # (pixelpick_tpu/models/factory.py:35); the FPN ignores the flag
            s2d_until=4 if getattr(args, "s2d_backbone", False) else 0)
    else:
        raise ValueError(args.network_name)
    init_model(model, args.seed if seed is None else seed)
    device = resolve_device(device if device is not None else args.device)
    return model.to(device=device, memory_format=torch.channels_last).eval()
