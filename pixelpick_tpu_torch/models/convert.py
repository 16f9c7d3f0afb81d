"""The weight bridge: JAX trees -> the port's ``state_dict``.

``state_dict_from_jax(params, batch_stats)`` turns the JAX package's
DeepLab variables (nested dicts of arrays) into a ``state_dict`` of the
port's DeepLab. The port's keys are the reference's torch layout, the layout
``pixelpick_tpu/models/convert.py:convert_deeplab`` reads, so that function
is this one's inverse:

- conv kernels HWIO -> OIHW (a depthwise ``(3, 3, 1, C)`` -> ``(C, 1, 3, 3)``);
- BatchNorm ``scale/bias`` -> ``weight/bias`` and ``mean/var`` ->
  ``running_mean/running_var`` (plus ``num_batches_tracked`` = 0, which the
  reference's modules carry).

It walks the trees' own leaves, so a partial tree gives the entries it
holds: the backbone-only file of ``python -m pixelpick_tpu.models.convert
--kind mobilenet_v2`` gives the backbone's.

``load_pretrained_ckpt(model, path)`` is the counterpart of
``pixelpick_tpu/models/convert.py:load_pretrained_ckpt`` (``overlay_tree``):
it reads a JAX msgpack file (``engine/flax_msgpack.py``) and overlays every
entry whose key the model has at the same shape; everything else keeps the
model's own init.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from pixelpick_tpu_torch.engine.flax_msgpack import flatten, msgpack_restore
from pixelpick_tpu_torch.models.mobilenet_v2 import block_plan


def _module_keys() -> Dict[Tuple[str, ...], str]:
    """JAX module scope (without a BatchNorm's inner ``bn``) -> the port's
    module key, for every module of the DeepLab."""
    keys = {
        ("backbone", "stem"): "backbone.features.0.0",
        ("backbone", "stem_bn"): "backbone.features.0.1",
        ("aspp", "gap_conv"): "aspp.global_avg_pool.1",
        ("aspp", "gap_bn"): "aspp.global_avg_pool.2",
        ("aspp", "proj"): "aspp.conv1",
        ("aspp", "proj_bn"): "aspp.bn1",
        ("low_level_conv",): "low_level_conv.0",
        ("low_level_bn",): "low_level_conv.1",
        ("seg_head", "conv1"): "seg_head.segment_head.0",
        ("seg_head", "bn1"): "seg_head.segment_head.1",
        ("seg_head", "conv2"): "seg_head.segment_head.4",
        ("seg_head", "bn2"): "seg_head.segment_head.5",
        ("seg_head", "classifier"): "seg_head.classifier",
    }
    for k in range(1, 5):
        keys[("aspp", f"aspp{k}")] = f"aspp.aspp{k}.atrous_conv"
        keys[("aspp", f"aspp{k}_bn")] = f"aspp.aspp{k}.bn"
    # block i's layers sit at these indices of ``features.{i+1}.conv``; the
    # expand ratio per block is the same at every width and output stride
    for i, (*_, t) in enumerate(block_plan(16)[0]):
        layers = ("dw", "dw_bn", None, "project", "project_bn") if t == 1 \
            else ("expand", "expand_bn", None, "dw", "dw_bn", None,
                  "project", "project_bn")
        for j, name in enumerate(layers):
            if name:
                keys[("backbone", f"block_{i}", name)] = \
                    f"backbone.features.{i + 1}.conv.{j}"
    return keys


MODULE_KEYS = _module_keys()
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
           "mean": "running_mean", "var": "running_var"}


def _tensor(path: Tuple[str, ...], leaf) -> torch.Tensor:
    a = np.array(leaf, dtype=np.float32)  # a writable copy
    if path[-1] == "kernel":
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """JAX DeepLab (params, batch_stats), whole or any part of them -> the
    port's DeepLab state_dict entries they hold."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, leaf in flatten(tree).items():
            scope = path[:-2] if path[-2:-1] == ("bn",) else path[:-1]
            if scope not in MODULE_KEYS:
                raise KeyError(f"no port module for the JAX leaf "
                               f"{'/'.join(path)}")
            key = MODULE_KEYS[scope]
            sd[f"{key}.{_LEAVES[path[-1]]}"] = _tensor(path, leaf)
            if path[-1] == "mean":
                sd[f"{key}.num_batches_tracked"] = torch.tensor(
                    0, dtype=torch.long)
    return sd


def load_pretrained_ckpt(model: torch.nn.Module, path: str) -> list:
    """Overlay a JAX-written ``{"params", "batch_stats"}`` msgpack file on
    ``model`` (``pixelpick_tpu/models/convert.py:137-170``): every entry
    whose key the model has at the same shape is copied in, the rest keeps
    its init. Returns the keys overlaid."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    entries = state_dict_from_jax(payload.get("params", {}),
                                  payload.get("batch_stats", {}))
    own = model.state_dict()
    done = []
    with torch.no_grad():
        for k, v in entries.items():
            if k in own and tuple(own[k].shape) == tuple(v.shape):
                own[k].copy_(v.to(own[k].dtype))
                done.append(k)
    return done
