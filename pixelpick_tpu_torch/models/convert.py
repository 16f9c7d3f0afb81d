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

Reading a JAX checkpoint file (msgpack/orbax) here is still open
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kernel(tree) -> torch.Tensor:
    return _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _bn(sd: Dict[str, torch.Tensor], key: str, params, stats) -> None:
    sd[f"{key}.weight"] = _t(params["bn"]["scale"])
    sd[f"{key}.bias"] = _t(params["bn"]["bias"])
    sd[f"{key}.running_mean"] = _t(stats["bn"]["mean"])
    sd[f"{key}.running_var"] = _t(stats["bn"]["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """JAX DeepLab (params, batch_stats) -> the port's DeepLab state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    bb_p, bb_s = params["backbone"], batch_stats["backbone"]
    sd["backbone.features.0.0.weight"] = _kernel(bb_p["stem"])
    _bn(sd, "backbone.features.0.1", bb_p["stem_bn"], bb_s["stem_bn"])
    i = 0
    while f"block_{i}" in bb_p:
        blk_p, blk_s = bb_p[f"block_{i}"], bb_s[f"block_{i}"]
        if "expand" in blk_p:
            layers = [("expand", 0), ("expand_bn", 1), ("dw", 3),
                      ("dw_bn", 4), ("project", 6), ("project_bn", 7)]
        else:
            layers = [("dw", 0), ("dw_bn", 1), ("project", 3),
                      ("project_bn", 4)]
        prefix = f"backbone.features.{i + 1}.conv"
        for name, j in layers:
            if name.endswith("_bn"):
                _bn(sd, f"{prefix}.{j}", blk_p[name], blk_s[name])
            else:
                sd[f"{prefix}.{j}.weight"] = _kernel(blk_p[name])
        i += 1

    a_p, a_s = params["aspp"], batch_stats["aspp"]
    for k in range(1, 5):
        sd[f"aspp.aspp{k}.atrous_conv.weight"] = _kernel(a_p[f"aspp{k}"])
        _bn(sd, f"aspp.aspp{k}.bn", a_p[f"aspp{k}_bn"], a_s[f"aspp{k}_bn"])
    sd["aspp.global_avg_pool.1.weight"] = _kernel(a_p["gap_conv"])
    _bn(sd, "aspp.global_avg_pool.2", a_p["gap_bn"], a_s["gap_bn"])
    sd["aspp.conv1.weight"] = _kernel(a_p["proj"])
    _bn(sd, "aspp.bn1", a_p["proj_bn"], a_s["proj_bn"])

    sd["low_level_conv.0.weight"] = _kernel(params["low_level_conv"])
    _bn(sd, "low_level_conv.1", params["low_level_bn"],
        batch_stats["low_level_bn"])

    h_p, h_s = params["seg_head"], batch_stats["seg_head"]
    sd["seg_head.segment_head.0.weight"] = _kernel(h_p["conv1"])
    _bn(sd, "seg_head.segment_head.1", h_p["bn1"], h_s["bn1"])
    sd["seg_head.segment_head.4.weight"] = _kernel(h_p["conv2"])
    _bn(sd, "seg_head.segment_head.5", h_p["bn2"], h_s["bn2"])
    sd["seg_head.classifier.weight"] = _kernel(h_p["classifier"])
    sd["seg_head.classifier.bias"] = _t(h_p["classifier"]["bias"])
    return sd
