"""The weight bridge between the JAX trees and the port's ``state_dict``,
and the converter of torch checkpoints to the JAX package's files.

``state_dict_from_jax(params, batch_stats)`` turns the JAX package's
DeepLab or FPN variables (nested dicts of arrays) into a ``state_dict`` of
the port's model. The port's keys are the reference's torch layout, the
layout ``pixelpick_tpu/models/convert.py:convert_deeplab`` and
``convert_fpnseg`` read, so those functions are this one's inverse, and
``jax_tree_from_state_dict`` is the inverse here:

- conv kernels HWIO -> OIHW (a depthwise ``(3, 3, 1, C)`` -> ``(C, 1, 3, 3)``);
- BatchNorm ``scale/bias`` -> ``weight/bias`` and ``mean/var`` ->
  ``running_mean/running_var`` (plus ``num_batches_tracked`` = 0, which the
  reference's modules carry);
- GroupNorm (the FPN decoder's, no inner ``bn`` scope) ``scale/bias`` ->
  ``weight/bias``.

It walks the trees' own leaves, so a partial tree gives the entries it
holds: the backbone-only file of ``python -m pixelpick_tpu.models.convert
--kind mobilenet_v2`` gives the backbone's, a ``--kind resnet`` file the
FPN encoder's.

``load_pretrained_ckpt(model, path)`` is the counterpart of
``pixelpick_tpu/models/convert.py:load_pretrained_ckpt`` (``overlay_tree``):
it reads a JAX msgpack file (``engine/flax_msgpack.py``) and overlays every
entry whose key the model has at the same shape; everything else keeps the
model's own init.

The converter (``convert.py:176-283``) writes the ``{"params",
"batch_stats"}`` msgpack file that ``--pretrained_ckpt`` reads, from a torch
checkpoint::

    python -m pixelpick_tpu_torch.models.convert SRC.pth DST.ckpt \\
        --kind {mobilenet_v2,deeplab,resnet,fpn} [--weight_type moco_v2]
    python -m pixelpick_tpu_torch.models.convert --fetch NAME DST.ckpt

``--fetch NAME`` downloads the upstream checkpoint of ``FETCH_URLS`` into
``~/.cache/pixelpick_tpu_torch`` (once; a cached file is used again) and
infers ``--kind`` and ``--weight_type`` from the name. Without network it
exits with the JAX package's message and writes nothing.

``--kind resnet`` takes a torchvision ResNet (its stem moved under
``prefix.``, its ``fc`` dropped) or, with ``--weight_type moco_v2``, a
MoCo-v2 file (``adapt_moco_v2_keys``); ``mobilenet_v2`` the ImageNet
MobileNetV2 (``features.*``); ``deeplab`` and ``fpn`` the reference's whole
models. Torch keys with no module in the JAX tree (a classifier, the
MobileNetV2's last 1x1 conv) are skipped and counted.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from pixelpick_tpu_torch.engine.flax_msgpack import (
    flatten, msgpack_restore, msgpack_serialize,
)
from pixelpick_tpu_torch.models.fpn import CHAINS
from pixelpick_tpu_torch.models.mobilenet_v2 import block_plan
from pixelpick_tpu_torch.models.resnet import LAYER_SPECS


def _deeplab_keys() -> Dict[Tuple[str, ...], str]:
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


def _fpn_keys() -> Dict[Tuple[str, ...], str]:
    """The same for every module an FPN of any depth may hold: the deep-base
    stem's too, and the blocks of the deepest ResNet
    (``convert.py:320-386``)."""
    keys = {}
    for i in (1, 2, 3):
        keys[("encoder", f"conv{i}")] = f"encoder.base.prefix.conv{i}"
        keys[("encoder", f"bn{i}")] = f"encoder.base.prefix.bn{i}"
    depths = [max(d[li] for _, d in LAYER_SPECS.values()) for li in range(4)]
    for li, n_blocks in enumerate(depths, start=1):
        for bi in range(n_blocks):
            jax_blk, blk = f"layer{li}_{bi}", f"encoder.base.layer{li}.{bi}"
            for i in (1, 2, 3):
                keys[("encoder", jax_blk, f"conv{i}")] = f"{blk}.conv{i}"
                keys[("encoder", jax_blk, f"bn{i}")] = f"{blk}.bn{i}"
            keys[("encoder", jax_blk, "down_conv")] = f"{blk}.downsample.0"
            keys[("encoder", jax_blk, "down_bn")] = f"{blk}.downsample.1"
    for i in range(4):
        keys[("decoder", f"lat_layer_{i}")] = f"decoder.lat_layer_{i}"
    for ci, n in enumerate(CHAINS):
        for bi in range(n):
            blk = f"decoder.upsample_blocks_{ci}.{bi}.block"
            keys[("decoder", f"upsample_blocks_{ci}_{bi}", "conv")] = \
                f"{blk}.0"
            keys[("decoder", f"upsample_blocks_{ci}_{bi}", "gn")] = f"{blk}.1"
    keys[("decoder", "classifier")] = "decoder.classifier"
    return keys


MODULE_KEYS = {**_deeplab_keys(), **_fpn_keys()}
JAX_SCOPES = {v: k for k, v in MODULE_KEYS.items()}
_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
           "mean": "running_mean", "var": "running_var"}


def _tensor(path: Tuple[str, ...], leaf) -> torch.Tensor:
    a = np.array(leaf, dtype=np.float32)  # a writable copy
    if path[-1] == "kernel":
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """JAX DeepLab or FPN (params, batch_stats), whole or any part of them
    -> the port's state_dict entries they hold."""
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


def jax_tree_from_state_dict(state: Dict[str, torch.Tensor]
                             ) -> Tuple[dict, dict, list]:
    """The inverse of :func:`state_dict_from_jax`: a ``state_dict`` in the
    port's (the reference's) layout -> JAX ``(params, batch_stats,
    skipped)``, ``skipped`` the keys with no JAX module. A module with a
    ``running_mean`` is a BatchNorm (its leaves under ``bn``), another 1-D
    ``weight`` a GroupNorm, a 4-D one a conv kernel (OIHW -> HWIO)."""
    params: dict = {}
    stats: dict = {}
    skipped = []

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = np.ascontiguousarray(
            value.detach().cpu().float().numpy())

    for key, v in state.items():
        module, leaf = key.rsplit(".", 1)
        scope = JAX_SCOPES.get(module)
        if scope is None:
            skipped.append(key)
            continue
        if leaf == "num_batches_tracked":
            continue
        if f"{module}.running_mean" in state:
            tree = stats if leaf.startswith("running_") else params
            name = {"weight": "scale", "bias": "bias",
                    "running_mean": "mean", "running_var": "var"}[leaf]
            put(tree, scope + ("bn", name), v)
        elif leaf == "weight" and v.dim() == 4:
            put(params, scope + ("kernel",), v.permute(2, 3, 1, 0))
        else:
            put(params, scope + ("scale" if leaf == "weight" else leaf,), v)
    return params, stats, skipped


def adapt_torchvision_resnet_keys(state: dict) -> dict:
    """A torchvision ResNet checkpoint -> the reference's naming, which
    wraps the stem in a ``prefix`` Sequential (``convert.py:291-302``)."""
    out = {}
    for k, v in state.items():
        if k.startswith(("conv1.", "bn1.")):
            out[f"prefix.{k}"] = v
        elif not k.startswith("fc."):
            out[k] = v
    return out


def adapt_moco_v2_keys(state: dict) -> dict:
    """MoCo-v2 key surgery (``convert.py:305-318``): strip the
    momentum-encoder prefix, drop the projection head, route the stem into
    ``prefix``."""
    out = {}
    for k, v in state.items():
        k = k.replace("module.encoder_q.", "").replace("module.", "")
        if k.startswith("fc."):
            continue
        if k.startswith(("conv1.", "bn1.")):
            k = f"prefix.{k}"
        out[k] = v
    return out


def convert_state(state: dict, kind: str,
                  weight_type: str = "supervised") -> Tuple[dict, dict, list]:
    """A torch checkpoint's state dict -> (params, batch_stats, skipped) of
    the JAX tree ``python -m pixelpick_tpu.models.convert --kind KIND``
    writes."""
    if kind == "mobilenet_v2":
        state = {f"backbone.{k}": v for k, v in state.items()}
    elif kind == "resnet":
        if weight_type == "moco_v2":
            state = adapt_moco_v2_keys(state)
        elif not any(k.startswith("prefix.") for k in state):
            state = adapt_torchvision_resnet_keys(state)
        state = {f"encoder.base.{k}": v for k, v in state.items()}
    elif kind not in ("deeplab", "fpn"):
        raise ValueError(kind)
    return jax_tree_from_state_dict(state)


# The upstream weights the reference consumes: MobileNetV2 ImageNet
# (networks/mobilenet_v2.py:140), torchvision ResNets (the files
# networks/encoder.py:4-15 expects under pretrained/), MoCo-v2 800ep.
FETCH_URLS = {
    "mobilenet_v2": "http://jeff95.me/models/mobilenet_v2-6a65762b.pth",
    "resnet18": "https://download.pytorch.org/models/resnet18-5c106cde.pth",
    "resnet34": "https://download.pytorch.org/models/resnet34-333f7ec4.pth",
    "resnet50": "https://download.pytorch.org/models/resnet50-19c8e357.pth",
    "resnet101": "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth",
    "moco_v2": ("https://dl.fbaipublicfiles.com/moco/moco_checkpoints/"
                "moco_v2_800ep/moco_v2_800ep_pretrain.pth.tar"),
}


def fetch_weights(name: str, cache_dir: str = "") -> str:
    """Download the named upstream torch checkpoint into the cache
    directory (once) and return its path. Without network it exits with a
    message, leaving nothing behind."""
    import urllib.error
    import urllib.request

    url = FETCH_URLS[name]
    cache_dir = cache_dir or os.path.expanduser("~/.cache/pixelpick_tpu_torch")
    dst = os.path.join(cache_dir, url.rsplit("/", 1)[-1])
    if os.path.isfile(dst):
        print(f"using cached {dst}")
        return dst
    print(f"fetching {url} -> {dst}")
    os.makedirs(cache_dir, exist_ok=True)
    part = dst + ".part"
    try:
        urllib.request.urlretrieve(url, part)
    except (urllib.error.URLError, OSError) as e:
        if os.path.exists(part):
            os.remove(part)
        raise SystemExit(
            f"could not fetch {url}: {e}\n"
            "This environment has no egress. Download the file elsewhere, "
            f"place it at {dst}, and re-run — or pass the .pth path "
            "directly as SRC.") from e
    os.replace(part, dst)
    return dst


def main(argv=None) -> str:
    """The convert CLI; returns the path written."""
    from argparse import ArgumentParser

    parser = ArgumentParser("torch checkpoint -> --pretrained_ckpt file")
    parser.add_argument("src", nargs="?", default="")
    parser.add_argument("dst")
    parser.add_argument("--fetch", default="", choices=[""] + list(FETCH_URLS),
                        help="download this upstream checkpoint instead of "
                             "reading SRC (cached in "
                             "~/.cache/pixelpick_tpu_torch)")
    parser.add_argument("--kind", default="",
                        choices=["", "mobilenet_v2", "deeplab", "resnet",
                                 "fpn"])
    parser.add_argument("--weight_type", default="supervised",
                        choices=["supervised", "moco_v2"])
    args = parser.parse_args(argv)
    if args.fetch:
        args.src = fetch_weights(args.fetch)
        if not args.kind:
            args.kind = "mobilenet_v2" if args.fetch == "mobilenet_v2" \
                else "resnet"
        if args.fetch == "moco_v2":
            args.weight_type = "moco_v2"
    if not args.src or not args.kind:
        parser.error("pass SRC and --kind, or --fetch NAME")
    blob = torch.load(args.src, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob.get("model", blob)) \
        if isinstance(blob, dict) else blob
    params, stats, skipped = convert_state(dict(state), args.kind,
                                           args.weight_type)
    if not params:
        raise SystemExit(f"{args.src}: no key maps onto a {args.kind} "
                         "module")
    with open(args.dst, "wb") as f:
        f.write(msgpack_serialize({"params": params, "batch_stats": stats}))
    print(f"wrote {args.dst} ({len(flatten(params))} param tensors; "
          f"{len(skipped)} keys skipped{': ' if skipped else ''}"
          f"{', '.join(skipped[:5])}{' ...' if len(skipped) > 5 else ''})")
    return args.dst


if __name__ == "__main__":
    main()
