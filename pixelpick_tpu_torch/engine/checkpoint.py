"""Checkpoints: best-model files in and out, and mid-stage snapshots.

Counterpart of ``pixelpick_tpu/engine/checkpoint.py``.

- ``save_checkpoint`` writes the reference's torch format,
  ``{"model": state_dict}`` (``model.py:207-216``); the port's module tree
  uses the reference's key layout, so a reference checkpoint loads here and
  a port checkpoint loads there.
- ``load_checkpoint`` also reads the JAX package's msgpack files (its
  default ``--ckpt_backend msgpack``): the format is told apart by the
  file's first bytes, the tree decoded without flax
  (``engine/flax_msgpack.py``) and turned into a ``state_dict``
  (``models/convert.py``). A JAX ``--ckpt_backend orbax`` directory
  (``<path>.orbax/``) raises: reading it needs orbax and tensorstore.
- ``save_stage_state`` / ``load_stage_state``: the ``--stage_ckpt_interval``
  snapshot (``checkpoint.py:105-140``) in the port's own torch format: the
  model (parameters and BatchNorm statistics), the optimizer (moments and
  step count), the dropout generator's state, the completed epoch and the
  best validation mIoU. A snapshot the JAX package wrote (a msgpack map,
  whose optax state has another layout) is refused, not mis-loaded.

Under data parallelism (``parallel/distributed.py``) only the primary
rank writes (JAX ``checkpoint.py:92``), and every load waits at a barrier
first, so that no rank reads a file the primary is still writing. Every
rank holds the same weights, optimizer state and dropout generator.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from pixelpick_tpu_torch.engine.flax_msgpack import (
    is_msgpack_map, msgpack_restore,
)
from pixelpick_tpu_torch.parallel import distributed

TORCH_ZIP = b"PK\x03\x04"
STAGE_STATE_FORMAT = "pixelpick_tpu_torch.stage_state/1"


def _head(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read(4)


def save_checkpoint(path: str, model: torch.nn.Module) -> None:
    if not distributed.is_primary():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": state}, path)


def load_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a best-model file into ``model`` (strict): the torch
    ``{"model": state_dict}`` format, or a JAX msgpack
    ``{"params", "batch_stats"}`` file."""
    distributed.barrier()
    if not os.path.isfile(path) \
            and os.path.isdir(os.path.abspath(path) + ".orbax"):
        raise NotImplementedError(
            f"{path}.orbax/ is a JAX --ckpt_backend orbax checkpoint; the "
            f"port reads msgpack files only (ROADMAP.md Queue 1 item 15). "
            f"Save it with --ckpt_backend msgpack instead")
    head = _head(path)
    if head == TORCH_ZIP:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"])
        return model
    if is_msgpack_map(head):
        from pixelpick_tpu_torch.models.convert import state_dict_from_jax

        with open(path, "rb") as f:
            payload = msgpack_restore(f.read())
        if "params" not in payload:
            raise ValueError(f"{path}: a msgpack map without 'params' "
                             f"(keys {sorted(payload)}) is not a JAX "
                             f"best-model checkpoint")
        sd = state_dict_from_jax(payload["params"],
                                 payload.get("batch_stats", {}))
        model.load_state_dict(sd)
        return model
    raise ValueError(f"{path}: neither a torch checkpoint nor a JAX msgpack "
                     f"file (first bytes {head!r})")


def save_stage_state(path: str, model: torch.nn.Module, optimizer,
                     generator: torch.Generator, epoch: int,
                     best_miou: float) -> None:
    """Write the mid-stage snapshot to a tmp file and rename it into place,
    so that a crash mid-save keeps the previous one."""
    if not distributed.is_primary():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "format": STAGE_STATE_FORMAT,
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "generator": generator.get_state(),
        "epoch": int(epoch),
        "best_miou": float(best_miou),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_stage_state(path: str, model: torch.nn.Module, optimizer,
                     generator: torch.Generator) -> Tuple[int, float]:
    """Restore a ``save_stage_state`` snapshot into a freshly built model,
    optimizer and generator; returns ``(epoch, best_miou)``."""
    distributed.barrier()
    head = _head(path)
    if is_msgpack_map(head):
        raise NotImplementedError(
            f"{path} is a stage snapshot of the JAX package (msgpack, optax "
            f"state); the port resumes from its own snapshots only "
            f"(ROADMAP.md Queue 1 item 15). Remove it to "
            f"restart the stage")
    if head != TORCH_ZIP:
        raise ValueError(f"{path}: not a stage snapshot (first bytes "
                         f"{head!r})")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != STAGE_STATE_FORMAT:
        raise ValueError(f"{path}: not a stage snapshot of the port "
                         f"(format {payload.get('format')!r})")
    model.load_state_dict(payload["model"])
    optimizer.load_state_dict(payload["optimizer"])
    generator.set_state(payload["generator"])
    return int(payload["epoch"]), float(payload["best_miou"])
