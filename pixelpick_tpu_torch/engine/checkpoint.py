"""Checkpoints: best-model files in and out, and mid-stage snapshots.

Counterpart of ``pixelpick_tpu/engine/checkpoint.py``.

- ``save_checkpoint(path, model, backend)``: under ``msgpack`` (the
  default) the reference's torch format, ``{"model": state_dict}``
  (``model.py:207-216``); the port's module tree uses the reference's key
  layout, so a reference checkpoint loads here and a port checkpoint loads
  there. Under ``orbax`` the JAX package's ``<path>.orbax/step_N/``
  directory (``engine/orbax.py``), written on a background thread, which
  JAX's ``load_checkpoint`` reads; ``wait_for_checkpoints()`` blocks until
  it is on disk.
- ``load_checkpoint`` reads the torch file, a JAX msgpack file (told apart
  by the first bytes, decoded by ``engine/flax_msgpack.py``) or a JAX
  orbax directory ``<path>.orbax/``, which, as in JAX, wins over a file at
  ``path``: its newest committed step, decoded by ``engine/orbax.py``. The
  JAX trees become a ``state_dict`` through ``models/convert.py``.
- ``save_stage_state`` / ``load_stage_state``: the ``--stage_ckpt_interval``
  snapshot (``checkpoint.py:105-140``) in the port's own torch format: the
  model (parameters and BatchNorm statistics), the optimizer (moments and
  step count), the dropout generator's state, the completed epoch and the
  best validation mIoU. ``load_stage_state`` also resumes from a snapshot
  the JAX package wrote (a msgpack map of its ``TrainState``): weights and
  statistics through the weight bridge, the optimizer through
  ``optimizer_state_from_jax``. That snapshot holds no RNG state (JAX
  derives each dropout key from the step), so the dropout generator is
  seeded from the stage's seed and the resumed epoch
  (``jax_resume_seed``): the masks after such a resume are not the ones a
  straight run of the port draws. JAX keeps no BatchNorm update count
  either, so ``num_batches_tracked`` restarts at 0 (no computation reads
  it). ``save_jax_stage_state`` writes that
  layout from the port's state.

Under data parallelism (``parallel/distributed.py``) only the primary
rank writes (JAX ``checkpoint.py:92``), and every load waits at a barrier
first, so that no rank reads a file the primary is still writing. Every
rank holds the same weights, optimizer state and dropout generator.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from pixelpick_tpu_torch.engine import orbax
from pixelpick_tpu_torch.engine.flax_msgpack import (
    is_msgpack_map, msgpack_restore, msgpack_serialize,
)
from pixelpick_tpu_torch.engine.optim import (
    optimizer_state_from_jax, optimizer_state_to_jax,
)
from pixelpick_tpu_torch.parallel import distributed

TORCH_ZIP = b"PK\x03\x04"
STAGE_STATE_FORMAT = "pixelpick_tpu_torch.stage_state/1"
BACKENDS = ("msgpack", "orbax")
wait_for_checkpoints = orbax.wait_for_checkpoints


def _head(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read(4)


def _cpu_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_checkpoint(path: str, model: torch.nn.Module,
                    backend: str = "msgpack") -> None:
    if backend not in BACKENDS:
        raise ValueError(f"checkpoint backend {backend!r}, not one of "
                         f"{BACKENDS}")
    if not distributed.is_primary():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if backend == "orbax":
        from pixelpick_tpu_torch.models.convert import \
            jax_tree_from_state_dict

        params, stats, _ = jax_tree_from_state_dict(_cpu_state(model))
        orbax.save_async(os.path.abspath(path) + ".orbax",
                         {"params": params, "batch_stats": stats})
        return
    torch.save({"model": _cpu_state(model)}, path)


def _load_jax_tree(model: torch.nn.Module, payload: dict,
                   where: str) -> torch.nn.Module:
    from pixelpick_tpu_torch.models.convert import state_dict_from_jax

    if "params" not in payload:
        raise ValueError(f"{where}: a tree without 'params' (keys "
                         f"{sorted(payload)}) is not a JAX best-model "
                         f"checkpoint")
    model.load_state_dict(state_dict_from_jax(payload["params"],
                                              payload.get("batch_stats", {})))
    return model


def load_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a best-model checkpoint into ``model`` (strict): a JAX orbax
    directory ``<path>.orbax/``, else the file at ``path``, the torch
    ``{"model": state_dict}`` format or a JAX msgpack ``{"params",
    "batch_stats"}`` file."""
    distributed.barrier()
    root = os.path.abspath(path) + ".orbax"
    if os.path.isdir(root):
        wait_for_checkpoints()
        step = orbax.latest_step_dir(root)
        return _load_jax_tree(model, orbax.read_step(step), step)
    head = _head(path)
    if head == TORCH_ZIP:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"])
        return model
    if is_msgpack_map(head):
        with open(path, "rb") as f:
            return _load_jax_tree(model, msgpack_restore(f.read()), path)
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
        "model": _cpu_state(model),
        "optimizer": optimizer.state_dict(),
        "generator": generator.get_state(),
        "epoch": int(epoch),
        "best_miou": float(best_miou),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_jax_stage_state(path: str, model: torch.nn.Module, optimizer,
                         epoch: int, best_miou: float) -> None:
    """The snapshot in the JAX package's layout
    (``pixelpick_tpu/engine/checkpoint.py:save_stage_state``): ``{"state":
    to_state_dict(TrainState), "epoch", "best_miou"}`` as flax's msgpack."""
    from pixelpick_tpu_torch.models.convert import jax_tree_from_state_dict

    params, stats, _ = jax_tree_from_state_dict(_cpu_state(model))
    opt_state, step = optimizer_state_to_jax(optimizer, model)
    payload = {"state": {"batch_stats": stats, "opt_state": opt_state,
                         "params": params, "step": step},
               "epoch": int(epoch), "best_miou": float(best_miou)}
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(tmp, path)


def jax_resume_seed(seed: int, epoch: int) -> int:
    """The dropout generator's seed after resuming a JAX snapshot at
    ``epoch`` in a stage whose seed is ``seed``."""
    return ((seed ^ 0x5EED) << 20) + int(epoch)


def load_stage_state(path: str, model: torch.nn.Module, optimizer,
                     generator: torch.Generator,
                     seed: Optional[int] = None) -> Tuple[int, float]:
    """Restore a ``save_stage_state`` snapshot, the port's or the JAX
    package's, into a freshly built model, optimizer and generator; returns
    ``(epoch, best_miou)``. ``seed``: the stage's seed, which a JAX
    snapshot needs (see ``jax_resume_seed``)."""
    distributed.barrier()
    head = _head(path)
    if is_msgpack_map(head):
        with open(path, "rb") as f:
            payload = msgpack_restore(f.read())
        state = payload.get("state")
        if not isinstance(state, dict) or not {"params", "opt_state",
                                               "step"} <= set(state):
            raise ValueError(f"{path}: a msgpack map that is not a JAX stage "
                             f"snapshot (keys {sorted(payload)})")
        if seed is None:
            raise ValueError(f"{path} is a JAX stage snapshot, which holds "
                             f"no RNG state: pass the stage's seed")
        from pixelpick_tpu_torch.models.convert import state_dict_from_jax

        epoch = int(payload["epoch"])
        # both first, so that a snapshot that does not fit loads nothing
        sd = state_dict_from_jax(state["params"],
                                 state.get("batch_stats", {}))
        opt = optimizer_state_from_jax(state["opt_state"], state["step"],
                                       model, optimizer)
        model.load_state_dict(sd)
        optimizer.load_state_dict(opt)
        generator.manual_seed(jax_resume_seed(seed, epoch))
        return epoch, float(payload["best_miou"])
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
