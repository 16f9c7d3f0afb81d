"""Checkpointing in the reference's torch format.

The reference saves ``{"model": state_dict}`` files (``model.py:207-216``);
the port's module tree uses the reference's key layout, so a reference
checkpoint loads here and a port checkpoint loads there. Counterpart of
``pixelpick_tpu/engine/checkpoint.py``, whose msgpack/orbax formats hold
the JAX trees; reading those here is still open (ROADMAP.md).
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, model: torch.nn.Module) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": state}, path)


def load_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a ``{"model": state_dict}`` file into ``model`` (strict)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    return model
