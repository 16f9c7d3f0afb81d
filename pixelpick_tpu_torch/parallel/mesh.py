"""Batch sharding and padding over the ranks of ``parallel/distributed.py``.

Counterpart of ``pixelpick_tpu/parallel/mesh.py``. The JAX package shards a
batch over a ``('data',)`` mesh and lets XLA insert the collectives; here
each rank computes its rows of the global batch and the steps reduce
explicitly. The contract is the JAX package's (``mesh.py:1-17``): a sharded
step computes what the single-device step computes on the whole global
batch.

- ``row_shard``: ``shard_batch``'s rule (``mesh.py:131-145``). Rank r takes
  the contiguous rows ``[r B/W, (r+1) B/W)`` when W divides B; otherwise
  every rank computes the whole batch, replicated, with no reduction.
- ``sharded``: the shard a step runs under. The train-mode BatchNorm
  (``models/layers.py``) reads the global row count from it, the random
  draws (``rand_rows``) are made for the global batch and sliced to the
  rank's rows, so W ranks draw what one process draws, and ``reduce_sum``
  sums over the ranks.
- ``pad_batch_to_devices``: remainder batches padded with inert rows
  (``mesh.py:70-129``), to a multiple of the world size or to
  ``target_rows``. A host-side NumPy function.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import NamedTuple, Optional

import numpy as np
import torch

from pixelpick_tpu_torch.parallel import distributed


class RowShard(NamedTuple):
    """This rank's rows ``[lo, hi)`` of a global batch of ``rows`` rows."""
    lo: int
    hi: int
    rows: int


_SHARD: ContextVar[Optional[RowShard]] = ContextVar("row_shard",
                                                    default=None)


def row_shard(b: int) -> Optional[RowShard]:
    """This rank's rows of a global batch of ``b`` rows, or None when the
    batch runs whole on every rank (one rank, or W does not divide b)."""
    w = distributed.world_size()
    if w == 1 or b % w:
        return None
    per, r = b // w, distributed.rank()
    return RowShard(r * per, (r + 1) * per, b)


def megabatch_rows(b: int, unit: int):
    """This rank's rows of a megabatch of ``b`` rows that runs as ``b //
    unit`` sequential updates of ``unit`` rows, each sharded on its own
    (``row_shard(unit)``): (their global positions in update order, the
    shard of one update), or (None, None) when every rank runs every
    row."""
    s = row_shard(unit)
    if s is None:
        return None, None
    pos = np.arange(0, b, unit)[:, None] + np.arange(s.lo, s.hi)[None, :]
    return pos.reshape(-1), s


def gather_rows(local: np.ndarray, pos: Optional[np.ndarray],
                b: int) -> np.ndarray:
    """The global batch's per-row host values from every rank's ``local``
    values at its positions ``pos`` (``megabatch_rows``); ``local`` itself
    when ``pos`` is None."""
    if pos is None:
        return local
    out = np.empty((b, *local.shape[1:]), local.dtype)
    for p, v in distributed.all_gather_object((pos, local)):
        out[p] = v
    return out


def shard_batch(batch: dict, shard: Optional[RowShard]) -> dict:
    """The rank's rows of a host batch (every array on its leading axis)."""
    if shard is None:
        return batch
    return {k: v[shard.lo:shard.hi] for k, v in batch.items()}


@contextmanager
def sharded(shard: Optional[RowShard]):
    """Run the block as rows ``shard`` of its global batch (None: whole)."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


def current_shard() -> Optional[RowShard]:
    return _SHARD.get()


def rand_rows(shape, generator: Optional[torch.Generator], device,
              axis: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows: drawn for the whole
    global batch (``shape[axis]`` is the rank's row count) and sliced."""
    s = _SHARD.get()
    if s is None:
        return torch.rand(shape, generator=generator, device=device)
    if shape[axis] != s.hi - s.lo:
        raise ValueError(f"a draw of {shape[axis]} rows under a shard of "
                         f"{s.hi - s.lo}")
    full = list(shape)
    full[axis] = s.rows
    return torch.rand(full, generator=generator,
                      device=device).narrow(axis, s.lo, s.hi - s.lo)


def reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place when the running block is
    sharded (no gradient flows through it); returns ``t``."""
    if _SHARD.get() is not None:
        torch.distributed.all_reduce(t)
    return t


def all_reduce_grads(params) -> None:
    """Sum the parameters' gradients over the ranks, in one flat buffer;
    a parameter without a gradient takes a zero one, so every rank sends
    the same layout."""
    params = [p for p in params if p.requires_grad]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat)
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p)
        off += n


def pad_batch_to_devices(batch: dict, pad_label: Optional[int] = None,
                         target_rows: Optional[int] = None,
                         multiple: int = 1):
    """Pad a remainder batch with inert duplicates of its last row to
    ``target_rows`` rows, or else to a multiple of ``multiple`` (the world
    size); returns ``(padded_batch, n_real)``.

    The driver pads a remainder train batch to a multiple of lcm(world
    size, micro-batch size) when the full batches shard (JAX
    ``driver.py:416-440``), and a remainder validation batch to the full
    batch. Every masking key of a pad row is overridden:

    - ``valid`` -> False: the sparse loss and the train confusion matrix
      read nothing of it;
    - ``y`` -> ``pad_label`` (the ignore index): the dense loss and the
      eval confusion matrix drop it;
    - ``excluded`` -> True: acquisition never picks it;
    - ``index`` -> -1: consumers that track images skip it.

    BatchNorm's batch moments still see the pad rows, as in the JAX
    package."""
    b = next(iter(batch.values())).shape[0]
    target = target_rows if target_rows is not None \
        else -(-b // multiple) * multiple
    if target <= b:
        return batch, b
    pad = target - b
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
    if "valid" in out:
        out["valid"][b:] = False
    if "y" in out and pad_label is not None:
        out["y"][b:] = pad_label
    if "excluded" in out:
        out["excluded"][b:] = True
    if "index" in out:
        out["index"][b:] = -1
    return out, b
