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
- ``height_shard`` / ``sharded_height``: ``--spatial_query_sharding``'s
  split of every image of a pool batch into row stripes, one per rank
  (``shard_batch_spatial``, ``mesh.py:147-183``). Every rank holds the
  whole host batch and computes its stripe of every map; the ops that pad
  rows take their neighbours' rows from ``parallel/halo.py``. Eval only.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from contextvars import ContextVar
from typing import NamedTuple, Optional, Tuple

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


class HeightShard(NamedTuple):
    """Rank ``rank``'s row stripe of every image of a batch: ``bounds`` are
    the W + 1 row boundaries at full size (``bounds[-1]`` the image
    height), each inner one a multiple of the network's total stride
    ``stride``. A map at stride s (s a power of 2 up to ``stride``) has
    ``ceil(h / s)`` rows, split at ``bounds[r] // s``."""
    bounds: Tuple[int, ...]
    rank: int
    stride: int

    def bounds_at(self, s: int) -> Tuple[int, ...]:
        """Every rank's boundaries on the map at stride ``s``."""
        return (*(b // s for b in self.bounds[:-1]), -(-self.bounds[-1] // s))

    def rows_at(self, s: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of the map at stride ``s``."""
        b = self.bounds_at(s)
        return b[self.rank], b[self.rank + 1]

    def level(self, rows: int) -> int:
        """The stride of the map whose stripe on this rank has ``rows``
        rows. Unique: every stripe holds at least ``stride`` rows at full
        size, so a rank's stripe shrinks at every level."""
        s = 1
        while s <= self.stride:
            lo, hi = self.rows_at(s)
            if hi - lo == rows:
                return s
            s *= 2
        raise ValueError(f"a stripe of {rows} rows is no level of the "
                         f"height shard {self}")


_HSHARD: ContextVar[Optional[HeightShard]] = ContextVar("height_shard",
                                                        default=None)


def _split(units: int, w: int, stride: int):
    """W + 1 boundaries of ``units`` stride units as equal as they go, the
    first ranks taking the extra units."""
    per, extra = divmod(units, w)
    out = [0]
    for r in range(w):
        out.append(out[-1] + (per + (r < extra)) * stride)
    return out


def height_shard(h: int, stride: int) -> Optional[HeightShard]:
    """This rank's stripe of images of ``h`` rows under a network of total
    stride ``stride``, or None: one rank, or fewer whole stride units than
    ranks (then the sweep runs replicated, with a warning, as JAX's
    ``shard_batch_spatial`` replicates, ``mesh.py:175-182``).

    The ``ceil(h / stride)`` rows of the deepest map are split as equally
    as they go, the first ranks taking the extra, and the last stripe
    ends at ``h`` (CamVid's 360 rows on 2 ranks: [0, 192), [192, 360)).
    Where that would leave the last stripe less than one whole unit, the
    ``h // stride`` whole units are split instead."""
    w = distributed.world_size()
    if w == 1:
        return None
    if h // stride < w:
        warnings.warn(
            f"--spatial_query_sharding: images of {h} rows hold {h // stride}"
            f" whole units of the network's stride {stride}, fewer than the "
            f"{w} ranks; the sweep runs replicated", stacklevel=2)
        return None
    b = _split(-(-h // stride), w, stride)
    if h - b[-2] < stride:
        b = _split(h // stride, w, stride)
    return HeightShard((*b[:-1], h), distributed.rank(), stride)


def shard_rows(batch: dict, shard: Optional[HeightShard]) -> dict:
    """The rank's rows of the image-shaped arrays of a host batch (``x``,
    ``excluded``, ``y``: axis 1); ``hw``, ``index`` and the rest whole."""
    if shard is None:
        return batch
    lo, hi = shard.rows_at(1)
    return {k: v[:, lo:hi] if k in ("x", "excluded", "y") else v
            for k, v in batch.items()}


@contextmanager
def sharded_height(shard: Optional[HeightShard]):
    """Run the block on row stripe ``shard`` of every image (None: whole).
    Eval only: every op that pads rows fetches its neighbours' rows."""
    token = _HSHARD.set(shard)
    try:
        yield
    finally:
        _HSHARD.reset(token)


def current_height_shard() -> Optional[HeightShard]:
    return _HSHARD.get()


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
              axis: int = 0, height_axis: Optional[int] = None
              ) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows: drawn for the whole
    global batch (``shape[axis]`` is the rank's row count) and sliced.
    Under a height shard, ``shape[height_axis]`` is the rank's stripe of a
    map: the draw is the whole map's, sliced to the stripe; a draw without
    ``height_axis`` is whole."""
    hs = _HSHARD.get()
    if hs is not None and height_axis is not None:
        level = hs.level(shape[height_axis])
        lo, hi = hs.rows_at(level)
        full = list(shape)
        full[height_axis] = hs.bounds_at(level)[-1]
        return torch.rand(full, generator=generator,
                          device=device).narrow(height_axis, lo, hi - lo)
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
