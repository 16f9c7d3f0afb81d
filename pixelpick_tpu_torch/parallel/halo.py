"""Row halos of height-sharded maps (``--spatial_query_sharding``).

Under ``parallel/mesh.py:sharded_height`` every rank holds a row stripe of
every map. Each op that pads rows, sums over them or reads rows for a
resize calls one function here, sharded or not; with no height shard
active it gets back what it did before. Under a shard the pad rows are the
op's own fill at the image's edges (zeros for a convolution, -inf for a
max pool) and the rows the other ranks hold between stripes, and the op
runs VALID in height. This is where the JAX package leaves GSPMD to insert
the halo exchanges.

- ``pad_rows``: the rows a window op (a convolution, the depthwise
  kernel's pre-padded input, a max pool, the s2d blocks' cell convs)
  reads, and the row padding it still applies itself.
- ``fetch_rows``: rows ``[a, b)`` of a map, for every rank its own
  ``(a, b)``. Each rank sends its first and last ``R`` rows, ``R`` the
  farthest any rank reaches past its stripe (at most the tallest
  stripe), in one all-gather over the world group (NCCL on cards, gloo on
  the CPU; under gloo a CUDA stripe is staged through host memory). A
  reach past the next rank (the ASPP's rate 18 at 1/16 over stripes of 11
  rows) takes the whole stripes in between.
- ``bounds``: every rank's row boundaries on a map.
- ``stripe``: this rank's rows of a map computed whole (the s2d blocks'
  border map).
- ``mean``: a mean over the rows and more, summed over the ranks.
- ``gather_rows``: the whole map on every rank (the pick's score map).

Every collective is eval-only: one that fails raises, and nothing falls
back to zeros or to replication.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch

from pixelpick_tpu_torch.parallel import distributed, mesh


def bounds(rows: int) -> Tuple[Tuple[int, ...], int]:
    """(every rank's row boundaries on the map whose stripe here has
    ``rows`` rows, this rank); ``((0, rows), 0)`` with no height shard."""
    shard = mesh.current_height_shard()
    if shard is None:
        return (0, rows), 0
    return shard.bounds_at(shard.level(rows)), shard.rank


def _fill(x: torch.Tensor, n: int, axis: int, value: float) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = n
    return torch.full(shape, value, dtype=x.dtype, device=x.device)


def fetch_rows(x: torch.Tensor, needs: Sequence[Tuple[int, int]],
               fill: float = 0.0, axis: int = 2) -> torch.Tensor:
    """Rows ``[a, b)`` (``needs[rank]``) of the map whose stripe ``x``
    holds on axis ``axis``, rows outside the map filled with ``fill``.
    ``needs`` holds every rank's ``(a, b)``, as each rank computes it, so
    that every rank knows what the others send."""
    edges, r = bounds(x.shape[axis])
    h, w = edges[-1], len(edges) - 1
    lo, hi = edges[r], edges[r + 1]
    a, b = needs[r]
    reach = max(max(edges[q] - max(qa, 0), min(qb, h) - edges[q + 1], 0)
                for q, (qa, qb) in enumerate(needs))
    if not reach and (a, b) == (lo, hi):
        return x
    # a reach past the tallest stripe takes whole stripes
    reach = min(reach, max(edges[q + 1] - edges[q] for q in range(w)))
    slabs: List[torch.Tensor] = []
    if reach:
        # each rank's first and last min(reach, rows) rows, padded to reach
        n = min(reach, hi - lo)
        pad = _fill(x, reach - n, axis, 0.0)
        slab = torch.cat([x.narrow(axis, 0, n), pad,
                          x.narrow(axis, hi - lo - n, n), pad], axis)
        slabs = distributed.all_gather_tensor(slab)
    parts = []
    if a < 0:
        parts.append(_fill(x, min(b, 0) - a, axis, fill))
    for q in range(w):
        s, e = max(a, edges[q], 0), min(b, edges[q + 1], h)
        if s >= e:
            continue
        if q == r:
            parts.append(x.narrow(axis, s - lo, e - s))
        elif q < r:  # q's last n rows sit at [reach, reach + n) of its slab
            n = min(reach, edges[q + 1] - edges[q])
            parts.append(slabs[q].narrow(
                axis, reach + n - (edges[q + 1] - s), e - s))
        else:
            parts.append(slabs[q].narrow(axis, s - edges[q], e - s))
    if b > h:
        parts.append(_fill(x, b - max(a, h), axis, fill))
    out = torch.cat(parts, axis) if len(parts) > 1 else parts[0]
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


Pad = Union[int, Tuple[int, int]]


def pad_rows(x: torch.Tensor, kernel: int, stride: int, pad: Pad,
             fill: float = 0.0, axis: int = 2
             ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The rows that a window op of ``kernel`` rows (dilation included) at
    ``stride``, padded by ``pad`` rows above and below (or by ``(top,
    bottom)``), reads for this rank's output rows, and the row padding the
    op still applies itself, always as ``(top, bottom)``.

    With no height shard active, or no padding (a VALID op reads its own
    stripe's rows, or the rows padded for it): ``(x, (top, bottom))``.
    Under a shard: ``(rows, (0, 0))``, the image's edges filled with
    ``fill`` and the rows between stripes the other ranks'. A stride-2
    op must see every stripe start on an even row, and its output must be
    the next level's map; the stride rule of ``mesh.height_shard`` makes
    both hold, and this asserts them."""
    top, bottom = (pad, pad) if isinstance(pad, int) else pad
    shard = mesh.current_height_shard()
    if shard is None or not (top or bottom):
        return x, (top, bottom)
    s = shard.level(x.shape[axis])
    edges, out = shard.bounds_at(s), shard.bounds_at(s * stride)
    n_out = (edges[-1] + top + bottom - kernel) // stride + 1
    if n_out != out[-1] or any(b % stride for b in edges[:-1]):
        raise AssertionError(
            f"a {kernel}-row window at stride {stride} over stripes "
            f"{edges} gives {n_out} rows, not the stripes {out}")
    needs = [(out[q] * stride - top, (out[q + 1] - 1) * stride - top + kernel)
             for q in range(len(edges) - 1)]
    return fetch_rows(x, needs, fill, axis), (0, 0)


def stripe(x: torch.Tensor, rows: int, axis: int = 2) -> torch.Tensor:
    """This rank's rows of ``x``, a whole map whose stripe here has
    ``rows`` rows on axis ``axis``; ``x`` itself with no height shard."""
    edges, r = bounds(rows)
    return x.narrow(axis, edges[r], edges[r + 1] - edges[r])


def mean(x: torch.Tensor, dims: Tuple[int, ...], axis: int,
         keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dims)``, ``dims`` holding the row axis ``axis``; under a
    height shard the stripes' f64 sums added over the ranks and divided by
    the whole map's count, in ``x``'s dtype."""
    if mesh.current_height_shard() is None:
        return x.mean(dims, keepdim=keepdim)
    count = bounds(x.shape[axis])[0][-1] * math.prod(
        x.shape[d] for d in dims if d != axis)
    total = distributed.sum_over_ranks(x.double().sum(dims, keepdim=keepdim))
    return (total / count).to(x.dtype)


def gather_rows(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """The whole map, on every rank, from every rank's stripe ``x``."""
    edges, _ = bounds(x.shape[axis])
    rows = [edges[q + 1] - edges[q] for q in range(len(edges) - 1)]
    top = max(rows)
    parts = distributed.all_gather_tensor(
        torch.cat([x, _fill(x, top - x.shape[axis], axis, 0.0)], axis))
    return torch.cat([p.narrow(axis, 0, n) for p, n in zip(parts, rows)],
                     axis)
