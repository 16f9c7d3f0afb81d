"""Train and eval steps.

Counterpart of ``pixelpick_tpu/engine/trainer.py``:

- :func:`sparse_ce_and_hist`: cross-entropy and confusion matrix at the
  labelled pixels only. The head's logits stay at 1/4 resolution and their
  align-corners interpolation is evaluated at the labelled coordinates
  (``ops/resize.py``), which by linearity equals the reference's
  upsample-then-masked-CE (``model.py:108-116``);
- :func:`make_train_step`: forward in train mode (``upsample=False``), loss,
  backward, optimizer update (``make_train_step``/``_jit_step``,
  ``trainer.py:125-133, 210-226``). The loss and the confusion matrix stay on
  the device; nothing syncs the host per step;
- :func:`make_microbatch_train_step`: sequential bs-M updates over one
  megabatch uploaded once (``trainer.py:136-227``), the reference's bs-M
  schedule at a larger loader batch;
- :func:`make_dense_train_step`: the fully supervised step, cross-entropy
  over the full-resolution label map (``trainer.py:229-255``), under the
  sparse step's wrapper;
- :func:`make_eval_step`: full-resolution argmax and confusion matrix, and
  one image's visualisation maps (``trainer.py:256-293``).

On one CUDA card and process, outside a shard, each input signature of a
train or eval step becomes a CUDA graph, captured at its first call and
replayed after it (:class:`_Graphs`); elsewhere the steps run eagerly.

Data parallelism (``parallel/mesh.py``): a step given a ``shard`` holds
that rank's rows of the global batch. The loss divides by the global valid
count, the gradients are summed over the ranks once per update (one flat
buffer) before the optimizer adds its weight decay, and the loss and the
confusion matrix returned are the global batch's. Averaging per-rank mean
losses, ``DistributedDataParallel``'s rule, would be wrong whenever the
ranks' valid counts differ (remainder pads, void pixels, human labels).
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Callable, Optional

import torch

from pixelpick_tpu_torch.ops import depthwise, fused_ir
from pixelpick_tpu_torch.ops.resize import (
    gather_bilinear_align_corners, gather_bilinear_matmul,
    resize_align_corners,
)
from pixelpick_tpu_torch.ops.uncertainty import vis_maps
from pixelpick_tpu_torch.parallel import distributed, mesh
from pixelpick_tpu_torch.utils.metrics import confusion_matrix
from pixelpick_tpu_torch.utils.profiling import allocator_calls, count, span

# the batch keys the sparse train step reads
SPARSE_KEYS = ("x", "coords", "labels", "valid")


@lru_cache(maxsize=None)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A small f32 tensor on ``device``, uploaded once: a blocking upload
    waits for the device, a stall per step. Callers must not write to it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize_images(x_uint8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> normalised f32 (torchvision to_tensor + Normalize)."""
    mean = _constant(tuple(float(v) for v in mean), x_uint8.device)
    std = _constant(tuple(float(v) for v in std), x_uint8.device)
    return (x_uint8.float() / 255.0 - mean) / std


def sparse_ce_and_hist(logits_lr, coords, labels, valid, full_hw,
                       n_classes: int, gather_impl: str = "matmul"):
    """Cross-entropy and (n, n) confusion matrix at sparse coordinates.

    logits_lr: (B, h, w, C) low-resolution logits; coords (B, K, 2) int
    full-resolution (y, x), padding arbitrary; labels (B, K); valid (B, K)
    bool, False on padding and on void-labelled picks (CE ``ignore_index``).
    gather_impl: 'matmul' (one-hot selection products) or 'gather'."""
    if tuple(logits_lr.shape[1:3]) == tuple(full_hw):
        bsz, _, w_full, c = logits_lr.shape
        idx = (coords[..., 0] * w_full + coords[..., 1]).long()
        logits = torch.gather(logits_lr.reshape(bsz, -1, c), 1,
                              idx[..., None].expand(-1, -1, c))
    else:
        gather = gather_bilinear_matmul if gather_impl == "matmul" \
            else gather_bilinear_align_corners
        logits = gather(logits_lr, coords, full_hw)
    logits = logits.float()
    logp = torch.log_softmax(logits, -1)
    safe = labels.long().clamp(0, n_classes - 1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    validf = valid.float()
    # under a row shard, the global batch's count (trainer.py:55-83)
    n_valid = mesh.reduce_sum(validf.sum()).clamp(min=1)
    loss = -(ll * validf).sum() / n_valid
    hist = confusion_matrix(torch.where(valid, labels.long(),
                                        torch.full_like(labels.long(), -1)),
                            logits.argmax(-1), n_classes)
    return loss, hist


def batch_to_device(batch: dict, device) -> dict:
    """Host NumPy batch -> device tensors (uint8 images stay uint8)."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _backward(model, optimizer, loss, shard) -> None:
    """``zero_grad`` and the backward; under a row shard the gradients
    are summed over the ranks, so the weight decay the optimizer adds to
    them is counted once."""
    with span("train.backward"):
        optimizer.zero_grad()
        loss.backward()
        if shard is not None:
            mesh.all_reduce_grads(model.parameters())


def _train_step(model, optimizer, update, keys) -> Callable:
    """The train step around ``update(batch, shard)``, the device work of
    one optimizer update (forward, loss and confusion matrix, backward,
    ``optimizer.apply``), which returns the rank's (loss, hist). Around it
    the ``train.step`` span, ``allocator_calls`` and the row shard; the
    host fills the optimizer's scalars for its update count before it and
    advances the count after. Eagerly the loss and the confusion matrix
    are summed over the ranks. Where :func:`graphable` holds and no shard
    is given, the update is replayed from a CUDA graph per signature of
    the batch's tensors ``keys`` and the model's dropout generators
    (:class:`_Graphs`), the same work as the eager step's; the parameters'
    ``grad`` then hold the graph's gradients, as after an eager step."""
    params = [p for _, ps in optimizer.groups for p in ps]

    def graphed(batch):  # what a graph captures, its gradients included
        loss, hist = update(batch)
        return loss, hist, [p.grad for p in params]

    graphs = _Graphs("train", keys, graphed, _dropout_generators(model),
                     replay_span="train.replay")

    def train_step(batch, shard=None):
        model.train()
        with span("train.step"), allocator_calls(batch["x"].device), \
                mesh.sharded(shard):
            optimizer.prepare()
            graph = graphs.get(batch, shard)
            if graph is None:
                loss, hist = update(batch, shard)
                loss = mesh.reduce_sum(loss.clone())
                hist = mesh.reduce_sum(hist)
            else:
                loss, hist, grads = graph(batch)
                for p, g in zip(params, grads):
                    p.grad = g
            optimizer.step_count += 1
            return loss, hist

    return train_step


def make_train_step(model, optimizer, *, n_classes: int, mean, std,
                    normalize: bool = True,
                    gather_impl: str = "matmul") -> Callable:
    """Sparse-label train step. batch (device tensors): x uint8 (B, H, W, 3),
    or with ``normalize=False`` the normalised f32 of the device pipeline
    (``data/device_pipeline.py``; ``trainer.py:125-133``), coords (B, K, 2),
    labels (B, K), valid (B, K); with ``shard`` (``parallel/mesh.py:
    RowShard``) this rank's rows of the global batch. Returns (loss, hist)
    of the global batch, both on the device and owned by the caller. The
    update runs eagerly or as a graph as :func:`_train_step` says."""

    def update(batch, shard=None):
        with span("train.forward"):
            x = normalize_images(batch["x"], mean, std) if normalize \
                else batch["x"]
            out = model(x, upsample=False)
            loss, hist = sparse_ce_and_hist(
                out["pred"], batch["coords"], batch["labels"],
                batch["valid"], batch["x"].shape[1:3], n_classes,
                gather_impl=gather_impl)
        _backward(model, optimizer, loss, shard)
        with span("train.optimizer"):
            optimizer.apply()
        return loss.detach(), hist

    return _train_step(model, optimizer, update, SPARSE_KEYS)


def make_microbatch_train_step(model, optimizer, *, micro_bs: int,
                               n_classes: int, mean, std,
                               normalize: bool = True,
                               gather_impl: str = "matmul") -> Callable:
    """Megabatch step: ``B // micro_bs`` sequential bs-``micro_bs`` updates,
    each :func:`make_train_step`'s body on rows ``[m*M, (m+1)*M)``.

    ``train_step(batch)`` takes the HOST batch (NumPy, the sparse keys of
    :func:`make_train_step`, B a multiple of ``micro_bs``; the driver pads a
    remainder with ``parallel/mesh.py:pad_batch_to_devices``), uploads it
    once and returns ``(losses (n_micro,), hist summed)`` on the device. A
    device pipeline's batch (``data/device_pipeline.py:sample_batch``,
    already on the device, padded there, with ``normalize=False``) is used
    as it is.

    As the JAX scan: the same update count, sample order, per-update
    BatchNorm moments, optimizer and schedule stepping and dropout draws
    (from the model's generator, once per update, in update order) as
    ``n_micro`` separate bs-``micro_bs`` steps. Pad rows join the final
    micro-batch's BatchNorm moments (``trainer.py:155-158``). A
    micro-batch with no valid entry is a true no-op: no forward (the
    running statistics stay), no optimizer step (its count, the schedule
    and the moments stay), and NaN in its loss slot, which the driver's
    epoch mean skips. That is decided from the host copy of ``valid``, so
    nothing syncs the device per micro-batch. A device batch has no host
    copy of ``valid``: its ``rows_real`` (which rows hold a valid pick) is
    copied to the host as the batch is drawn and read once per megabatch;
    a real micro-batch whose crops kept no labelled pixel is a no-op too,
    as JAX's scan makes it (``trainer.py:197-201``)."""
    step = make_train_step(model, optimizer, n_classes=n_classes, mean=mean,
                           std=std, normalize=normalize,
                           gather_impl=gather_impl)

    def train_step(batch):
        device = next(model.parameters()).device
        b = batch.get("global_rows", batch["x"].shape[0])
        if b % micro_bs:
            raise ValueError(f"a megabatch of {b} rows is not a multiple of "
                             f"the micro-batch size {micro_bs}")
        # under data parallelism each micro-batch is sharded on its own
        pos, shard = mesh.megabatch_rows(b, micro_bs)
        if "rows_real" in batch:  # a device batch holds this rank's rows
            rows = mesh.gather_rows(batch["rows_real"].get(), pos, b)
            dev = {k: batch[k] for k in SPARSE_KEYS}
        else:
            rows = batch["valid"].any(1)
            with span("train.upload"):
                dev = batch_to_device(batch if pos is None else
                                      {k: v[pos] for k, v in batch.items()},
                                      device)
        # every rank decides the no-ops from the global batch's flags
        any_real = rows.reshape(b // micro_bs, -1).any(1)
        per = micro_bs if shard is None else shard.hi - shard.lo
        losses = []
        hist = torch.zeros((n_classes, n_classes), dtype=torch.long,
                           device=device)
        for m, real in enumerate(any_real):
            if not real:
                losses.append(torch.full((), float("nan"), device=device))
                continue
            rows = slice(m * per, (m + 1) * per)
            loss, h = step({k: v[rows] for k, v in dev.items()}, shard)
            losses.append(loss)
            hist = hist + h
        return torch.stack(losses), hist

    return train_step


def make_dense_train_step(model, optimizer, *, n_classes: int,
                          ignore_index: int, mean, std) -> Callable:
    """Fully supervised train step (``n_pixels_by_us == 0``; reference
    ``model.py:108-126``): batch keys x uint8 (B, H, W, 3) and y int
    (B, H, W). The train-mode logits, in f32, resized align-corners to the
    full resolution; the mean log-softmax cross-entropy over the pixels
    with ``y != ignore_index`` and ``0 <= y < n_classes``, divided by
    max(their count, 1); the full-resolution confusion matrix; then the
    optimizer update. JAX calls the model with ``upsample=True``, which
    also resizes the embedding the loss never reads; here ``pred`` alone
    is resized, so loss and gradients are the same. ``shard``: as
    :func:`make_train_step`, whose wrapper (:func:`_train_step`) this
    update runs under. Returns (loss, hist) of the global batch on the
    device."""

    def update(batch, shard=None):
        with span("train.forward"):
            x = normalize_images(batch["x"], mean, std)
            logits = model(x, upsample=False)["pred"].float()
            if logits.shape[1:3] != x.shape[1:3]:
                logits = resize_align_corners(logits, x.shape[1:3])
            y = batch["y"].long()
            valid = (y != ignore_index) & (y >= 0) & (y < n_classes)
            logp = torch.log_softmax(logits, -1)
            ll = torch.gather(logp, -1, y.clamp(0, n_classes - 1)[..., None])
            validf = valid.float()
            n_valid = mesh.reduce_sum(validf.sum()).clamp(min=1)
            loss = -(ll[..., 0] * validf).sum() / n_valid
            hist = confusion_matrix(
                torch.where(valid, y, torch.full_like(y, -1)),
                logits.argmax(-1), n_classes)
        _backward(model, optimizer, loss, shard)
        with span("train.optimizer"):
            optimizer.apply()
        return loss.detach(), hist

    return _train_step(model, optimizer, update, ("x", "y"))


def graphable(device: torch.device) -> bool:
    """Whether a train or eval step on ``device`` may run as CUDA graphs: a
    CUDA card in a single process outside a height shard. The collectives
    of data parallelism and the halo exchanges of a height shard stay
    eager."""
    return device.type == "cuda" and distributed.world_size() == 1 \
        and mesh.current_height_shard() is None


def _dropout_generators(model) -> Callable[[], tuple]:
    """A function that gives the CUDA generators the model's dropouts draw
    from besides a default one, which a graph must register; read at each
    step, since ``set_dropout_generator`` may replace them."""
    drawers = [m for m in model.modules() if hasattr(m, "generator")]

    def generators() -> tuple:
        found = {}
        for m in drawers:
            g = m.generator
            if g is not None and g.device.type == "cuda" and all(
                    g is not d for d in torch.cuda.default_generators):
                found[id(g)] = g
        return tuple(found.values())

    return generators


# the hand kernels' launch counters, which a replay adds to
_LAUNCH_COUNTERS = (depthwise.launch_counts, fused_ir.launch_counts)


class _Captured:
    """``fn(*args)``, a function of fixed tensors, as a CUDA graph. At its
    making ``fn(*warm)`` runs once on ``stream``, the warm-up a capture
    needs (library handles and workspaces are per stream), and its results
    are :attr:`first`, the caller's: every later use of ``stream`` waits
    for the current stream first. Then ``fn(*args)`` is captured there into
    ``pool``. The launch counters keep what the warm-up ran and drop what
    the capture recorded, which ran nothing; each :meth:`replay` adds it
    back. ``generators``: the CUDA generators ``fn`` draws from besides the
    default one; a replay draws from each generator's state at its time
    and advances it as ``fn`` run eagerly would, and the capture leaves
    it as it was."""

    def __init__(self, fn, warm, args, pool, stream, generators=()):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.first = fn(*warm)
        torch.cuda.current_stream().wait_stream(stream)
        before = [dict(c) for c in _LAUNCH_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        # thread_local: the loader's threads may call the CUDA runtime
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.out = fn(*args)
        self.launches = [(c, k, c[k] - b[k])
                         for c, b in zip(_LAUNCH_COUNTERS, before)
                         for k in c if c[k] != b[k]]
        for c, k, n in self.launches:
            c[k] -= n

    def replay(self):
        """Run the graph on the current stream; returns the outputs of the
        capture, which the next replay overwrites."""
        self.graph.replay()
        for c, k, n in self.launches:
            c[k] += n
        return self.out


class _Graph:
    """One input signature's step, ``fn(inputs, *extra)``, as a CUDA graph
    (:class:`_Graphs` gives ``fn``). The batch's tensors are copied into
    fixed inputs. The first call captures the step and returns the
    warm-up's results, a real step's; the capture that follows the
    warm-up changes nothing: not the weights, the moments, BatchNorm's
    statistics, a generator's offset or the launch counters. Every later
    call replays it and returns the graph's output tensors cloned, so that
    a caller may keep them across later calls, and a list among the
    outputs as the graph's own tensors (the train step's gradients, the
    eval step's logits), which the next replay overwrites. Counts ``<kind>_graph_captures`` or
    ``<kind>_graph_replays`` by how it ran."""

    def __init__(self, graphs, batch, extra, generators):
        # not ``graphs`` itself: through a cycle a dropped step's graphs
        # would wait for the cycle collector, which may run while another
        # graph is captured, where freeing a CUDA graph is not permitted
        self.kind, self.fn, self.replay_span = \
            graphs.kind, graphs.fn, graphs.replay_span
        self.pool, self.stream = graphs.pool, graphs.stream
        self.extra, self.generators = extra, generators
        self.inputs = {k: torch.empty_like(batch[k]) for k in graphs.keys}
        self.captured = None

    def __call__(self, batch):
        if self.captured is None:
            count(f"{self.kind}_graph_captures")
            self._fill(batch)
            args = (self.inputs, *self.extra)
            self.captured = _Captured(self.fn, args, args, self.pool,
                                      self.stream, self.generators)
            # the caller's alone: the graph keeps none of the warm-up's
            first, self.captured.first = self.captured.first, None
            return first
        count(f"{self.kind}_graph_replays")
        with span(self.replay_span) if self.replay_span \
                else contextlib.nullcontext():
            self._fill(batch)
            return tuple(t.clone() if isinstance(t, torch.Tensor) else t
                         for t in self.captured.replay())

    def _fill(self, batch):
        for k, v in self.inputs.items():
            v.copy_(batch[k])


class _Graphs:
    """The CUDA graphs of one step, by input signature: the name, shape and
    dtype of each of the batch's tensors ``keys``, the arguments ``extra``
    the step takes besides them, and the CUDA generators
    ``generators()`` gives, which the step draws from besides the default
    one (a graph holds the ones it was captured with). ``fn(inputs,
    *extra)`` is the step's device work, returning a tuple. The graphs
    never run at once, so they share one memory pool and one side stream,
    made with the first; the parameters, buffers and optimizer moments are
    read and written where they lie, so a replay sees what changed in
    place since the capture. A step that runs eagerly counts one
    ``<kind>_eager_steps``; ``replay_span`` names a span around each
    replay."""

    def __init__(self, kind: str, keys, fn, generators=lambda: (),
                 replay_span: Optional[str] = None):
        self.kind, self.keys, self.fn = kind, keys, fn
        self.generators, self.replay_span = generators, replay_span
        self.graphs = {}
        self.pool = self.stream = None

    def get(self, batch, shard, extra: tuple = ()) -> Optional[_Graph]:
        """The graph to run this step with, or None to run it eagerly:
        under a row shard or where :func:`graphable` does not hold."""
        if shard is not None or not graphable(batch["x"].device):
            count(f"{self.kind}_eager_steps")
            return None
        generators = self.generators()
        key = (tuple((k, tuple(batch[k].shape), batch[k].dtype)
                     for k in self.keys), extra, generators)
        graph = self.graphs.get(key)
        if graph is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream()
            graph = self.graphs[key] = _Graph(self, batch, extra, generators)
        return graph


def make_eval_step(model, *, n_classes: int, mean, std) -> Callable:
    """Validation step: full-resolution argmax and device confusion matrix.
    Returns (hist, pred, vis) with ``vis`` the visualisation maps of image
    ``vis_index``, all on the device and owned by the caller. ``valid_hw``
    crops the logits to the unpadded size of an x padded to a stride
    multiple (``trainer.py:256-293``; ``active/driver.py:pad_to_stride``).
    With ``shard`` the batch is this rank's rows and ``hist`` the global
    batch's; ``pred`` and ``vis`` stay the rank's. Where :func:`graphable`
    holds, the forward is replayed from a CUDA graph per signature of x, y
    and ``valid_hw`` (:class:`_Graphs`), and the maps of its logits from a
    graph per ``vis_index`` beside it, the same work as the eager step's."""

    def forward(batch, valid_hw):
        x = normalize_images(batch["x"], mean, std)
        logits = model(x, upsample=False)["pred"].float()
        if logits.shape[1:3] != x.shape[1:3]:
            logits = resize_align_corners(logits, x.shape[1:3])
        if valid_hw is not None:
            logits = logits[:, :valid_hw[0], :valid_hw[1]]
        pred = logits.argmax(-1)
        # the logits in a list: a replay hands back the graph's own, which
        # the maps' graph reads
        return pred, confusion_matrix(batch["y"], pred, n_classes), [logits]

    graphs = _Graphs("eval", ("x", "y"), forward)
    maps_graphs = {}  # (forward's graph, vis_index) -> the maps' graph

    @torch.no_grad()
    def eval_step(batch, vis_index: int = 0, valid_hw=None, shard=None):
        model.eval()
        hw = None if valid_hw is None else tuple(valid_hw)

        def maps(logits):
            return vis_maps(logits[vis_index:vis_index + 1])

        with span("val.step"):
            graph = graphs.get(batch, shard, (hw,))
            with span("val.forward"):
                if graph is None:
                    pred, hist, (logits,) = forward(batch, hw)
                    with mesh.sharded(shard):
                        hist = mesh.reduce_sum(hist)
                else:
                    pred, hist, (logits,) = graph(batch)
            with span("val.vis"):
                if graph is None:
                    vis = maps(logits)
                elif (graph, vis_index) in maps_graphs:
                    vis = {k: v.clone() for k, v in
                           maps_graphs[graph, vis_index].replay().items()}
                else:
                    own = graph.captured.out[2][0]  # the graph's logits
                    captured = maps_graphs[graph, vis_index] = _Captured(
                        maps, (logits,), (own,), graphs.pool, graphs.stream)
                    vis = captured.first
        return hist, pred, vis

    return eval_step
