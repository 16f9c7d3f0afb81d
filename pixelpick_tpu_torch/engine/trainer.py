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
  the device; nothing syncs the host per step. On one CUDA card each input
  signature's update becomes a CUDA graph, captured at its first call and
  replayed after it (:class:`_TrainGraphs`);
- :func:`make_microbatch_train_step`: sequential bs-M updates over one
  megabatch uploaded once (``trainer.py:136-227``), the reference's bs-M
  schedule at a larger loader batch;
- :func:`make_dense_train_step`: the fully supervised step, cross-entropy
  over the full-resolution label map (``trainer.py:229-255``);
- :func:`make_eval_step`: full-resolution argmax and confusion matrix, and
  one image's visualisation maps (``trainer.py:256-293``). On one CUDA
  card each input signature's step becomes CUDA graphs, captured at its
  first call and replayed after it (:class:`_EvalGraphs`).

Data parallelism (``parallel/mesh.py``): a step given a ``shard`` holds
that rank's rows of the global batch. The loss divides by the global valid
count, the gradients are summed over the ranks once per update (one flat
buffer) before the optimizer adds its weight decay, and the loss and the
confusion matrix returned are the global batch's. Averaging per-rank mean
losses, ``DistributedDataParallel``'s rule, would be wrong whenever the
ranks' valid counts differ (remainder pads, void pixels, human labels).
"""

from __future__ import annotations

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


def make_train_step(model, optimizer, *, n_classes: int, mean, std,
                    normalize: bool = True,
                    gather_impl: str = "matmul") -> Callable:
    """Sparse-label train step. batch (device tensors): x uint8 (B, H, W, 3),
    or with ``normalize=False`` the normalised f32 of the device pipeline
    (``data/device_pipeline.py``; ``trainer.py:125-133``), coords (B, K, 2),
    labels (B, K), valid (B, K); with ``shard`` (``parallel/mesh.py:
    RowShard``) this rank's rows of the global batch. Returns (loss, hist)
    of the global batch, both on the device and owned by the caller.

    The device work of an update is :func:`update` (forward, loss and
    confusion matrix, backward, ``optimizer.apply``); around it the host
    fills the optimizer's scalars for its update count and advances the
    count. Where :func:`graphable` holds and no shard is given, that work
    is replayed from a CUDA graph per input signature
    (:class:`_TrainGraphs`), the same work as the eager step's."""

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

    graphs = _TrainGraphs(model, optimizer, update)

    def train_step(batch, shard=None):
        model.train()
        with span("train.step"), allocator_calls(batch["x"].device), \
                mesh.sharded(shard):
            graph = graphs.get(batch, shard)
            if graph is not None:
                loss, hist = graph(batch)
            else:
                optimizer.prepare()
                loss, hist = update(batch, shard)
                loss = mesh.reduce_sum(loss.clone())
                hist = mesh.reduce_sum(hist)
            optimizer.step_count += 1
            return loss, hist

    return train_step


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
    :func:`make_train_step`. Returns (loss, hist) of the global batch on
    the device."""

    def train_step(batch, shard=None):
        model.train()
        with span("train.step"), allocator_calls(batch["x"].device), \
                mesh.sharded(shard):
            with span("train.forward"):
                x = normalize_images(batch["x"], mean, std)
                logits = model(x, upsample=False)["pred"].float()
                if logits.shape[1:3] != x.shape[1:3]:
                    logits = resize_align_corners(logits, x.shape[1:3])
                y = batch["y"].long()
                valid = (y != ignore_index) & (y >= 0) & (y < n_classes)
                logp = torch.log_softmax(logits, -1)
                ll = torch.gather(logp, -1,
                                  y.clamp(0, n_classes - 1)[..., None])
                validf = valid.float()
                n_valid = mesh.reduce_sum(validf.sum()).clamp(min=1)
                loss = -(ll[..., 0] * validf).sum() / n_valid
                hist = confusion_matrix(
                    torch.where(valid, y, torch.full_like(y, -1)),
                    logits.argmax(-1), n_classes)
            _backward(model, optimizer, loss, shard)
            with span("train.optimizer"):
                optimizer.step()
            return mesh.reduce_sum(loss.detach().clone()), \
                mesh.reduce_sum(hist)

    return train_step


def graphable(device: torch.device) -> bool:
    """Whether a train or eval step on ``device`` may run as CUDA graphs: a
    CUDA card in a single process outside a height shard. The collectives
    of data parallelism and the halo exchanges of a height shard stay
    eager."""
    return device.type == "cuda" and distributed.world_size() == 1 \
        and mesh.current_height_shard() is None


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


class _TrainGraph:
    """One input signature's sparse update, ``fn(batch)`` (forward to
    ``optimizer.apply``), as a CUDA graph captured at the signature's
    first call and replayed after it. The batch is copied into fixed
    input buffers and the step's loss and confusion matrix are cloned out
    of the graph's outputs. The first call returns the warm-up's update,
    a real one; the capture that follows it changes nothing: not the
    weights, the moments, BatchNorm's statistics, the update count, a
    generator's offset or the launch counters. After every call the
    parameters' ``grad`` holds that update's gradients, as after an eager
    step: the graph's own gradient buffers, which it keeps. The caller
    fills the optimizer's scalars and advances its count around each
    call."""

    def __init__(self, batch, fn, optimizer, pool, stream, generators):
        self.inputs = {k: torch.empty_like(batch[k]) for k in SPARSE_KEYS}
        self.fn, self.optimizer = fn, optimizer
        self.pool, self.stream, self.generators = pool, stream, generators
        self.params = [p for _, ps in optimizer.groups for p in ps]
        self.captured = self.grads = None

    def __call__(self, batch):
        if self.captured is None:
            count("train_graph_captures")
            self._fill(batch)
            grads = []  # the warm-up's, then the capture's

            def update(inputs):
                out = self.fn(inputs)
                grads.append([p.grad for p in self.params])
                return out

            self.captured = _Captured(update, (self.inputs,),
                                      (self.inputs,), self.pool,
                                      self.stream, self.generators)
            warm, self.grads = grads
            for g, w in zip(self.grads, warm):
                if g is not None:
                    g.copy_(w)
            return self.captured.first
        count("train_graph_replays")
        with span("train.replay"):
            self._fill(batch)
            loss, hist = self.captured.replay()
            for p, g in zip(self.params, self.grads):
                p.grad = g
            return loss.clone(), hist.clone()

    def _fill(self, batch):
        for k, v in self.inputs.items():
            v.copy_(batch[k])
        self.optimizer.prepare()


class _TrainGraphs:
    """The CUDA graphs of one sparse train step, by input signature: the
    shape and dtype of each of the batch's :data:`SPARSE_KEYS`, and the
    generators the model's dropouts draw from (a graph holds the ones it
    was captured with). The graphs never run at once, so they share one
    memory pool; the parameters, buffers and optimizer moments are read
    and written where they lie, so a replay sees what changed in place
    since the capture. A step that runs eagerly counts one
    ``train_eager_steps``."""

    def __init__(self, model, optimizer, fn):
        self.optimizer, self.fn = optimizer, fn
        # the modules that draw from a generator of their own (dropouts)
        self.drawers = [m for m in model.modules()
                        if hasattr(m, "generator")]
        self.graphs = {}
        self.pool = self.stream = None

    def _generators(self, device) -> tuple:
        """The CUDA generators the model draws from besides ``device``'s
        default one."""
        default = torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
        found = {}
        for m in self.drawers:
            g = m.generator
            if isinstance(g, torch.Generator) and g.device.type == "cuda" \
                    and g is not default:
                found[id(g)] = g
        return tuple(found.values())

    def get(self, batch, shard) -> Optional[_TrainGraph]:
        """The graph to run this step with, or None to run it eagerly."""
        device = batch["x"].device
        if shard is not None or not graphable(device):
            count("train_eager_steps")
            return None
        generators = self._generators(device)
        key = (tuple((k, tuple(batch[k].shape), batch[k].dtype)
                     for k in SPARSE_KEYS), generators)
        graph = self.graphs.get(key)
        if graph is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream()
            graph = self.graphs[key] = _TrainGraph(
                batch, self.fn, self.optimizer, self.pool, self.stream,
                generators)
        return graph


class _EvalGraph:
    """One input signature's eval step: ``fn``, the forward (normalise to
    confusion matrix), and the visualisation maps of its logits, one graph
    per image index asked for. Each graph is captured at its first call,
    which returns the warm-up's results, and replayed after it. The batch
    is copied into fixed input buffers; a replay's results are cloned out
    of the graph's outputs, so that a caller may keep them across later
    calls. Counts ``eval_graph_captures`` or ``eval_graph_replays`` by how
    the forward ran."""

    def __init__(self, batch, fn, pool, stream):
        self.inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        self.fn, self.pool, self.stream = fn, pool, stream
        self.fwd = None
        self.maps = {}

    def forward(self, batch):
        """(logits, pred, hist) of ``fn(batch)``; the logits, which
        :meth:`vis` reads, are the graph's own after a replay."""
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        if self.fwd is None:
            count("eval_graph_captures")
            self.fwd = _Captured(self.fn, (self.inputs,), (self.inputs,),
                                 self.pool, self.stream)
            return self.fwd.first
        count("eval_graph_replays")
        logits, pred, hist = self.fwd.replay()
        return logits, pred.clone(), hist.clone()

    def vis(self, logits, vis_index: int, fn):
        """``fn(logits)``, the maps of image ``vis_index`` of the logits
        :meth:`forward` returned."""
        graph = self.maps.get(vis_index)
        if graph is None:
            graph = self.maps[vis_index] = _Captured(
                fn, (logits,), (self.fwd.out[0],), self.pool, self.stream)
            return graph.first
        return {k: v.clone() for k, v in graph.replay().items()}


class _EvalGraphs:
    """The CUDA graphs of one eval step, by input signature: the shape and
    dtype of every tensor of the batch and ``valid_hw``. The graphs never
    run at once, so they share one memory pool; the model's parameters and
    buffers are read where they lie, so a replay sees the weights as
    updated in place since the capture. A step that runs eagerly counts
    one ``eval_eager_steps``."""

    def __init__(self):
        self.graphs = {}
        self.pool = self.stream = None

    def get(self, batch, valid_hw, shard, fn) -> Optional[_EvalGraph]:
        """The graph to run this step with, made with ``fn(batch)`` as its
        forward, or None to run it eagerly."""
        if shard is not None or not graphable(batch["x"].device):
            count("eval_eager_steps")
            return None
        key = (tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batch.items())),
               None if valid_hw is None else tuple(valid_hw))
        graph = self.graphs.get(key)
        if graph is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream()
            graph = self.graphs[key] = _EvalGraph(batch, fn, self.pool,
                                                  self.stream)
        return graph


def make_eval_step(model, *, n_classes: int, mean, std) -> Callable:
    """Validation step: full-resolution argmax and device confusion matrix.
    Returns (hist, pred, vis) with ``vis`` the visualisation maps of image
    ``vis_index``, all on the device and owned by the caller. ``valid_hw``
    crops the logits to the unpadded size of an x padded to a stride
    multiple (``trainer.py:256-293``; ``active/driver.py:pad_to_stride``).
    With ``shard`` the batch is this rank's rows and ``hist`` the global
    batch's; ``pred`` and ``vis`` stay the rank's. Where :func:`graphable`
    holds, the device work is replayed from CUDA graphs
    (:class:`_EvalGraphs`), the same work as the eager step's."""

    def forward(batch, valid_hw):
        x = normalize_images(batch["x"], mean, std)
        logits = model(x, upsample=False)["pred"].float()
        if logits.shape[1:3] != x.shape[1:3]:
            logits = resize_align_corners(logits, x.shape[1:3])
        if valid_hw is not None:
            logits = logits[:, :valid_hw[0], :valid_hw[1]]
        pred = logits.argmax(-1)
        return logits, pred, confusion_matrix(batch["y"], pred, n_classes)

    graphs = _EvalGraphs()

    @torch.no_grad()
    def eval_step(batch, vis_index: int = 0, valid_hw=None, shard=None):
        model.eval()
        with span("val.step"):
            graph = graphs.get(batch, valid_hw, shard,
                               lambda b: forward(b, valid_hw))
            with span("val.forward"):
                if graph is None:
                    logits, pred, hist = forward(batch, valid_hw)
                    with mesh.sharded(shard):
                        hist = mesh.reduce_sum(hist)
                else:
                    logits, pred, hist = graph.forward(batch)
            with span("val.vis"):
                def maps(logits):
                    return vis_maps(logits[vis_index:vis_index + 1])
                vis = maps(logits) if graph is None \
                    else graph.vis(logits, vis_index, maps)
        return hist, pred, vis

    return eval_step
