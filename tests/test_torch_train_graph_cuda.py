"""The CUDA graphs of the sparse and the dense train step
(``engine/trainer.py:_Graphs``) on a CUDA card, against the same step run
eagerly. The card cases skip without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph_cuda.py

A graphed step captures a signature's update at its first call, which
returns the warm-up's real update, and replays it after that. Two twins,
one stepped eagerly (``graphable`` false) and one graphed, from the same
weights, optimizer and dropout stream, take the same batches; after every
update the weights, BatchNorm's running statistics and update counts, the
parameters' gradients, the optimizer's moments and update count, the
dropout generator's offset, the loss and the confusion matrix must be
bit-equal: a replay runs the same
kernels on the same data, draws the same masks from the same (seed,
offset), and adds what the eager step adds to the hand kernels' launch
counters. cuDNN is held to its deterministic algorithms here (``card``):
with its default ones the eager step is not bit-reproducible itself. The cases: the dilated ResNet-50 FPN at width 0.25 (SGD, no
dropout) and DeepLabv3+ on MobileNetV2 at width 0.5 with ``--fused_ir
--pallas_dw`` (Adam, the ASPP's and the head's dropouts on), each with
the sparse step and the dense one (a full label map, some pixels
ignored), batch 2 and
a remainder batch of 1, which takes a graph of its own; a reset in place,
as the benchmark resets between set-up and its window, which the
replays then repeat bit for bit. Under a row shard, with more than one
rank, or on the CPU the step runs eagerly and counts
``train_eager_steps``; the CPU cases, sparse and dense, run here without
a card too.
"""

import socket

import numpy as np
import pytest
import torch

N_UPDATES = 3
CASES = {
    # dataset, model flags, image size
    "fpn": ("voc", dict(network_name="FPN", n_layers=50,
                        use_dilated_resnet=True, width_multiplier=0.25),
            (64, 64)),
    "deeplab_kernels": ("cv", dict(width_multiplier=0.5, fused_ir=True,
                                   pallas_dw=True), (96, 128)),
}


@pytest.fixture
def card():
    """The card, with cuDNN held to its deterministic algorithms for the
    test: with its default ones two eager runs of the same update already
    differ in the last bits of the first convolution's gradient, and bit
    equality is then no test of the graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cudnn.deterministic = before
        from pixelpick_tpu_torch.models import layers
        layers.set_depthwise_impl("xla")


@pytest.fixture
def tracer():
    from pixelpick_tpu_torch.utils import profiling

    profiling.clear()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.clear()


def _batch(rng, n: int, hw, n_classes: int, device, k: int = 12) -> dict:
    """``n`` rows of distinct content and ``k`` picks each, one of them
    void (not valid)."""
    mosaic = np.kron(rng.uniform(-1, 1, (n, -(-hw[0] // 16),
                                         -(-hw[1] // 16), 3)),
                     np.ones((1, 16, 16, 1)))[:, :hw[0], :hw[1]]
    img = rng.uniform(30, 120, (n, 1, 1, 3)) * mosaic \
        + rng.uniform(60, 200, (n, 1, 1, 3)) + rng.normal(0, 10, mosaic.shape)
    valid = np.ones((n, k), dtype=bool)
    valid[:, -1] = False
    host = {"x": np.clip(img, 0, 255).astype(np.uint8),
            "coords": np.stack([rng.integers(0, hw[0], (n, k)),
                                rng.integers(0, hw[1], (n, k))],
                               -1).astype(np.int32),
            "labels": rng.integers(0, n_classes, (n, k)).astype(np.int32),
            "valid": valid}
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def _dense_batch(rng, n: int, hw, args, device) -> dict:
    """:func:`_batch`'s images with a full label map, a tenth of its pixels
    the ignore index."""
    y = rng.integers(0, args.n_classes, (n, *hw))
    y[rng.random((n, *hw)) < 0.1] = args.ignore_index
    return {"x": _batch(rng, n, hw, args.n_classes, device)["x"],
            "y": torch.from_numpy(y.astype(np.int32)).to(device)}


class _Twin:
    """A model, its optimizer, its dropout stream and its train step."""

    def __init__(self, args, start, device, dropout_seed: int = 99,
                 dense: bool = False):
        from pixelpick_tpu_torch.engine.optim import make_optimizer
        from pixelpick_tpu_torch.engine.trainer import (
            make_dense_train_step, make_train_step,
        )
        from pixelpick_tpu_torch.models.factory import get_model

        self.model = get_model(args, device, seed=7)
        self.model.load_state_dict(start)
        self.opt = make_optimizer(args, self.model, 4)
        self.gen = torch.Generator(device=device)
        self.dropout_seed = dropout_seed
        self.gen.manual_seed(dropout_seed)
        self.model.set_dropout_generator(self.gen)
        kw = dict(n_classes=args.n_classes, mean=args.mean, std=args.std)
        self.step = make_dense_train_step(
            self.model, self.opt, ignore_index=args.ignore_index, **kw) \
            if dense else make_train_step(self.model, self.opt, **kw)

    def eager(self, batch, shard=None):
        from pixelpick_tpu_torch.engine import trainer

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trainer, "graphable", lambda device: False)
            return self.step(batch, shard)

    def reset(self, start):
        """As the benchmark's train phase resets: in place."""
        self.model.load_state_dict(start)
        for st in self.opt.state:
            for ts in st.values():
                torch._foreach_zero_(ts)
        self.opt.step_count = 0
        self.gen.manual_seed(self.dropout_seed)

    def state(self):
        return {"model": {k: v.clone()
                          for k, v in self.model.state_dict().items()},
                "moments": [t.clone() for st in self.opt.state
                            for ts in st.values() for t in ts],
                "grads": {n: p.grad.clone()
                          for n, p in self.model.named_parameters()
                          if p.grad is not None},
                "step_count": self.opt.step_count,
                "offset": self.gen.get_offset()}


def _assert_same(a, b, what):
    assert a["step_count"] == b["step_count"], what
    assert a["offset"] == b["offset"], what
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), (what, k)
    assert a["grads"].keys() == b["grads"].keys()
    for k, v in a["grads"].items():
        assert torch.equal(v, b["grads"][k]), (what, "grad", k)
    assert len(a["moments"]) == len(b["moments"])
    for i, (u, v) in enumerate(zip(a["moments"], b["moments"])):
        assert torch.equal(u, v), (what, "moment", i)


def _launches():
    from pixelpick_tpu_torch.ops import depthwise, fused_ir

    return {**{f"dw_{k}": v for k, v in depthwise.launch_counts.items()},
            **{f"fused_{k}": v for k, v in fused_ir.launch_counts.items()}}


def _reset_launches():
    from pixelpick_tpu_torch.ops import depthwise, fused_ir

    depthwise.reset_launch_counts()
    fused_ir.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["sparse", "dense"])
@pytest.mark.parametrize("case", list(CASES))
def test_replays_equal_the_eager_step_bit_for_bit(card, tracer, case, step):
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.models.layers import Dropout

    dataset, flags, hw = CASES[case]
    args = default_args(dataset, device="cuda", **flags)
    start = {k: v.clone()
             for k, v in get_model(args, card, seed=7).state_dict().items()}
    dense = step == "dense"
    eager, graphed = (_Twin(args, start, card, dense=dense)
                      for _ in range(2))
    dropouts = [m for m in graphed.model.modules()
                if isinstance(m, Dropout) and m.p > 0]
    assert bool(dropouts) == (case != "fpn")
    rng = np.random.default_rng(3)
    # three full batches, then a remainder of one row
    batches = [_dense_batch(rng, n, hw, args, card) if dense
               else _batch(rng, n, hw, args.n_classes, card)
               for n in [2] * N_UPDATES + [1]]
    runs = {}
    for name, twin in (("eager", eager), ("graphed", graphed)):
        tracer.clear()
        _reset_launches()
        outs, states = [], []
        for b in batches:
            outs.append(twin.eager(b) if name == "eager" else twin.step(b))
            states.append(twin.state())
        runs[name] = (outs, states, _launches(), tracer.counters())
    assert runs["eager"][3]["train_eager_steps"] == len(batches)
    # one capture per signature (2 rows, then 1), a replay for the other
    # full batches
    counts = runs["graphed"][3]
    assert counts == {"train_graph_captures": 2,
                      "train_graph_replays": N_UPDATES - 1,
                      "allocator_calls": counts["allocator_calls"]}
    launches = {k: v[2] for k, v in runs.items()}
    for i, (a, b) in enumerate(zip(runs["eager"][1], runs["graphed"][1])):
        _assert_same(a, b, (case, "update", i + 1))
    torch.cuda.synchronize()
    assert launches["graphed"] == launches["eager"]
    if case == "deeplab_kernels":
        assert launches["eager"]["fused_fused_fwd"] == 13 * len(batches)
    for (la, ha), (lb, hb) in zip(runs["eager"][0], runs["graphed"][0]):
        # a returned loss is the caller's: later replays leave it alone
        assert torch.equal(la, lb)
        assert torch.equal(ha, hb)
    # the spans: the full batches' replays have train.replay and no
    # forward of their own
    names = [r.name for r in tracer.spans()]
    assert names.count("train.replay") == N_UPDATES - 1
    assert names.count("train.step") == len(batches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_a_reset_in_place_is_replayed_bit_for_bit(card, case):
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models.factory import get_model

    dataset, flags, hw = CASES[case]
    args = default_args(dataset, device="cuda", **flags)
    start = {k: v.clone()
             for k, v in get_model(args, card, seed=7).state_dict().items()}
    twin = _Twin(args, start, card)
    rng = np.random.default_rng(4)
    batches = [_batch(rng, 2, hw, args.n_classes, card)
               for _ in range(N_UPDATES)]
    runs = []
    for _ in range(2):
        twin.reset(start)
        losses = [twin.step(b)[0] for b in batches]  # capture, then replays
        runs.append((twin.state(), torch.stack(losses)))
    _assert_same(runs[0][0], runs[1][0], case)
    assert torch.equal(runs[0][1], runs[1][1])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_a_shard_or_more_ranks_run_eagerly(card, tracer):
    """A row shard (here of a world of one rank over NCCL) and a world of
    more than one rank each run the step eagerly."""
    import torch.distributed as dist

    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.parallel import distributed
    from pixelpick_tpu_torch.parallel.mesh import RowShard

    dataset, flags, hw = CASES["fpn"]
    args = default_args(dataset, device="cuda", **flags)
    start = get_model(args, card, seed=7).state_dict()
    twin = _Twin(args, start, card)
    rng = np.random.default_rng(5)
    b = _batch(rng, 2, hw, args.n_classes, card)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        twin.step(b, RowShard(0, 2, 2))
    finally:
        dist.destroy_process_group()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distributed, "world_size", lambda: 2)
        twin.step(b)
    counts = tracer.counters()
    assert counts["train_eager_steps"] == 2
    assert "train_graph_captures" not in counts
    assert twin.opt.step_count == 2


def test_a_cpu_step_runs_eagerly(tracer):
    """On the CPU every step is eager, with the eager step's spans."""
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models.factory import get_model

    args = default_args("voc", device="cpu", network_name="FPN", n_layers=18,
                        use_dilated_resnet=True, width_multiplier=0.25)
    cpu = torch.device("cpu")
    twin = _Twin(args, get_model(args, cpu, seed=7).state_dict(), cpu)
    rng = np.random.default_rng(6)
    for _ in range(2):
        loss, hist = twin.step(_batch(rng, 2, (32, 32), args.n_classes,
                                      cpu))
        assert bool(torch.isfinite(loss)) and int(hist.sum()) == 2 * 11
    assert tracer.counters() == {"train_eager_steps": 2}
    assert twin.opt.step_count == 2
    names = [r.name for r in tracer.spans()]
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert names.count(name) == 2, name
    assert "train.replay" not in names


def test_a_cpu_dense_step_runs_eagerly(tracer):
    """The dense step on the CPU: eager, counting ``train_eager_steps``,
    with the eager step's spans and the confusion matrix of every pixel
    that is not ignored."""
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models.factory import get_model

    args = default_args("voc", device="cpu", network_name="FPN", n_layers=18,
                        use_dilated_resnet=True, width_multiplier=0.25)
    cpu = torch.device("cpu")
    twin = _Twin(args, get_model(args, cpu, seed=7).state_dict(), cpu,
                 dense=True)
    rng = np.random.default_rng(7)
    for _ in range(2):
        batch = _dense_batch(rng, 2, (32, 32), args, cpu)
        loss, hist = twin.step(batch)
        assert bool(torch.isfinite(loss))
        assert int(hist.sum()) == int((batch["y"] != args.ignore_index).sum())
    assert tracer.counters() == {"train_eager_steps": 2}
    assert twin.opt.step_count == 2
    names = [r.name for r in tracer.spans()]
    for name in ("train.step", "train.forward", "train.backward",
                 "train.optimizer"):
        assert names.count(name) == 2, name
    assert "train.replay" not in names
