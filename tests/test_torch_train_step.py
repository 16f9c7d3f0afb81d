"""The port's sparse-label train step (engine/trainer.py, engine/optim.py,
the train-mode model) against the JAX package's, at the same weights and
batches: three steps of the whole DeepLab at width 0.5, 48x64, batch 4,
with ``fused_ir`` off and on (the port's fused blocks run the kernels'
plain versions on the CPU; the JAX ones their Pallas kernels in interpret
mode). The JAX side builds ``DeepLab(fused_ir=True)`` directly: its
``get_model`` refuses ``--fused_ir`` under the 8 virtual devices that
tests/conftest.py forces.

Dropout is off on both sides (flax's ``Dropout`` patched to the identity for
the test, the port's dropout modules at p = 0): the two frameworks draw
different masks. The optimizer is SGD, whose update is linear in the
gradient, so the parameters of both sides stay as close as their gradients.

The weights are chosen so that f32 rounding cannot move either side across
a kink or through a cancellation. At random BatchNorm parameters and noise
images the train-mode gradient of this small model is chaotic: a ReLU6 input
within rounding of 0 or 6 takes the other branch under another summation
order, and the fast variance E[x^2] - E[x]^2 cancels where the batch barely
varies. The port against itself with the batch permuted then differs by 10%
in some leaves. So here every BatchNorm has scale in [0.3, 0.6] and bias in
[2.5, 3.5] (its output is more than 4 sigma from 0 and 6; the test checks
that no ReLU input comes within 1e-4 of a kink), every conv's taps sum to
zero over its inputs (a conv of those positive activations is centred), and
the images differ in content (so ASPP's pooled branch varies across the
batch). Measured then: losses within 4e-7, and leaves within 2e-4 of their
own largest |value|.

Tolerances: the loss of each step 1e-5 relative; the confusion matrices
exactly; every parameter gradient of every step within 1e-4 of its own
largest |value| plus 1e-6 of the largest |gradient| of the step (the floor
holds the leaves whose true gradient is zero, a BatchNorm scale or bias whose
output reaches another train-mode BatchNorm through linear maps only, to
their rounding noise); the parameters after three steps within 1e-4 of their
largest three-step move plus 1e-6 of their largest |value|; running
statistics 1e-4 of their largest |value| (at least 1).

The CUDA graphs of the train and eval steps (``engine/trainer.py:_Graphs``)
on the CPU: the eval step stays eager there and returns tensors of its own;
the signature bookkeeping of either step (one graph per signature, the
train step's dropout generators in it) with the capture stubbed; and no
capture with more than one rank, a row shard or a height shard.
``tests/test_torch_{train,eval}_graph_cuda.py`` run the graphs on a card.
"""


from types import SimpleNamespace

import flax.linen
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pixelpick_tpu.engine import optim as jax_optim
from pixelpick_tpu.engine import trainer as jax_trainer
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.engine import optim, trainer
from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.models.deeplab import DeepLab
from torch_helpers import (
    BS, HW, N_CLASSES, jax_deeplab_variables, record_kink_margins,
    sgd_args, sparse_batches, well_conditioned,
)

WIDTH = 0.5
MEAN, STD = (0.41, 0.43, 0.44), (0.28, 0.29, 0.29)
ITERS = 5


@pytest.fixture(scope="module")
def variables():
    return jax_deeplab_variables(N_CLASSES, WIDTH, HW, seed=2)


def _run_jax(params, stats, batches, fused, monkeypatch):
    """The JAX step (``make_train_step``'s loss closure, its gradient and
    the optax update, as ``_jit_step``), keeping each step's gradients."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    model = JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH, fused_ir=fused)
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)
    tx = jax_optim.make_optimizer(sgd_args(), params, ITERS)
    loss_fn = jax_trainer._sparse_loss_fn(
        model, n_classes=N_CLASSES, mean=MEAN, std=STD, normalize=True,
        gather_impl="matmul")
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    opt_state = tx.init(params)
    steps = []
    for b in batches:
        (loss, (stats, hist)), grads = grad_fn(
            params, stats, jax.tree.map(jnp.asarray, b),
            jax.random.PRNGKey(0))
        steps.append((float(loss), np.asarray(hist), state_dict_from_jax(
            jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, stats))))
        params, opt_state = update(params, opt_state, grads)
    return steps, state_dict_from_jax(jax.tree.map(np.asarray, params),
                                      jax.tree.map(np.asarray, stats))


def _port_model(params, stats, fused):
    model = DeepLab(N_CLASSES, width_mult=WIDTH, fused_ir=fused)
    model.load_state_dict(state_dict_from_jax(params, stats))
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    return model.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("fused", [False, True])
def test_three_train_steps_match_jax(variables, fused, monkeypatch):
    params, stats = variables
    params = well_conditioned(params, np.random.default_rng(102))
    batches = sparse_batches(3)
    steps_j, final_j = _run_jax(params, stats, batches, fused, monkeypatch)

    model = _port_model(params, stats, fused)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    args = default_args(device="cpu")
    args.optimizer_type = "SGD"
    args.optimizer_params = sgd_args().optimizer_params
    opt = optim.make_optimizer(args, model, ITERS)
    step = trainer.make_train_step(model, opt, n_classes=N_CLASSES,
                                   mean=MEAN, std=STD)
    margins = record_kink_margins(monkeypatch)
    for i, (b, (loss_j, hist_j, grads_j)) in enumerate(zip(batches, steps_j)):
        margins.clear()
        loss, hist = step(trainer.batch_to_device(b, "cpu"))
        assert min(margins) > 1e-4, f"step {i}: a ReLU input is near a kink"
        assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j), i
        np.testing.assert_array_equal(hist.numpy(), hist_j)
        grads = {n: p.grad for n, p in model.named_parameters()}
        gmax = max(float(grads_j[n].abs().max()) for n in grads)
        for n, g in grads.items():
            ref = grads_j[n]
            got = torch.zeros_like(ref) if g is None else g.float()
            err = float((got - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max()) + 1e-6 * gmax
            assert err <= tol, f"step {i} grad {n}: {err} > {tol}"
    assert sum(isinstance(m, fused_ir_block_type()) for m in model.modules()) \
        == (13 if fused else 0)

    sd = model.state_dict()
    for k, ref in final_j.items():
        got = sd[k].float()
        if k.endswith("num_batches_tracked"):
            assert int(got) == 3, k
            continue
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-4 * max(float(ref.abs().max()), 1.0)
        else:
            moved = float((ref - start[k]).abs().max())
            tol = 1e-4 * moved + 1e-6 * float(ref.abs().max())
        err = float((got - ref).abs().max())
        assert err <= tol, f"{k}: {err} > {tol}"


def fused_ir_block_type():
    from pixelpick_tpu_torch.models.fused_block import FusedIRBlock
    return FusedIRBlock


@pytest.mark.parametrize("gather_impl", ["matmul", "gather"])
def test_sparse_ce_and_hist_matches_jax(gather_impl):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((BS, 12, 16, N_CLASSES)).astype(np.float32)
    b = sparse_batches(1, seed=4)[0]
    b["labels"][:, 1] = 11  # void picks: kept, not valid
    b["valid"][:, 1] = False
    loss_j, hist_j = jax_trainer.sparse_ce_and_hist(
        jnp.asarray(logits), jnp.asarray(b["coords"]),
        jnp.asarray(b["labels"]), jnp.asarray(b["valid"]), HW, N_CLASSES,
        gather_impl=gather_impl)
    lt = torch.from_numpy(logits).requires_grad_()
    loss, hist = trainer.sparse_ce_and_hist(
        lt, torch.from_numpy(b["coords"]), torch.from_numpy(b["labels"]),
        torch.from_numpy(b["valid"]), HW, N_CLASSES, gather_impl=gather_impl)
    assert abs(float(loss) - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(hist_j))
    # and its gradient, which the train step takes
    g_j = jax.grad(lambda t: jax_trainer.sparse_ce_and_hist(
        t, jnp.asarray(b["coords"]), jnp.asarray(b["labels"]),
        jnp.asarray(b["valid"]), HW, N_CLASSES, gather_impl=gather_impl)[0])(
        jnp.asarray(logits))
    loss.backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-6 * float(np.abs(g_j).max()))


def test_eval_step_matches_jax(variables):
    """Full-resolution argmax and confusion matrix of a val batch, and the
    visualisation maps of image 0."""
    params, stats = variables
    rng = np.random.default_rng(5)
    batch = {"x": rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8),
             "y": rng.integers(0, N_CLASSES + 1, (2, *HW)).astype(np.int32)}
    model = JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH)
    step_j = jax_trainer.make_eval_step(model, n_classes=N_CLASSES,
                                        mean=MEAN, std=STD)
    hist_j, pred_j, vis_j = step_j(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        jax.tree.map(jnp.asarray, batch))
    port = _port_model(params, stats, False)
    step = trainer.make_eval_step(port, n_classes=N_CLASSES, mean=MEAN,
                                  std=STD)
    hist, pred, vis = step(trainer.batch_to_device(batch, "cpu"))
    assert not port.training
    np.testing.assert_array_equal(pred.numpy(), np.asarray(pred_j))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(hist_j))
    for k, v in vis_j.items():
        v = np.asarray(v, np.float32)
        np.testing.assert_allclose(vis[k].float().numpy(), v, rtol=0,
                                   atol=1e-4 * max(np.abs(v).max(), 1.0),
                                   err_msg=k)


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


def test_eval_step_stays_eager_on_the_cpu(variables, tracer):
    """No CUDA graph on the CPU: every step runs eagerly, and two calls on
    the same batch return tensors that share no storage, so a caller may
    keep one call's results across the next."""
    params, stats = variables
    rng = np.random.default_rng(6)
    batch = trainer.batch_to_device(
        {"x": rng.integers(0, 256, (1, *HW, 3), dtype=np.uint8),
         "y": rng.integers(0, N_CLASSES + 1, (1, *HW)).astype(np.int32)},
        "cpu")
    step = trainer.make_eval_step(_port_model(params, stats, False),
                                  n_classes=N_CLASSES, mean=MEAN, std=STD)
    calls = [step(batch) for _ in range(3)]
    assert _counters("eval") == {"eager_steps": 3, "graph_captures": 0,
                                 "graph_replays": 0}
    (hist0, pred0, vis0), (hist1, pred1, vis1) = calls[:2]
    first = [hist0, pred0, *vis0.values()]
    second = [hist1, pred1, *vis1.values()]
    ptrs = {t.untyped_storage().data_ptr() for t in first}
    assert not ptrs & {t.untyped_storage().data_ptr() for t in second}
    np.testing.assert_array_equal(hist0.numpy(), hist1.numpy())
    np.testing.assert_array_equal(pred0.numpy(), pred1.numpy())


def _fake_cuda_batch(hw, keys=("x", "y")):
    """Stands for a batch on a CUDA card: the graphs' bookkeeping reads
    only each tensor's shape and dtype and x's device."""
    cuda = torch.device("cuda")
    tensors = {"x": ((1, *hw, 3), torch.uint8),
               "y": ((1, *hw), torch.int32),
               "coords": ((1, 12, 2), torch.int32),
               "labels": ((1, 12), torch.int32),
               "valid": ((1, 12), torch.bool)}
    return {k: SimpleNamespace(shape=tensors[k][0], dtype=tensors[k][1],
                               device=cuda) for k in keys}


class _Drawer(torch.nn.Module):
    """Stands for a dropout: the train graphs read its ``generator``."""

    def __init__(self):
        super().__init__()
        self.generator = None


class _FakeCudaGenerator:
    """Stands for a ``torch.Generator`` on a card."""

    device = torch.device("cuda")


def _graphs(kind, drawer=None):
    """The graphs of a ``kind`` step as ``make_train_step`` or
    ``make_eval_step`` makes them (the train step's keyed on its model's
    dropout generators, here one ``drawer``) and the batch keys they
    read."""
    if kind == "train":
        model = torch.nn.Sequential(drawer or _Drawer())
        return trainer._Graphs("train", trainer.SPARSE_KEYS, _forward,
                               trainer._dropout_generators(model),
                               replay_span="train.replay"), \
            trainer.SPARSE_KEYS
    return trainer._Graphs("eval", ("x", "y"), _forward), ("x", "y")


def _counters(kind):
    from pixelpick_tpu_torch.utils import profiling

    return {k: profiling.counters().get(f"{kind}_{k}", 0)
            for k in ("eager_steps", "graph_captures", "graph_replays")}


@pytest.fixture
def stub_capture(monkeypatch):
    """``_Graph`` and the CUDA pool and stream replaced by stubs that
    record what the bookkeeping asked for."""
    made = []

    class Stub:
        def __init__(self, graphs, batch, extra, generators):
            self.extra, self.generators = extra, generators
            made.append(self)

    monkeypatch.setattr(trainer, "_Graph", Stub)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda: "stream")
    return made


def _forward(batch, *extra):
    raise AssertionError("the bookkeeping runs no forward")


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_eval_graphs_capture_at_a_signatures_first_call(tracer,
                                                        stub_capture, kind):
    """For the train and the eval step: a signature's graph is made at its
    first call, which captures it, and every later call gets the same
    graph to replay, so the second call captures nothing; another shape or
    another extra argument of the step (the eval step's ``valid_hw``) is
    another signature. No step of a graph counts as eager (the graph
    counts its capture and replays)."""
    graphs, keys = _graphs(kind)
    a, b = _fake_cuda_batch((8, 8), keys), _fake_cuda_batch((8, 16), keys)
    g = graphs.get(a, None)
    assert stub_capture == [g]
    assert all(graphs.get(a, None) is g for _ in range(3))
    assert graphs.get(b, None) not in (None, g)
    h = graphs.get(a, None, ((7, 8),))
    assert h not in (None, g) and h.extra == ((7, 8),)
    assert graphs.get(a, None, ((7, 8),)) is h
    assert len(stub_capture) == 3
    assert all(s.generators == () for s in stub_capture)
    assert graphs.pool == "pool" and graphs.stream == "stream"
    assert _counters(kind) == {"eager_steps": 0, "graph_captures": 0,
                               "graph_replays": 0}


def test_train_graphs_key_on_the_dropout_generators(tracer, stub_capture,
                                                    monkeypatch):
    """The train step's signature holds the CUDA generators its model's
    dropouts draw from, which the graph registers: another generator is
    another graph, and the first one's graph comes back with it. A
    dropout without a generator of its own, with a CPU one or with the
    card's default one (which every graph registers itself) registers
    none."""
    drawer = _Drawer()
    graphs, keys = _graphs("train", drawer)
    a = _fake_cuda_batch((8, 8), keys)
    default, g1, g2 = (_FakeCudaGenerator() for _ in range(3))
    monkeypatch.setattr(torch.cuda, "default_generators", (default,))
    plain = graphs.get(a, None)
    for gen in (torch.Generator(), default):
        drawer.generator = gen
        assert graphs.get(a, None) is plain
    drawer.generator = g1
    first = graphs.get(a, None)
    drawer.generator = g2
    second = graphs.get(a, None)
    drawer.generator = g1
    assert graphs.get(a, None) is first
    assert stub_capture == [plain, first, second]
    assert [s.generators for s in stub_capture] == [(), (g1,), (g2,)]


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_eval_step_never_captures_across_ranks(tracer, stub_capture,
                                               monkeypatch, kind):
    """With more than one rank, a row shard or a height shard the train
    and the eval step stay eager: their all-reduces and halo exchanges
    are not captured."""
    from pixelpick_tpu_torch.parallel import distributed, mesh

    cuda = torch.device("cuda")
    assert trainer.graphable(cuda) and not trainer.graphable(
        torch.device("cpu"))
    graphs, keys = _graphs(kind)
    a = _fake_cuda_batch((8, 8), keys)
    with mesh.sharded_height(mesh.HeightShard((0, 8, 16), 0, 8)):
        assert not trainer.graphable(cuda)
        assert all(graphs.get(a, None) is None for _ in range(3))
    shard = mesh.RowShard(0, 1, 2)
    assert all(graphs.get(a, shard) is None for _ in range(3))
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    assert not trainer.graphable(cuda)
    assert all(graphs.get(a, None) is None for _ in range(3))
    assert stub_capture == [] and graphs.pool is None
    assert _counters(kind)["eager_steps"] == 9


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_a_dropped_steps_graphs_are_freed_at_once(monkeypatch, kind):
    """A step's graphs hold no reference cycle: dropped, they are freed at
    once and not left to the cycle collector, which may run while another
    step's graph is captured, where freeing a CUDA graph is not
    permitted."""
    import gc
    import weakref

    monkeypatch.setattr(trainer, "graphable", lambda device: True)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda: "stream")
    graphs, keys = _graphs(kind)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in _fake_cuda_batch((8, 8), keys).items()}
    graph = graphs.get(batch, None)
    assert isinstance(graph, trainer._Graph)
    dropped = [weakref.ref(graphs), weakref.ref(graph)]
    gc.disable()
    try:
        del graphs, graph
        assert [r() for r in dropped] == [None, None]
    finally:
        gc.enable()


def test_eval_step_keys_valid_hw_as_a_tuple(monkeypatch):
    """The eval step hands ``valid_hw`` to its graphs as a tuple, so a list
    and a tuple of the same size are one signature."""
    asked = []

    class Graphs:  # records what the step asks its cache for
        def __init__(self, *args, **kwargs):
            pass

        def get(self, batch, shard, extra=()):
            asked.append(extra)
            return None  # the eager step

    class Model(torch.nn.Module):
        def forward(self, x, upsample=False):
            return {"pred": torch.zeros(x.shape[0], 2, 2, N_CLASSES)}

    monkeypatch.setattr(trainer, "_Graphs", Graphs)
    step = trainer.make_eval_step(Model(), n_classes=N_CLASSES, mean=MEAN,
                                  std=STD)
    batch = {"x": torch.zeros(1, 8, 8, 3, dtype=torch.uint8),
             "y": torch.zeros(1, 7, 8, dtype=torch.int32)}
    for valid_hw in ([7, 8], (7, 8)):
        hist, pred, _ = step(batch, valid_hw=valid_hw)
        assert pred.shape == (1, 7, 8) and int(hist.sum()) == 56
    assert asked == [((7, 8),), ((7, 8),)]
    assert all(type(hw) is tuple for (hw,) in asked)
