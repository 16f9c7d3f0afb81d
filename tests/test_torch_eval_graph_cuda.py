"""The eval step's CUDA graphs (``engine/trainer.py:_Graphs``) on a CUDA
card, against the same step run eagerly. Skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_eval_graph_cuda.py

The eager answer of a batch is a fresh eval step's, run with
``graphable`` false. A graphed step captures a signature's graphs at its
first call, which returns the warm-up's results, and replays them after
it; every one of its calls must give the eager step's ``pred`` and
``hist`` exactly and its visualisation maps to 1e-6 of each map's largest
|value|: the graphs run the same kernels on the same data, and count the
hand kernels' launches as the eager step does from the first call on. The cases: DeepLabv3+ on MobileNetV2 at
CamVid's 360x480, batch 1, ``--pallas_dw`` with and without ``--fused_ir``,
the latter also at ``--precision bf16``, and with ``--s2d_backbone``; the
dilated ResNet-50 FPN on VOC's two bucket shapes in turn, and on a
padded image cropped by ``valid_hw``; a batch of two whose maps are asked
for image 0 and 1 in turn; a replay after an optimizer update between two
passes.
"""

import numpy as np
import pytest
import torch

CAMVID_HW = (360, 480)
# VOC's two validation buckets at stride 8: the images with h >= w padded to
# 500x500, the others to 375x500 (data/loader.py:bucket_plan)
VOC_BUCKETS = ((504, 504), (376, 504))
N_CALLS = 10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")
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


def _model(dataset: str, **kw):
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models.factory import get_model

    args = default_args(dataset, device="cuda", **kw)
    return args, get_model(args, "cuda", seed=7)


def _batch(rng, hw, n_classes: int, device) -> dict:
    """One val image of distinct content (a 24x24 mosaic plus noise) and a
    label map with some ignored pixels."""
    mosaic = np.kron(rng.uniform(-1, 1, (1, -(-hw[0] // 24), -(-hw[1] // 24),
                                         3)), np.ones((1, 24, 24, 1)))
    img = rng.uniform(40, 100) * mosaic[:, :hw[0], :hw[1]] \
        + rng.uniform(80, 180) + rng.normal(0, 10, (1, *hw, 3))
    y = rng.integers(0, n_classes + 1, (1, *hw)).astype(np.int32)
    return {"x": torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8))
            .to(device),
            "y": torch.from_numpy(y).to(device)}


def _step(args, model):
    from pixelpick_tpu_torch.engine.trainer import make_eval_step

    return make_eval_step(model, n_classes=args.n_classes, mean=args.mean,
                          std=args.std)


def _eager(args, model, batch, **kw):
    """The eager step's answer: a fresh step's, with no graph."""
    from pixelpick_tpu_torch.engine import trainer

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "graphable", lambda device: False)
        hist, pred, vis = _step(args, model)(batch, **kw)
    return hist.clone(), pred.clone(), {k: v.clone() for k, v in vis.items()}


def _assert_same(out, ref, what):
    hist, pred, vis = out
    hist_r, pred_r, vis_r = ref
    assert torch.equal(hist, hist_r), what
    assert torch.equal(pred, pred_r), what
    assert vis.keys() == vis_r.keys()
    for k, v in vis_r.items():
        if v.is_floating_point():
            tol = 1e-6 * float(v.abs().max())
            assert float((vis[k] - v).abs().max()) <= tol, (what, k)
        else:
            assert torch.equal(vis[k], v), (what, k)


# CamVid's flags, and the depthwise kernel's launches per eval forward
CAMVID_CASES = {
    "pallas_dw": (dict(pallas_dw=True), 14),
    "fused_ir": (dict(pallas_dw=True, fused_ir=True), 1),
    "fused_ir_bf16": (dict(pallas_dw=True, fused_ir=True, precision="bf16"),
                      1),
    "s2d_backbone": (dict(pallas_dw=True, s2d_backbone=True), 12),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CAMVID_CASES))
def test_camvid_replays_equal_the_eager_step(card, tracer, case):
    from pixelpick_tpu_torch.ops import depthwise

    flags, per_forward = CAMVID_CASES[case]
    args, model = _model("cv", width_multiplier=1.0, **flags)
    rng = np.random.default_rng(3)
    batches = [_batch(rng, CAMVID_HW, args.n_classes, card)
               for _ in range(N_CALLS)]
    tracer.disable()
    depthwise.reset_launch_counts()
    refs = [_eager(args, model, b) for b in batches]
    eager_launches = dict(depthwise.launch_counts)
    assert eager_launches["kernel"] == N_CALLS * per_forward
    tracer.enable()
    step = _step(args, model)
    depthwise.reset_launch_counts()
    outs = []
    for i, b in enumerate(batches):
        outs.append(step(b))
        _assert_same(outs[-1], refs[i], f"call {i + 1}")
    # the capture's call ran one forward, each replay one
    assert depthwise.launch_counts == eager_launches
    assert tracer.counters() == {"eval_graph_captures": 1,
                                 "eval_graph_replays": N_CALLS - 1}
    # what call 3 returned is the caller's: later replays leave it alone
    torch.cuda.synchronize()
    assert torch.equal(outs[2][0], refs[2][0])
    assert torch.equal(outs[2][1], refs[2][1])


@pytest.mark.cuda
def test_fpn_replays_each_voc_bucket(card, tracer):
    args, model = _model("voc", network_name="FPN", n_layers=50,
                         use_dilated_resnet=True)
    rng = np.random.default_rng(4)
    step = _step(args, model)
    for i in range(4):
        for hw in VOC_BUCKETS:
            b = _batch(rng, hw, args.n_classes, card)
            _assert_same(step(b), _eager(args, model, b), (i, hw))
    # an image padded to the stride and cropped back (cli/eval.py)
    for i in range(3):
        b = _batch(rng, VOC_BUCKETS[1], args.n_classes, card)
        b["y"] = b["y"][:, :375, :500].contiguous()
        kw = dict(valid_hw=(375, 500))
        _assert_same(step(b, **kw), _eager(args, model, b, **kw),
                     ("valid_hw", i))
    tracer.disable()
    counts = tracer.counters()
    # 2 buckets x 4 calls and the cropped signature's 3, each signature
    # captured once; the eager references' 11 steps
    assert counts["eval_graph_captures"] == 3
    assert counts["eval_graph_replays"] == 2 * 3 + 2
    assert counts["eval_eager_steps"] == 11


@pytest.mark.cuda
def test_each_vis_index_replays_its_own_maps(card, tracer):
    """A batch of two whose maps are asked for image 0 and image 1 in
    turn: one forward graph, and a graph of maps per index."""
    args, model = _model("cv", width_multiplier=1.0, pallas_dw=True)
    rng = np.random.default_rng(6)
    step = _step(args, model)
    for i in range(6):
        b = _batch(rng, CAMVID_HW, args.n_classes, card)
        b = {k: torch.cat([v, v.flip(2)]) for k, v in b.items()}
        kw = dict(vis_index=i % 2)
        _assert_same(step(b, **kw), _eager(args, model, b, **kw), i)
    tracer.disable()
    assert tracer.counters() == {"eval_graph_captures": 1,
                                 "eval_graph_replays": 5,
                                 "eval_eager_steps": 6}


@pytest.mark.cuda
def test_a_replay_reads_the_weights_updated_in_place(card):
    """An optimizer update between two passes: the graphs captured in the
    first pass replay the new weights."""
    import chip_smoke as cs
    from pixelpick_tpu_torch.engine.optim import make_optimizer
    from pixelpick_tpu_torch.engine.trainer import (
        batch_to_device, make_train_step,
    )

    args, model = _model("cv", width_multiplier=1.0, pallas_dw=True,
                         fused_ir=True)
    rng = np.random.default_rng(5)
    batches = [_batch(rng, CAMVID_HW, args.n_classes, card)
               for _ in range(3)]
    step = _step(args, model)
    before = [step(b) for b in batches]  # capture, replay, replay
    _assert_same(before[-1], _eager(args, model, batches[-1]), "pass 1")
    train = make_train_step(model, make_optimizer(args, model, 1),
                            n_classes=args.n_classes, mean=args.mean,
                            std=args.std)
    train(batch_to_device(cs.train_batch(rng, 4, hw=CAMVID_HW), card))
    for b, old in zip(batches, before):
        out = step(b)  # replays
        _assert_same(out, _eager(args, model, b), "pass 2")
        assert not torch.equal(out[2]["entropy"], old[2]["entropy"])
