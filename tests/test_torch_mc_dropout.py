"""The port's MC-dropout committee (``--use_mc_dropout``, ``--mc_n_steps``,
``--vote_type``, ``--mc_dropout2d_committee``): the model's dropout sites
(models/mobilenet_v2.py, aspp.py, deeplab.py), the committee in
active/acquisition.py and its plumbing through the selector and the driver.

Against the JAX package's ``make_score_fn(mc_n_steps=3)`` at shared
weights (width 0.5, 48x64) with every dropout at p = 0 on both sides (flax's
``Dropout`` patched to the identity, as tests/test_mc_fidelity.py does;
the frameworks draw different masks), the selection draws and the random
strategy's per-member scores injected from JAX's keys. Picks are compared
as sets; stats in f32 at 1e-5, as tests/test_torch_acquisition.py. At
p = 0 the members are equal, so a hard vote scores every pixel alike (the
votes are one-hot): that case runs at ``top_n_percent 1.0``, where the
candidate pool is the whole image and the picks are the sub-sample's
alone, whatever order the ties take.

At p > 0 the port is held to an explicit loop over the members, the same
masks drawn from the same seeded generator: the picks equal and the stats
within 1e-6. The gating rules are tests/test_mc_fidelity.py:53-83's: the
backbone's Dropout2d sites stay off in committee scoring unless
``mc_dropout2d_committee``; the head's and ASPP's dropouts give the
committee its variance.
"""

import contextlib
import io
import os

import flax.linen
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from pixelpick_tpu.active import acquisition as jax_acq
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu_torch.active import acquisition
from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.models.factory import init_model
from pixelpick_tpu_torch.models.mobilenet_v2 import MobileNetV2
from pixelpick_tpu_torch.ops.resize import resize_align_corners
from pixelpick_tpu_torch.ops.uncertainty import fill_value, uncertainty_map
from tests.helpers import make_synthetic_camvid
from torch_helpers import (
    HW, N_CLASSES, jax_deeplab_variables,
)
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

WIDTH, IGNORE, STEPS = 0.5, 11, 3
MEAN, STD = [0.41, 0.42, 0.43], [0.27, 0.28, 0.28]
pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _batch(bsz=3, seed=5):
    rng = np.random.default_rng(seed)
    return {"x": rng.integers(0, 256, (bsz, *HW, 3), dtype=np.uint8),
            "excluded": rng.random((bsz, *HW)) < 0.1,
            "y": rng.integers(0, N_CLASSES + 1, (bsz, *HW)).astype(np.int32)}


def _jax_draws(rng, bsz):
    """The uniforms the JAX committee draws from ``rng``: split into (fwd,
    sel) (acquisition.py:160); sel into one key per image, each into (a, b),
    ``b`` the sub-sample's (:181, :81); fwd into one key per member, each
    the random strategy's member scores (:145), and fwd itself the hard
    vote's (:150)."""
    rng_fwd, rng_sel = jax.random.split(rng)
    select = [np.array(jax.random.uniform(jax.random.split(k)[1],
                                          (HW[0] * HW[1],)))
              for k in jax.random.split(rng_sel, bsz)]
    members = [np.array(jax.random.uniform(k, (bsz, *HW)))
               for k in jax.random.split(rng_fwd, STEPS)]
    return {"select": torch.from_numpy(np.stack(select)),
            "member_scores": torch.from_numpy(np.stack(members)),
            "score": torch.from_numpy(np.array(
                jax.random.uniform(rng_fwd, (bsz, *HW))))}


def _pick_sets(idx):
    return [set(np.asarray(row).tolist()) for row in idx]


@pytest.fixture(scope="module")
def variables():
    return jax_deeplab_variables(N_CLASSES, WIDTH, HW)


def _port_model(params, stats, p):
    model = DeepLab(N_CLASSES, width_mult=WIDTH, mc_dropout=True,
                    mc_dropout_p=p)
    model.load_state_dict(state_dict_from_jax(params, stats))
    return model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("strategy,vote_type,top_n_percent", [
    ("margin_sampling", "soft", 0.05), ("random", "soft", 0.05),
    ("margin_sampling", "hard", 1.0)])
def test_committee_matches_jax_at_p0(variables, strategy, vote_type,
                                     top_n_percent):
    params, stats = variables
    batch = _batch()
    kw = dict(strategy=strategy, mean=MEAN, std=STD, n_pixels=5,
              top_n_percent=top_n_percent, reverse_order=False,
              ignore_index=IGNORE, mc_n_steps=STEPS, vote_type=vote_type)
    rng = jax.random.PRNGKey(13)
    orig = flax.linen.Dropout.__call__
    flax.linen.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        jax_fn = jax_acq.make_score_fn(
            JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH, mc_dropout=True,
                       mc_dropout_p=0.0), n_classes=N_CLASSES, **kw)
        ref_idx, ref_stats = jax_fn(params, stats, batch, rng)
    finally:
        flax.linen.Dropout.__call__ = orig
    ref_idx = np.asarray(ref_idx)

    model = _port_model(params, stats, 0.0)
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    calls = []
    fwd = model.forward
    model.forward = lambda *a, **k: calls.append(k) or fwd(*a, **k)
    score = acquisition.make_score_fn(model, **kw)
    idx, got = score({k: torch.from_numpy(v) for k, v in batch.items()},
                     uniforms=_jax_draws(rng, len(batch["x"])))
    assert [c.get("mc_dropout_on") for c in calls] == [True] * STEPS
    idx = idx.numpy()
    assert _pick_sets(idx) == _pick_sets(ref_idx)
    if vote_type == "soft":
        forbidden = (batch["excluded"] | (batch["y"] == IGNORE)).reshape(3, -1)
        assert not np.take_along_axis(forbidden, idx, 1).any()
    order, ref_order = np.argsort(idx, 1), np.argsort(ref_idx, 1)
    for k in ("entropy", "labels", "picked_valid"):
        np.testing.assert_allclose(
            np.take_along_axis(got[k].numpy(), order, 1),
            np.take_along_axis(np.asarray(ref_stats[k]), ref_order, 1),
            rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["coverage"].numpy(),
                               np.asarray(ref_stats["coverage"]), rtol=1e-5)


@pytest.mark.parametrize("vote_type", ["soft", "hard"])
def test_committee_matches_member_loop(variables, vote_type):
    """p > 0: the score function against the committee written out member
    by member, the same masks from the same seeded generator."""
    params, stats = variables
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    model = _port_model(params, stats, 0.5)
    draws = {"select": torch.rand((3, HW[0] * HW[1]),
                                  generator=torch.Generator().manual_seed(1))}
    kw = dict(strategy="margin_sampling", mean=MEAN, std=STD, n_pixels=5,
              top_n_percent=0.05, reverse_order=False, ignore_index=IGNORE)
    model.set_dropout_generator(torch.Generator().manual_seed(7))
    idx, got = acquisition.make_score_fn(
        model, mc_n_steps=STEPS, vote_type=vote_type, **kw)(
        batch, uniforms=draws)

    model.set_dropout_generator(torch.Generator().manual_seed(7))
    x = acquisition.normalize_images(batch["x"], MEAN, STD)
    with torch.no_grad():
        probs = [torch.softmax(resize_align_corners(
            model(x, upsample=False, mc_dropout_on=True)["pred"], HW), -1)
            for _ in range(STEPS)]
        plain = torch.softmax(resize_align_corners(
            model(x, upsample=False)["pred"], HW), -1)
    assert not torch.equal(probs[0], probs[1])  # the members differ
    assert not torch.equal(probs[0], plain)
    prob = sum(probs) / STEPS
    if vote_type == "soft":
        uc = sum(uncertainty_map(p, "margin_sampling") for p in probs) / STEPS
    else:
        votes = sum(torch.nn.functional.one_hot(p.argmax(-1), N_CLASSES)
                    .float() for p in probs) / STEPS
        uc = uncertainty_map(votes, "margin_sampling")
    excluded = batch["excluded"] | (batch["y"] == IGNORE)
    uc = uc.masked_fill(excluded, fill_value("margin_sampling"))
    ref = acquisition._select_topk(
        uc.reshape(3, -1), draws["select"], strategy="margin_sampling",
        n_pixels=5, top_n_percent=0.05, reverse_order=False)
    assert _pick_sets(idx) == _pick_sets(ref)
    ent = -(prob * torch.log(prob)).sum(-1).reshape(3, -1)
    np.testing.assert_allclose(got["entropy"].numpy(),
                               torch.gather(ent, 1, idx).numpy(), rtol=1e-6)


def _backbone_outputs(committee_2d, train=False):
    m = init_model(MobileNetV2(width_mult=0.5, mc_dropout=True,
                               mc_dropout_p=0.5,
                               mc_dropout2d_committee=committee_2d), 0)
    m.train(train)
    x = torch.randn((1, 3, 32, 32), generator=torch.Generator().manual_seed(0))
    outs = []
    for seed in (10, 11):
        for mod in m.modules():
            if isinstance(mod, layers.Dropout):
                mod.generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            outs.append(m(x, mc_dropout_on=True))
    return outs


def test_backbone_dropout2d_inactive_during_mc_by_default():
    """The reference's turn_on_dropout leaves nn.Dropout2d off: committee
    scoring is deterministic through the backbone."""
    (h1, l1), (h2, l2) = _backbone_outputs(committee_2d=False)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)


def test_backbone_dropout2d_active_with_committee_flag():
    """--mc_dropout2d_committee adds the two sites to the committee; in
    train mode they are on either way."""
    (h1, l1), (h2, l2) = _backbone_outputs(committee_2d=True)
    assert not torch.equal(h1, h2) and not torch.equal(l1, l2)
    (h1, _), (h2, _) = _backbone_outputs(committee_2d=False, train=True)
    assert not torch.equal(h1, h2)


def test_full_model_committee_variance_comes_from_head_dropouts():
    """DeepLab in eval mode under MC: other masks give other predictions
    (ASPP's and the head's dropouts), without MC it is deterministic."""
    m = init_model(DeepLab(5, width_mult=0.5, mc_dropout=True,
                           mc_dropout_p=0.5), 0).eval()
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    outs = {}
    for on in (True, False):
        for seed in (3, 4):
            m.set_dropout_generator(torch.Generator().manual_seed(seed))
            with torch.no_grad():
                outs[on, seed] = m(x, mc_dropout_on=on)["pred"]
    assert not torch.equal(outs[True, 3], outs[True, 4])
    assert torch.equal(outs[False, 3], outs[False, 4])


def test_mc_dropout_model_takes_the_same_weights(variables):
    """Dropout has no parameters: the JAX tree of an MC-dropout DeepLab is
    the plain one's, and the bridge loads it into the port's MC-dropout
    model (strict) with the plain model's keys."""
    params, stats = variables
    tree = jax.eval_shape(lambda: JaxDeepLab(
        n_classes=N_CLASSES, width_mult=WIDTH, mc_dropout=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), train=False))
    assert jax.tree.structure(tree["params"]) == \
        jax.tree.structure(params)
    mc = _port_model(params, stats, 0.2)
    plain = DeepLab(N_CLASSES, width_mult=WIDTH)
    assert list(mc.state_dict()) == list(plain.state_dict())


def test_committee_round(tmp_path, monkeypatch):
    """One AL round with the committee through ``main_al``
    (tests/test_e2e_variants.py:10-23): 3 members per pool batch, and the
    round labels its picks (8 images, 4 initial and 4 new pixels each)."""
    from pixelpick_tpu_torch.cli.main_al import main

    root = make_synthetic_camvid(str(tmp_path / "ds"), n_train=8, n_test=2)
    os.rename(f"{root}/test", f"{root}/val")
    os.rename(f"{root}/testannot", f"{root}/valannot")
    cfg = dict(dataset_name="custom", dir_dataset=root, batch_size=4,
               ignore_index=IGNORE, n_classes=N_CLASSES, n_epochs=1,
               mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25],
               optimizer_type="Adam", lr_scheduler_type="MultiStepLR",
               optimizer_params={"lr": 5e-4, "betas": [0.9, 0.999],
                                 "weight_decay": 2e-4, "eps": 1e-7})
    (tmp_path / "custom.yaml").write_text(yaml.safe_dump(cfg))
    members = []
    full_res = acquisition._full_res_pred

    def counted(model, x, **kw):
        members.append(kw.get("mc_dropout_on", False))
        return full_res(model, x, **kw)

    monkeypatch.setattr(acquisition, "_full_res_pred", counted)
    with contextlib.redirect_stdout(io.StringIO()):
        al = main(["-pdc", str(tmp_path / "custom.yaml"), "--dir_checkpoints",
                   str(tmp_path / "ckpt"), "--device", "cpu",
                   "--width_multiplier", "0.5", "--n_pixels_by_us", "4",
                   "--max_budget", "4", "-qs", "entropy",
                   "--top_n_percent", "0.1", "--use_mc_dropout",
                   "--mc_n_steps", str(STEPS), "--pool_batch_size", "4",
                   "--n_workers", "2"])
    assert members == [True] * (STEPS * 2)  # 2 pool batches of 4
    assert sum(isinstance(m, layers.Dropout2d) for m in al.model.modules()) \
        == 2
    assert al.dataset.n_pixels_total == 8 * 4 * 2
    assert (tmp_path / "ckpt" / "1_query" / "queries.pkl").is_file()
