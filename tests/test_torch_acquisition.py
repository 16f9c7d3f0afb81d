"""The port's acquisition engine against the JAX one
(pixelpick_tpu/active/acquisition.py): uncertainty maps, the two-stage
top-k selection with the JAX draws injected, and the batched score function
at shared DeepLab weights (width 0.5, 48x64).

Picks are compared as sets: torch.topk and jax.lax.top_k need not order
ties, or near-ties within float rounding, the same way. Uncertainty maps
and stats are compared in f32 at 1e-5 (the same formulas on probabilities
that agree to ~1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixelpick_tpu.active import acquisition as jax_acq
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu_torch.active import acquisition
from pixelpick_tpu_torch.ops import uncertainty
from torch_helpers import jax_deeplab_variables, port_deeplab

N_CLASSES, WIDTH, HW = 11, 0.5, (48, 64)
MEAN, STD, IGNORE = [0.41, 0.42, 0.43], [0.27, 0.28, 0.28], 11
STRATEGIES = ["entropy", "least_confidence", "margin_sampling", "random"]


def _jax_draws(rng, bsz, hw, reverse_order):
    """The uniforms make_score_fn draws from ``rng``: split into (fwd, sel)
    (acquisition.py:160), sel into one key per image (:181), each into
    (a, b) (:81); ``a`` feeds reverse_order, ``b`` the sub-sample, and
    ``fwd`` the random strategy's map (:154)."""
    rng_fwd, rng_sel = jax.random.split(rng)
    select = []
    for key in jax.random.split(rng_sel, bsz):
        rng_a, rng_b = jax.random.split(key)
        select.append(np.array(jax.random.uniform(
            rng_a if reverse_order else rng_b, (hw[0] * hw[1],))))
    score = np.array(jax.random.uniform(rng_fwd, (bsz, *hw)))
    return {"select": torch.from_numpy(np.stack(select)),
            "score": torch.from_numpy(score)}


def _pick_sets(idx):
    return [set(np.asarray(row).tolist()) for row in idx]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_uncertainty_map_matches_jax(strategy):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
    logits[0, 0, 0, :] = [80.0, -80.0, -80.0, 0.0, 0.0, 0.0]  # p underflows to 0
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_acq.uncertainty_map(jnp.asarray(prob), strategy, key))
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (2, 4, 5))))
    got = uncertainty.uncertainty_map(torch.from_numpy(prob), strategy,
                                      noise).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert uncertainty.fill_value(strategy) == jax_acq.fill_value(strategy)


@pytest.mark.parametrize("strategy,top_n_percent,reverse_order", [
    ("margin_sampling", 0.0, False),
    ("entropy", 0.0, False),
    ("margin_sampling", 0.05, False),
    ("least_confidence", 0.2, False),
    ("margin_sampling", 0.05, True),
    ("entropy", 0.3, True),
])
def test_select_topk_matches_jax(strategy, top_n_percent, reverse_order):
    hw, bsz, n_pixels = (30, 40), 3, 7
    uc = np.random.default_rng(4).random((bsz, hw[0] * hw[1])) \
        .astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), bsz)
    ref = [np.asarray(jax_acq._select_topk(
        jnp.asarray(uc[b]), keys[b], strategy=strategy, n_pixels=n_pixels,
        top_n_percent=top_n_percent, reverse_order=reverse_order, hw=hw,
        pad_mask=jnp.zeros(hw[0] * hw[1], bool),
        true_n=jnp.int32(hw[0] * hw[1]))) for b in range(bsz)]
    draws = np.stack([np.array(jax.random.uniform(
        jax.random.split(keys[b])[0 if reverse_order else 1],
        (hw[0] * hw[1],))) for b in range(bsz)])
    got = acquisition._select_topk(
        torch.from_numpy(uc), torch.from_numpy(draws), strategy=strategy,
        n_pixels=n_pixels, top_n_percent=top_n_percent,
        reverse_order=reverse_order)
    assert got.shape == (bsz, n_pixels)
    assert _pick_sets(got) == _pick_sets(ref)


@pytest.fixture(scope="module")
def shared_model():
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW)
    rng = np.random.default_rng(5)
    bsz = 3
    batch = {
        "x": rng.integers(0, 256, (bsz, *HW, 3), dtype=np.uint8),
        "excluded": rng.random((bsz, *HW)) < 0.1,
        "y": rng.integers(0, N_CLASSES + 1, (bsz, *HW)).astype(np.int32),
    }
    return params, stats, batch


@pytest.mark.parametrize("top_n_percent,reverse_order", [
    (0.0, False), (0.05, False), (0.05, True)])
def test_score_fn_matches_jax(shared_model, top_n_percent, reverse_order):
    """Same weights, same batch, same draws: the same pick sets, none on an
    excluded or void pixel, and the same stats per pick."""
    params, stats, batch = shared_model
    kw = dict(strategy="margin_sampling", mean=MEAN, std=STD, n_pixels=5,
              top_n_percent=top_n_percent, reverse_order=reverse_order,
              ignore_index=IGNORE)
    rng = jax.random.PRNGKey(11)
    jax_fn = jax_acq.make_score_fn(
        JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH),
        n_classes=N_CLASSES, **kw)
    ref_idx, ref_stats = jax_fn(params, stats, batch, rng)
    ref_idx = np.asarray(ref_idx)

    score = acquisition.make_score_fn(
        port_deeplab(params, stats, N_CLASSES, WIDTH), **kw)
    draws = _jax_draws(rng, len(batch["x"]), HW, reverse_order)
    idx, got_stats = score({k: torch.from_numpy(v) for k, v in batch.items()},
                           uniforms=draws)
    idx = idx.numpy()
    assert _pick_sets(idx) == _pick_sets(ref_idx)
    forbidden = (batch["excluded"] | (batch["y"] == IGNORE)).reshape(3, -1)
    assert not np.take_along_axis(forbidden, idx, 1).any()

    order, ref_order = np.argsort(idx, 1), np.argsort(ref_idx, 1)
    for k in ("entropy", "labels", "picked_valid"):
        np.testing.assert_allclose(
            np.take_along_axis(got_stats[k].numpy(), order, 1),
            np.take_along_axis(np.asarray(ref_stats[k]), ref_order, 1),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_stats["coverage"].numpy(),
                               np.asarray(ref_stats["coverage"]), rtol=1e-5)


class _TinyTorch(torch.nn.Module):
    """A 1x1 conv 'segmentation model' with fixed weights."""

    def __init__(self, kernel):
        super().__init__()
        self.kernel = torch.from_numpy(kernel)

    def forward(self, x, upsample=True):
        return {"pred": x @ self.kernel}


def test_stats_spill_and_nan_coverage():
    """An image with fewer pickable pixels than n_pixels flags its spilled
    picks in picked_valid; an image with < 2 valid picks has NaN coverage
    (reference query.py:269-279), as in the JAX engine."""
    import flax.linen as nn

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, train=False, mc_dropout_on=False, upsample=True):
            return {"pred": nn.Conv(4, (1, 1), use_bias=False,
                                    name="cls")(x), "emb": x}

    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (2, 6, 6, 3), dtype=np.uint8)
    excluded = np.ones((2, 6, 6), bool)
    excluded[0, 0, :3] = False  # image 0: 3 pickable pixels, n_pixels=5
    excluded[1, 2, 2] = False   # image 1: one pickable pixel
    batch = {"x": x, "excluded": excluded, "y": np.zeros((2, 6, 6), np.int32)}
    model = Tiny()
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 6, 6, 3)))
    kw = dict(strategy="margin_sampling", mean=[0.5] * 3, std=[0.25] * 3,
              n_pixels=5, top_n_percent=0.0, reverse_order=False,
              ignore_index=11)
    ref_idx, ref_stats = jax_acq.make_score_fn(model, n_classes=4, **kw)(
        variables["params"], {}, batch, jax.random.PRNGKey(0))
    kernel = np.array(variables["params"]["cls"]["kernel"][0, 0])
    idx, stats = acquisition.make_score_fn(_TinyTorch(kernel), **kw)(
        {k: torch.from_numpy(v) for k, v in batch.items()})

    ok = stats["picked_valid"].numpy()
    assert ok.sum(1).tolist() == [3, 1]
    assert np.asarray(ref_stats["picked_valid"]).sum(1).tolist() == [3, 1]
    good0 = {int(i) for i, v in zip(idx[0].numpy(), ok[0]) if v}
    assert good0 == {0, 1, 2}
    cov = stats["coverage"].numpy()
    assert np.isfinite(cov[0]) and np.isnan(cov[1])
    np.testing.assert_allclose(cov, np.asarray(ref_stats["coverage"]),
                               rtol=1e-5)
