"""The port's DeepLabv3+/MobileNetV2 eval forward against the JAX DeepLab at
the same weights (width 0.5, 64x96, batch 2), through the weight bridge.

Tolerances, relative to the largest |value| of the JAX output:
- f32: 1e-4 — the same arithmetic summed in other orders (convolutions,
  matmuls) through ~60 layers;
- bf16: mean error 2e-2, max error 1e-1 — both frameworks round each
  layer's output to bf16 (8 bits), at places that differ (convolution
  internals, fused elementwise chains). At these weights the JAX model's own
  bf16 output differs from its f32 output by about as much (mean 1e-2, max
  6e-2), so the bound is that drift with a factor of two of headroom.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixelpick_tpu.models import layers as jax_layers
from pixelpick_tpu.models.convert import convert_deeplab
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.ops import depthwise as dw
from torch_helpers import jax_deeplab_variables

N_CLASSES, WIDTH, HW = 11, 0.5, (64, 96)


@pytest.fixture(scope="module")
def jax_model():
    x = np.random.default_rng(0).standard_normal((2, *HW, 3)).astype(np.float32)
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW)
    return x, params, stats


def _jax_forward(params, stats, x, dtype=jnp.float32, upsample=True):
    model = JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH, dtype=dtype)
    fn = jax.jit(lambda v, x: model.apply(v, x, train=False,
                                          upsample=upsample))
    out = fn({"params": params, "batch_stats": stats}, jnp.asarray(x))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _port_forward(params, stats, x, dtype=torch.float32, upsample=True):
    model = DeepLab(N_CLASSES, width_mult=WIDTH, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(params, stats))
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x), upsample=upsample)
    return {k: v.float().numpy() for k, v in out.items()}


def _assert_close(got, ref, rel, mean_rel=None):
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        scale = np.abs(ref[k]).max()
        err = np.abs(got[k] - ref[k])
        assert err.max() <= rel * scale, \
            f"{k}: max err {err.max()} vs max |ref| {scale}"
        if mean_rel is not None:
            assert err.mean() <= mean_rel * scale, \
                f"{k}: mean err {err.mean()} vs max |ref| {scale}"


@pytest.mark.parametrize("upsample", [True, False])
def test_forward_f32_matches_jax(jax_model, upsample):
    x, params, stats = jax_model
    ref = _jax_forward(params, stats, x, upsample=upsample)
    got = _port_forward(params, stats, x, upsample=upsample)
    _assert_close(got, ref, 1e-4)


def test_forward_with_depthwise_kernel_path_matches_jax_pallas(jax_model):
    """set_depthwise_impl('pallas') on both sides: JAX runs its Pallas
    kernel in interpret mode, the port its depthwise wrapper (the plain
    version on the CPU, the grouped conv at stride 2)."""
    x, params, stats = jax_model
    try:
        jax_layers.set_depthwise_impl("pallas")
        layers.set_depthwise_impl("pallas")
        ref = _jax_forward(params, stats, x, upsample=False)
        dw.reset_launch_counts()
        got = _port_forward(params, stats, x, upsample=False)
        assert dw.launch_counts["stride2_conv"] == 3
    finally:
        jax_layers.set_depthwise_impl("xla")
        layers.set_depthwise_impl("xla")
    _assert_close(got, ref, 1e-4)


def test_forward_bf16_matches_jax(jax_model):
    x, params, stats = jax_model
    ref = _jax_forward(params, stats, x, dtype=jnp.bfloat16, upsample=False)
    got = _port_forward(params, stats, x, dtype=torch.bfloat16,
                        upsample=False)
    _assert_close(got, ref, 1e-1, mean_rel=2e-2)


def test_bridge_round_trip(jax_model):
    """state_dict_from_jax, then the JAX package's convert_deeplab, gives
    back the original trees."""
    _, params, stats = jax_model
    sd = state_dict_from_jax(params, stats)
    p2, s2 = convert_deeplab({k: v.numpy() for k, v in sd.items()},
                             N_CLASSES, 16, WIDTH)
    for a, b in ((params, p2), (stats, s2)):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
        assert len(fa) == len(fb)
        for path, leaf in fa:
            np.testing.assert_array_equal(np.asarray(fb[path]), leaf)
    # and the port's module tree has exactly these keys
    model = DeepLab(N_CLASSES, width_mult=WIDTH)
    assert set(model.state_dict()) == set(sd)


def test_get_model_init(tmp_path):
    """Seeded He-normal fan-in convs, identity BN, on the CPU in eval mode
    and channels_last; the same seed gives the same weights."""
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models.factory import get_model

    args = default_args(width_multiplier=WIDTH, device="cpu",
                        dir_checkpoints=str(tmp_path))
    m1, m2 = get_model(args), get_model(args)
    assert not m1.training
    head = m1.seg_head.segment_head[0].weight
    assert head.is_contiguous(memory_format=torch.channels_last)
    fan_in = head.shape[1] * 9
    assert abs(head.std().item() - np.sqrt(2.0 / fan_in)) < 0.05 * np.sqrt(2.0 / fan_in)
    bn = m1.seg_head.segment_head[1]
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
