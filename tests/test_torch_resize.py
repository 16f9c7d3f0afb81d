"""The port's interpolation-matmul resize against the JAX package's, in f32,
including the in==out and size-1 cases (pixelpick_tpu/ops/resize.py:36-51).
Tolerance 1e-6: the same two matrix products in f32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixelpick_tpu.ops import resize as jax_resize
from pixelpick_tpu_torch.ops import resize


CASES = [
    ((6, 8), (12, 16)),    # upsample
    ((23, 30), (90, 120)),  # the ASPP -> 1/4 step at 360x480
    ((12, 16), (5, 7)),    # downsample
    ((7, 9), (7, 9)),      # in == out: identity
    ((1, 1), (4, 6)),      # size-1 input
    ((5, 6), (1, 1)),      # size-1 output
    ((1, 5), (3, 5)),      # one axis of size 1, other unchanged
]


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", CASES)
def test_resize_matches_jax(in_hw, out_hw, align_corners):
    x = np.random.default_rng(0).standard_normal((2, *in_hw, 3)) \
        .astype(np.float32)
    got = resize.resize_bilinear(torch.from_numpy(x), out_hw,
                                 align_corners).numpy()
    ref = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), out_hw,
                                                align_corners))
    assert got.shape == ref.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        resize._interp_matrix_np(in_hw[0], out_hw[0], align_corners),
        jax_resize._interp_matrix_np(in_hw[0], out_hw[0], align_corners))


def test_resize_hwc_and_bf16_round_trip():
    """An HWC input comes back HWC; a bf16 input is computed in f32 and cast
    back to bf16 (tolerance: one bf16 rounding of the f32 result)."""
    x = np.random.default_rng(1).standard_normal((6, 8, 4)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = resize.resize_align_corners(xb, (11, 15))
    assert got.shape == (11, 15, 4) and got.dtype == torch.bfloat16
    ref = np.asarray(jax_resize.resize_align_corners(
        jnp.asarray(xb.float().numpy()), (11, 15)))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8,
                               atol=1e-6)
