"""The port's depthwise 3x3 (pixelpick_tpu_torch/ops/depthwise.py) against
the JAX package's: the plain PyTorch version and the stride-2 dispatch on
the CPU, the hand-written kernel on a card.

Tolerances: f32 1e-5 (the same 9 products summed in the same order; only
the rounding of fused vs separate multiply-adds may differ). bf16: both
sides accumulate in f32 and round once, so they may differ by one bf16 ulp
(2**-7 relative) where the f32 sums straddle a rounding boundary.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixelpick_tpu.ops.depthwise import (
    depthwise_conv3x3 as jax_depthwise, depthwise_reference as jax_reference,
)
from pixelpick_tpu_torch.ops import depthwise as dw

# the shapes of tests/test_depthwise_pallas.py:12-17, plus ragged ones
SHAPES = [
    (1, 1, (12, 16), 8),
    (2, 1, (12, 16), 8),
    (1, 2, (14, 18), 16),
    (2, 1, (18, 24), 32),
    (1, 1, (23, 30), 7),
    (1, 2, (9, 11), 20),
]


def _inputs(seed, hw, ch, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *hw, ch)).astype(np.float32)
    w = rng.standard_normal((3, 3, ch)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("stride,dilation,hw,ch", SHAPES)
def test_forward_matches_jax(stride, dilation, hw, ch):
    x, w = _inputs(0, hw, ch)
    pad = dilation
    got = dw.depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                               stride, dilation, pad).numpy()
    pallas = np.asarray(jax_depthwise(jnp.asarray(x), jnp.asarray(w), stride,
                                      dilation, pad, True))  # interpret
    ref = np.asarray(jax_reference(jnp.asarray(x), jnp.asarray(w), stride,
                                   dilation, pad))
    assert got.shape == ref.shape == pallas.shape
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 2])
def test_plain_version_bf16_matches_pallas_interpret(dilation):
    x, w = _inputs(1, (10, 13), 24)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = dw.depthwise_reference_torch(
        torch.nn.functional.pad(xb, (0, 0, dilation, dilation, dilation,
                                     dilation)), wb, dilation)
    assert got.dtype == torch.bfloat16
    xj = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    wj = jnp.asarray(wb.float().numpy(), jnp.bfloat16)
    ref = np.asarray(jax_depthwise(xj, wj, 1, dilation, dilation, True)
                     .astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


def test_dispatch_counts_and_cpu_path():
    """Stride 1 on a CPU tensor takes the plain version (no kernel launch
    counted); stride 2 goes to the grouped conv and is counted apart."""
    x, w = _inputs(2, (12, 16), 8)
    dw.reset_launch_counts()
    dw.depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(w), 1, 1, 1)
    dw.depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(w), 2, 1, 1)
    assert dw.launch_counts == {"kernel": 0, "kernel_dx": 0,
                                "stride2_conv": 1}


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU launches the kernel or raises; here a meta
    tensor reaches the kernel's checks and is refused there."""
    x = torch.empty((1, 6, 6, 4), device="meta")
    w = torch.empty((3, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        dw.depthwise_conv3x3(x, w, 1, 1, 0)
