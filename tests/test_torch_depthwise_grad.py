"""Gradients of the port's depthwise 3x3 (ops/depthwise.py) against
``jax.vjp`` of the JAX package's ``depthwise_conv3x3`` (its custom VJP, the
forward in Pallas interpret mode), at stride 1 and 2 and dilation 1 and 2.

On the CPU the stride-1 path is the autograd function around the kernel's
plain version (dx: the same conv of the padded gradient with the flipped
taps; dw: the per-tap f32 reduction); stride 2 is the grouped conv and its
autograd. f32, 1e-5 relative to the largest |gradient|: the same sums in
other orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixelpick_tpu.ops.depthwise import depthwise_conv3x3 as jax_dw
from pixelpick_tpu_torch.ops import depthwise as dw


@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("stride,dilation", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_gradients_match_jax_vjp(stride, dilation, padding):
    rng = np.random.default_rng(10 * stride + dilation + padding)
    x = rng.standard_normal((2, 13, 15, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8)) / 3).astype(np.float32)

    def f(x_, w_):
        return jax_dw(x_, w_, stride, dilation, padding, True)

    y, pull = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(y.shape).astype(np.float32)
    dx_ref, dw_ref = (np.asarray(a) for a in pull(jnp.asarray(g)))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    dw.reset_launch_counts()
    yt = dw.depthwise_conv3x3(xt, wt, stride, dilation, padding)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(y)).max())
    yt.backward(torch.from_numpy(g))
    for got, ref in ((xt.grad, dx_ref), (wt.grad, dw_ref)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert dw.launch_counts["kernel"] == dw.launch_counts["kernel_dx"] == 0
    assert dw.launch_counts["stride2_conv"] == (1 if stride == 2 else 0)
