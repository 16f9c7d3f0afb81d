"""Train-mode (ghost) BatchNorm of the port (models/layers.py:BatchNorm)
against the JAX package's ``_BNCore``: whole-batch moments (groups 0),
groups that divide the batch, groups that do not (whole-batch fallback),
and the 1x1 map of ASPP's pooled branch, where the biased and unbiased
variances differ by 4/3 at batch 4.

Three train-mode calls on fresh inputs, then the running statistics. f32:
outputs and statistics 1e-5 relative to their largest |value| (the same f32
sums in other orders); bf16 outputs one bf16 ulp (2**-7 relative).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixelpick_tpu.models.layers import _BNCore
from pixelpick_tpu_torch.models import layers

C = 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [
    ((6, 5, 7), 0), ((6, 5, 7), 2), ((6, 5, 7), 4), ((4, 1, 1), 0),
])
def test_ghost_bn_and_running_stats_match_bncore(shape, groups, dtype):
    b, h, w = shape
    rng = np.random.default_rng(groups + 10 * h)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    core = _BNCore(dtype=jdt, groups=groups)
    x0 = jnp.zeros((b, h, w, C), jdt)
    v = core.init(jax.random.PRNGKey(0), x0, use_running_average=True)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": v["batch_stats"]}
    bn = layers.BatchNorm(C, dtype=tdt, groups=groups)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()

    for step in range(3):
        x = (2.0 + 3.0 * rng.standard_normal((b, h, w, C))).astype(np.float32)
        yj, mut = core.apply(v, jnp.asarray(x, jdt), use_running_average=False,
                             mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
        with torch.no_grad():
            yt = bn(xt).permute(0, 2, 3, 1)
        assert yt.dtype == tdt
        ref = np.asarray(yj.astype(jnp.float32))
        tol = 1e-5 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(yt.float().numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
    stats = v["batch_stats"]
    for name, ref in (("running_mean", stats["mean"]),
                      ("running_var", stats["var"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(getattr(bn, name).numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)
    assert int(bn.num_batches_tracked) == 3


def test_ghost_bn_gradient_matches_jax():
    """The train-mode gradient through the group moments, f32."""
    from pixelpick_tpu.models.layers import ghost_bn_train as jax_ghost_bn

    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 3, 4, C)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)

    def f(x_, s_, b_):
        return jax_ghost_bn(x_, s_, b_, 4, 1e-5, jnp.float32)[0]

    _, pull = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    refs = pull(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x.transpose(0, 3, 1, 2).copy(), scale, bias)]
    y = layers.ghost_bn_train(*leaves, 4, 1e-5, torch.float32)[0]
    got = torch.autograd.grad(y, leaves,
                              torch.from_numpy(dy).permute(0, 3, 1, 2))
    got = [got[0].permute(0, 2, 3, 1), got[1], got[2]]
    for a, r in zip(got, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())
