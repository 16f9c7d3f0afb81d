"""Shared fixtures of the PyTorch-port tests: JAX DeepLab variables with
random BatchNorm statistics, as NumPy trees, for the weight bridge."""

import numpy as np


def randomise_bn(tree, rng):
    """Random BN statistics and scale/bias (eval BN at its init is near
    identity, which would hide a wrong BN and breed score ties)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomise_bn(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def jax_deeplab_variables(n_classes, width_mult, hw, seed=0):
    """(params, batch_stats) of a JAX DeepLab, NumPy trees."""
    import jax
    import jax.numpy as jnp

    from pixelpick_tpu.models.deeplab import DeepLab

    model = DeepLab(n_classes=n_classes, width_mult=width_mult)
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, x, train=False))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    params = randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng)
    stats = randomise_bn(jax.tree.map(np.asarray, variables["batch_stats"]),
                         rng)
    return params, stats


def port_deeplab(params, stats, n_classes, width_mult):
    """The port's DeepLab at the JAX weights, CPU, eval, channels_last."""
    import torch

    from pixelpick_tpu_torch.models.convert import state_dict_from_jax
    from pixelpick_tpu_torch.models.deeplab import DeepLab

    model = DeepLab(n_classes, width_mult=width_mult)
    model.load_state_dict(state_dict_from_jax(params, stats))
    return model.to(memory_format=torch.channels_last).eval()
