"""Shared fixtures of the PyTorch-port tests: JAX DeepLab variables with
random BatchNorm statistics, as NumPy trees, for the weight bridge; and the
train-step tests' sparse batches, SGD settings, well-conditioned weights
and ReLU-kink margin recorder (tests/test_torch_train_step.py says why)."""

from types import SimpleNamespace

import numpy as np
import pytest

N_CLASSES, HW, BS, K = 11, (48, 64), 4, 12


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


def sparse_batches(n, seed=0, bs=BS):
    """Random picks on images of distinct content: an 8x8-pixel random
    mosaic per image, plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        valid = rng.random((bs, K)) < 0.8
        valid[:, 0] = True
        mosaic = np.kron(rng.uniform(0, 255, (bs, HW[0] // 8, HW[1] // 8, 3)),
                         np.ones((1, 8, 8, 1)))
        x = mosaic + rng.normal(0, 20, (bs, *HW, 3))
        out.append({
            "x": np.clip(x, 0, 255).astype(np.uint8),
            "coords": np.stack([rng.integers(0, HW[0], (bs, K)),
                                rng.integers(0, HW[1], (bs, K))],
                               -1).astype(np.int32),
            "labels": rng.integers(0, N_CLASSES, (bs, K)).astype(np.int32),
            "valid": valid,
        })
    return out


def sgd_args():
    """SGD (the table's rates: backbone 1e-3, heads 1e-2; momentum 0.9,
    coupled weight decay 5e-4) under the MultiStep schedule."""
    return SimpleNamespace(
        optimizer_type="SGD", lr_scheduler_type="MultiStepLR", n_epochs=50,
        optimizer_params={"lr": 5e-4}, dataset_name="cv",
        network_name="deeplab")


def well_conditioned(tree, rng):
    """BatchNorm scale in [0.3, 0.6] and bias in [2.5, 3.5]; every conv
    kernel (HWIO) minus its mean over its inputs."""
    if "scale" in tree and "bias" in tree:
        c = tree["scale"].shape[0]
        return {"scale": rng.uniform(0.3, 0.6, c).astype(np.float32),
                "bias": rng.uniform(2.5, 3.5, c).astype(np.float32)}
    out = {k: well_conditioned(v, rng) if isinstance(v, dict) else v
           for k, v in tree.items()}
    if "kernel" in out and out["kernel"].ndim == 4:
        k = out["kernel"]
        out["kernel"] = (k - k.mean((0, 1, 2), keepdims=True)) \
            .astype(np.float32)
    return out


def record_kink_margins(monkeypatch):
    """Record, for every train-mode BatchNorm output of the port (the
    inputs of its ReLUs and ReLU6s), the least distance to 0 or 6."""
    import torch

    from pixelpick_tpu_torch.models import layers
    from pixelpick_tpu_torch.ops import fused_ir

    margins = []

    def margin(y):
        y = y.detach().float()
        margins.append(float(torch.minimum(y.abs(), (y - 6).abs()).min()))

    bn_train, fused_bn = layers.ghost_bn_train, fused_ir._bn

    def bn_recorded(*a):
        out = bn_train(*a)
        margin(out[0])
        return out

    def fused_bn_recorded(*a):
        out = fused_bn(*a)
        margin(out)
        return out

    monkeypatch.setattr(layers, "ghost_bn_train", bn_recorded)
    monkeypatch.setattr(fused_ir, "_bn", fused_bn_recorded)
    return margins


@pytest.fixture
def few_torch_threads():
    """Two intra-op threads for the test: these small models gain nothing
    from more, and the suite runs several workers on one host's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        yield
    finally:
        torch.set_num_threads(n)


def custom_camvid(root, n_train=8, n_val=2, seed=0):
    """tests/helpers.py's synthetic CamVid at 48x64 in the custom-dataset
    layout ({train,val}{,annot}/) and its dataset config; returns the
    config's path."""
    import os

    import yaml

    from tests.helpers import make_synthetic_camvid

    ds = make_synthetic_camvid(str(root / "ds"), n_train=n_train,
                               n_test=n_val, seed=seed)
    os.rename(f"{ds}/test", f"{ds}/val")
    os.rename(f"{ds}/testannot", f"{ds}/valannot")
    cfg = dict(dataset_name="custom", dir_dataset=ds, batch_size=4,
               crop_size=list(HW), ignore_index=11, n_classes=N_CLASSES,
               n_epochs=1, mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25],
               optimizer_type="Adam", lr_scheduler_type="MultiStepLR",
               optimizer_params={"lr": 5e-4, "betas": [0.9, 0.999],
                                 "weight_decay": 2e-4, "eps": 1e-7})
    path = root / "custom.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path
