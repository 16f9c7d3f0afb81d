"""The port's rewrites of the same-shape 3x3 convolution
(pixelpick_tpu_torch/models/layers.py: ``Conv3x3MatMul``,
``conv3x3_wgrad_mm``/``Conv3x3WgradMM``, ``set_conv3x3_impl``, the
``conv()`` dispatch; ``--conv3x3_matmul`` through ``config.finalize_args``)
against the JAX package's, on the CPU.

Tolerances: one conv in f32, the output and the gradients of x, the kernel
and the bias within 1e-5 of each one's largest |value| (the same products
summed in other orders); in bf16 the output within 2**-7 of its largest
|value| plus the f32 rounding (one bf16 ulp: both sides accumulate in f32
and round once). Whole models in eval mode: DeepLab's and the FPN's
``pred`` and ``emb`` within 1e-4 of their largest |value|, as
``tests/test_torch_model.py`` and ``tests/test_torch_fpn.py`` hold the
library path; one DeepLab train step's loss within 1e-5 relative and every
parameter gradient within 1e-4 of its own largest |value| plus 1e-5 of the
step's largest gradient (``tests/test_torch_s2d.py`` says why the floor).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelpick_tpu.engine import trainer as jax_trainer
from pixelpick_tpu.models import layers as jax_layers
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu.models.fpn import FPNSeg as JaxFPNSeg
from pixelpick_tpu_torch import config
from pixelpick_tpu_torch.engine import trainer
from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.models.deeplab import DeepLab
from torch_helpers import (
    HW, N_CLASSES, jax_deeplab_variables, jax_fpn_variables, port_fpn,
    sparse_batches, well_conditioned,
)

WIDTH = 0.5
MEAN, STD = (0.41, 0.43, 0.44), (0.28, 0.29, 0.29)
JAX_MODULES = {"matmul": jax_layers.Conv3x3MatMul,
               "wgradmm": jax_layers.Conv3x3WgradMM}
PORT_MODULES = {"matmul": layers.Conv3x3MatMul,
                "wgradmm": layers.Conv3x3WgradMM}


@pytest.fixture
def conv3x3_impl():
    """Set both packages' process-global switch for one test, then put
    the default back."""
    def use(name):
        jax_layers.set_conv3x3_impl(name)
        layers.set_conv3x3_impl(name)

    yield use
    jax_layers.set_conv3x3_impl("xla")
    layers.set_conv3x3_impl("xla")


def rel_close(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("impl", ["matmul", "wgradmm"])
@pytest.mark.parametrize("dilation,bias", [(1, False), (1, True), (2, False),
                                           (2, True)])
def test_conv3x3_matches_jax(impl, dilation, bias):
    """One conv, f32: the output, and the gradients of x, the kernel and
    the bias under a random cotangent."""
    rng = np.random.default_rng(dilation + 2 * bias)
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    cot = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    jmod = JAX_MODULES[impl](features=5, dilation=dilation, use_bias=bias)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if bias:
        v = {"params": {**v["params"], "bias": jnp.asarray(
            rng.standard_normal(5).astype(np.float32))}}

    def f(v_, x_):
        return jnp.sum(jmod.apply(v_, x_) * cot)

    y_ref = jmod.apply(v, jnp.asarray(x))
    gv, gx = jax.grad(f, argnums=(0, 1))(v, jnp.asarray(x))

    m = PORT_MODULES[impl](6, 5, dilation, bias)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        if bias:
            m.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = m(xt)
    assert y.shape == (2, 5, 9, 11)
    rel_close(y.detach().permute(0, 2, 3, 1).numpy(), y_ref, 1e-5, "y")
    grads = torch.autograd.grad(
        (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum(),
        [xt, *m.parameters()])
    rel_close(grads[0].permute(0, 2, 3, 1).numpy(), gx, 1e-5, "dx")
    rel_close(grads[1].numpy(),
              np.asarray(gv["params"]["kernel"]).transpose(3, 2, 0, 1),
              1e-5, "dkernel")
    if bias:
        rel_close(grads[2].numpy(), gv["params"]["bias"], 1e-5, "dbias")


@pytest.mark.parametrize("impl", ["matmul", "wgradmm"])
def test_conv3x3_bf16_matches_jax(impl):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 10, 6)).astype(np.float32)
    jmod = JAX_MODULES[impl](features=4, dilation=2, use_bias=True,
                             dtype=jnp.bfloat16)
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = {"params": {**v["params"], "bias": jnp.asarray(
        rng.standard_normal(4).astype(np.float32))}}
    ref = np.asarray(jmod.apply(v, jnp.asarray(x)).astype(jnp.float32))
    m = PORT_MODULES[impl](6, 4, 2, True, dtype=torch.bfloat16)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        m.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
        y = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert y.dtype == torch.bfloat16
    rel_close(y.float().permute(0, 2, 3, 1).numpy(), ref, 2 ** -7 + 1e-5)


def test_conv_dispatch_follows_jax_conditions(conv3x3_impl):
    """3x3, stride 1, groups 1 and padding == dilation take the rewrite;
    anything else keeps its module, as ``layers.py:269-321`` decides."""
    for impl, cls in PORT_MODULES.items():
        conv3x3_impl(impl)
        assert type(layers.conv(4, 8, 3, padding=1)) is cls
        assert type(layers.conv(4, 8, 3, padding=2, dilation=2,
                                bias=True)) is cls
        for kw in (dict(stride=2, padding=1), dict(padding=2),
                   dict(padding=1, groups=4), dict(padding=0)):
            out = 4 if "groups" in kw else 8
            assert type(layers.conv(4, out, 3, **kw)) is layers.Conv2d, kw
        assert type(layers.conv(4, 8, 1)) is layers.Conv1x1
    conv3x3_impl("xla")
    assert type(layers.conv(4, 8, 3, padding=1)) is layers.Conv2d
    with pytest.raises(ValueError):
        layers.set_conv3x3_impl("pallas")


def test_flag_sets_the_switch(tmp_path, conv3x3_impl):
    """``--conv3x3_matmul`` passes the check and ``finalize_args`` sets
    ``set_conv3x3_impl('matmul')``, as the JAX package's does."""
    args = config.build_parser().parse_args(
        ["--conv3x3_matmul", "--s2d_backbone", "true", "--device", "cpu",
         "--dir_checkpoints", str(tmp_path)])
    config.finalize_args(args, write_files=False)
    assert layers._CONV3X3_IMPL == "matmul"
    assert type(layers.conv(4, 8, 3, padding=1)) is layers.Conv3x3MatMul


@pytest.mark.parametrize("impl", ["matmul", "wgradmm"])
def test_deeplab_eval_matches_jax(impl, conv3x3_impl):
    """DeepLab in eval mode with every same-shape 3x3 (ASPP's atrous
    branches, the head) rewritten, in both packages."""
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW, seed=3)
    x = np.random.default_rng(4).standard_normal((2, *HW, 3)) \
        .astype(np.float32)
    conv3x3_impl(impl)
    ref = jax.jit(lambda v, z: JaxDeepLab(
        n_classes=N_CLASSES, width_mult=WIDTH).apply(v, z, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = DeepLab(N_CLASSES, width_mult=WIDTH)
    model.load_state_dict(state_dict_from_jax(params, stats))
    n = sum(isinstance(m, PORT_MODULES[impl]) for m in model.modules())
    assert n == 5  # ASPP's three atrous branches, the head's two convs
    with torch.no_grad():
        out = model.to(memory_format=torch.channels_last).eval()(
            torch.from_numpy(x))
    for k in ("pred", "emb"):
        rel_close(out[k].numpy(), ref[k], 1e-4, k)


@pytest.mark.parametrize("n_layers", [18, 50])
def test_fpn_eval_matches_jax(n_layers, conv3x3_impl):
    """The dilated FPN under ``matmul``: the ResNet's same-shape 3x3s, the
    deep-base stem's stride-1 ones and the decoder's, in both packages."""
    params, stats = jax_fpn_variables(5, n_layers, 0.25)
    x = np.random.default_rng(5).standard_normal((2, 48, 64, 3)) \
        .astype(np.float32)
    conv3x3_impl("matmul")
    ref = jax.jit(lambda v, z: JaxFPNSeg(
        n_classes=5, n_layers=n_layers, width_multiplier=0.25).apply(
        v, z, train=False))({"params": params, "batch_stats": stats},
                            jnp.asarray(x))
    model = port_fpn(params, stats, 5, n_layers, 0.25)
    assert any(isinstance(m, layers.Conv3x3MatMul) for m in model.modules())
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for k in ("pred", "emb"):
        rel_close(out[k].numpy(), ref[k], 1e-4, k)


def test_deeplab_train_step_gradients_match_jax(conv3x3_impl, monkeypatch):
    """One train step of DeepLab under ``matmul`` at well-conditioned
    weights: the loss and every parameter gradient, JAX against the
    port."""
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW, seed=2)
    params = well_conditioned(params, np.random.default_rng(102))
    batch = sparse_batches(1)[0]
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    conv3x3_impl("matmul")
    loss_fn = jax_trainer._sparse_loss_fn(
        JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH),
        n_classes=N_CLASSES, mean=MEAN, std=STD, normalize=True,
        gather_impl="matmul")
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    ref = state_dict_from_jax(jax.tree.map(np.asarray, grads_j), {})
    model = DeepLab(N_CLASSES, width_mult=WIDTH)
    model.load_state_dict(state_dict_from_jax(params, stats))
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    model = model.to(memory_format=torch.channels_last).train()
    x = trainer.normalize_images(torch.from_numpy(batch["x"]), MEAN, STD)
    loss, _ = trainer.sparse_ce_and_hist(
        model(x, upsample=False)["pred"], torch.from_numpy(batch["coords"]),
        torch.from_numpy(batch["labels"]), torch.from_numpy(batch["valid"]),
        HW, N_CLASSES)
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    loss, loss_j = float(loss.detach()), float(loss_j)
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j)
    gmax = max(float(ref[n].abs().max()) for n in grads)
    for n, g in grads.items():
        err = float((g - ref[n]).abs().max())
        tol = 1e-4 * float(ref[n].abs().max()) + 1e-5 * gmax
        assert err <= tol, f"grad {n}: {err} > {tol}"
