"""The port's FPN on a ResNet (models/resnet.py, models/fpn.py, the FPN
branch of models/factory.py, the FPN tree in models/convert.py and the
convert CLI) against the JAX package's, on the CPU.

- Forward: ResNet-18 (BasicBlock) and ResNet-50 (Bottleneck) at width
  0.25, dilated, at 64x64 and at 48x64 (not a multiple of 32), on the same
  variables carried across by ``state_dict_from_jax``: ``pred`` and ``emb``
  within 1e-4 of their largest |value| in f32; in bf16 within 3e-2 (both
  packages compute in bf16 with f32 GroupNorm outputs, and round at other
  places inside convolutions). The stride-32 encoder (``dilate_scale`` 0,
  and the deep-base stem) feature by feature within 1e-4; its FPN is
  refused by both packages, whose 3/3/3/2 chains need strides 4/8/8/8.
- ``get_model`` builds the FPN for ResNet 18, 34, 50 and 101, dilated or
  not, with exactly the JAX model's variable tree (names and shapes).
- The weight bridge: the port's ``state_dict`` through JAX's
  ``convert_fpnseg`` gives back the source tree leaf for leaf; a
  ``flax.serialization``-written ``--kind resnet`` file overlays exactly
  the encoder's entries, a whole-FPN file every entry.
- The torchvision and MoCo-v2 key surgery equal JAX's on random state
  dicts; the port's convert CLI writes, for each ``--kind``, a file that
  ``flax.serialization.msgpack_restore`` reads back to the tree JAX's
  ``main`` writes from the same ``.pth``, exactly.

One JAX ResNet-50 init (and one ResNet-18) serves every test; the train
steps are in tests/test_torch_fpn_train.py.
"""

import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelpick_tpu.config import default_args as jax_default_args
from pixelpick_tpu.models import convert as jax_convert
from pixelpick_tpu.models.factory import get_model as jax_get_model
from pixelpick_tpu.models.fpn import FPNSeg as JaxFPNSeg
from pixelpick_tpu.models.resnet import ResNetBackbone as JaxResNet
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.engine.flax_msgpack import flatten
from pixelpick_tpu_torch.models import convert
from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.models.factory import get_model, init_model
from pixelpick_tpu_torch.models.fpn import FPNSeg
from pixelpick_tpu_torch.models.resnet import ResNetBackbone
from torch_helpers import jax_fpn_variables, randomise_bn
from torch_helpers import port_fpn as port_fpn_at
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

N_CLASSES, WIDTH = 5, 0.25
pytestmark = pytest.mark.usefixtures("few_torch_threads")


def jax_variables(n_layers: int):
    return jax_fpn_variables(N_CLASSES, n_layers, WIDTH)


def port_fpn(params, stats, n_layers, dtype=torch.float32):
    return port_fpn_at(params, stats, N_CLASSES, n_layers, WIDTH, dtype)


def _images(hw, seed=0, bs=2):
    return np.random.default_rng(seed).standard_normal(
        (bs, *hw, 3)).astype(np.float32)


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("n_layers,hw,dtype,tol", [
    (18, (64, 64), "f32", 1e-4), (18, (48, 64), "f32", 1e-4),
    (50, (64, 64), "f32", 1e-4), (50, (48, 64), "f32", 1e-4),
    (18, (48, 64), "bf16", 3e-2), (50, (48, 64), "bf16", 3e-2)])
def test_fpn_forward_matches_jax(n_layers, hw, dtype, tol):
    params, stats = jax_variables(n_layers)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    x = _images(hw)
    jax_model = JaxFPNSeg(n_classes=N_CLASSES, n_layers=n_layers,
                          width_multiplier=WIDTH, dtype=jdt)
    ref = jax.jit(lambda v, z: jax_model.apply(v, z, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        out = port_fpn(params, stats, n_layers, tdt)(torch.from_numpy(x))
    for k in ("pred", "emb"):
        assert out[k].dtype == torch.float32
        assert tuple(out[k].shape) == ref[k].shape
        err = _rel_err(out[k].numpy(), ref[k])
        assert err <= tol, f"{k}: {err} > {tol}"


@pytest.mark.parametrize("n_layers,deep_base", [(18, False), (50, True)])
def test_stride32_encoder_matches_jax(n_layers, deep_base):
    jax_model = JaxResNet(n_layers=n_layers, dilate_scale=0,
                          width_multiplier=WIDTH, deep_base=deep_base)
    x = _images((48, 64), seed=1)
    v = jax.jit(lambda k: jax_model.init(k, jnp.asarray(x), train=False))(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    params = randomise_bn(jax.tree.map(np.asarray, v["params"]), rng)
    stats = randomise_bn(jax.tree.map(np.asarray, v["batch_stats"]), rng)
    ref = jax.jit(lambda v, z: jax_model.apply(v, z, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    sd = convert.state_dict_from_jax({"encoder": params},
                                     {"encoder": stats})
    model = ResNetBackbone(n_layers, 0, WIDTH, deep_base=deep_base)
    model.load_state_dict({k[len("encoder.base."):]: v
                           for k, v in sd.items()})
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        feats = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, (f, r) in enumerate(zip(feats, ref)):
        got = f.permute(0, 2, 3, 1).numpy()
        assert got.shape == r.shape, (i, got.shape, r.shape)
        assert _rel_err(got, r) <= 1e-4, f"c{i + 2}"


@pytest.mark.parametrize("hw", [(64, 64), (48, 64)])
def test_stride32_fpn_refused_like_jax(hw):
    """The decoder's chains bring p5/p4/p3/p2 to different sizes at output
    stride 32; JAX's sum fails, and the port refuses at the same place."""
    x = _images(hw, bs=1)
    jax_model = JaxFPNSeg(n_classes=N_CLASSES, n_layers=18,
                          width_multiplier=WIDTH, dilate_scale=0)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda z: jax_model.init(jax.random.PRNGKey(0), z,
                                                train=False), x)
    model = FPNSeg(N_CLASSES, 18, WIDTH, dilate_scale=0).eval()
    with pytest.raises(ValueError, match="dilated"), torch.no_grad():
        model(torch.from_numpy(x))


@pytest.mark.parametrize("n_layers", [18, 34, 50, 101])
@pytest.mark.parametrize("dilated", [True, False])
def test_get_model_builds_the_jax_tree(n_layers, dilated):
    kw = dict(network_name="FPN", n_layers=n_layers,
              use_dilated_resnet=dilated)
    model = get_model(default_args("voc", device="cpu", **kw))
    assert isinstance(model, FPNSeg) and not model.training
    stride1 = [m.stride for m in model.encoder.base.layer4.modules()
               if getattr(m, "stride", None) is not None]
    assert (max(stride1) == 1) == dilated
    params, stats, skipped = convert.jax_tree_from_state_dict(
        model.state_dict())
    assert not skipped
    # JAX's init runs the forward, which fails without dilation (above);
    # its variable tree does not depend on the dilation
    jax_model = jax_get_model(jax_default_args(
        "voc", **dict(kw, use_dilated_resnet=True)))
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    for ours, ref in ((params, shapes["params"]),
                      (stats, shapes["batch_stats"])):
        ref = {k: tuple(v.shape) for k, v in flatten(ref).items()}
        assert {k: v.shape for k, v in flatten(ours).items()} == ref
    # the encoder's kernels are fan-out, the decoder's fan-in: two 1x1
    # convs whose outputs and inputs differ in width
    for w, fan in ((model.encoder.base.layer2[0].downsample[0].weight, 0),
                   (model.decoder.lat_layer_0.weight, 1)):
        std = (2 / w.shape[fan]) ** 0.5
        assert abs(float(w.detach().std()) - std) < 0.05 * std


def _leaves_equal(a: dict, b: dict) -> None:
    fa, fb = flatten(a), flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg="/".join(k))


@pytest.mark.parametrize("n_layers", [18, 50])
def test_state_dict_round_trips_through_convert_fpnseg(n_layers):
    params, stats = jax_variables(n_layers)
    sd = port_fpn(params, stats, n_layers).state_dict()
    p2, s2 = jax_convert.convert_fpnseg(
        {k: v.numpy() for k, v in sd.items()}, N_CLASSES, n_layers)
    _leaves_equal(p2, params)
    _leaves_equal(s2, stats)
    p3, s3, skipped = convert.jax_tree_from_state_dict(sd)
    assert not skipped
    _leaves_equal(p3, params)
    _leaves_equal(s3, {k: v for k, v in stats.items() if v})


def test_resnet_file_overlays_the_encoder(tmp_path):
    params, stats = jax_variables(50)
    path = tmp_path / "resnet.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize({
        "params": {"encoder": params["encoder"]},
        "batch_stats": {"encoder": stats["encoder"]}}))
    model = init_model(FPNSeg(N_CLASSES, 50, WIDTH), 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    done = convert.load_pretrained_ckpt(model, str(path))
    encoder = {k for k in before if k.startswith("encoder.")}
    assert set(done) == encoder
    want = convert.state_dict_from_jax({"encoder": params["encoder"]},
                                       {"encoder": stats["encoder"]})
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k] if k in encoder else before[k],
                                   rtol=0, atol=0, msg=k)
    # a whole-FPN file overlays every entry
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"params": params, "batch_stats": stats}))
    assert set(convert.load_pretrained_ckpt(model, str(path))) == set(before)


def _torchvision_state(seed=0):
    """A random state dict in torchvision's ResNet-50 layout (width 1 keys,
    width 0.25 shapes), with its classifier."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in ResNetBackbone(50, 8, WIDTH).state_dict().items():
        k = k.replace("prefix.", "")
        sd[k] = v.clone() if v.dtype == torch.long \
            else torch.randn(v.shape, generator=g)
    sd["fc.weight"] = torch.randn(10, 512, generator=g)
    sd["fc.bias"] = torch.randn(10, generator=g)
    return sd


def test_key_surgery_matches_jax():
    tv = _torchvision_state()
    moco = {f"module.encoder_q.{k}": v for k, v in tv.items()
            if not k.startswith("fc.")}
    moco["module.encoder_q.fc.0.weight"] = torch.zeros(4, 512)
    moco["module.encoder_q.fc.2.bias"] = torch.zeros(4)
    moco["module.queue"] = torch.zeros(4, 8)
    for ours, ref, state in (
            (convert.adapt_torchvision_resnet_keys,
             jax_convert.adapt_torchvision_resnet_keys, tv),
            (convert.adapt_moco_v2_keys, jax_convert.adapt_moco_v2_keys,
             moco)):
        got, want = ours(state), ref(state)
        assert list(got) == list(want)
        assert all(got[k] is want[k] for k in got)
    assert "prefix.conv1.weight" in got and not any("fc" in k for k in got)


def _cli_inputs():
    fpn = port_fpn(*jax_variables(50), 50).state_dict()
    dl = DeepLab(N_CLASSES, width_mult=0.5).state_dict()
    mnv2 = {k[len("backbone."):]: v for k, v in dl.items()
            if k.startswith("backbone.")}
    mnv2["features.18.0.weight"] = torch.zeros(8, 4, 1, 1)
    mnv2["classifier.1.weight"] = torch.zeros(3, 8)
    tv = _torchvision_state(1)
    moco = {"state_dict": {f"module.encoder_q.{k}": v
                           for k, v in tv.items()}}
    return {"resnet": (tv, []), "moco_v2": (moco, ["--weight_type",
                                                   "moco_v2"]),
            "fpn": (fpn, []), "deeplab": ({"model": dl}, []),
            "mobilenet_v2": (mnv2, [])}


@pytest.mark.parametrize("name", ["resnet", "moco_v2", "fpn", "deeplab",
                                  "mobilenet_v2"])
def test_convert_cli_matches_jax(tmp_path, monkeypatch, name):
    state, extra = _cli_inputs()[name]
    kind = "resnet" if name == "moco_v2" else name
    src = tmp_path / "src.pth"
    torch.save(state, src)
    monkeypatch.setattr(sys, "argv", [
        "convert", str(src), str(tmp_path / "jax.ckpt"), "--kind", kind,
        "--n_classes", str(N_CLASSES), *extra])
    jax_convert.main()
    convert.main([str(src), str(tmp_path / "port.ckpt"), "--kind", kind,
                  *extra])
    want = flax.serialization.msgpack_restore(
        (tmp_path / "jax.ckpt").read_bytes())
    got = flax.serialization.msgpack_restore(
        (tmp_path / "port.ckpt").read_bytes())
    want["batch_stats"] = {k: v for k, v in want["batch_stats"].items() if v}
    _leaves_equal(got, want)
    for k, v in flatten(got).items():
        assert v.dtype == np.float32, k
