"""``--pretrained_ckpt`` in the port (``pixelpick_tpu_torch/models/
convert.py:load_pretrained_ckpt``) against the JAX package's overlay
(``pixelpick_tpu/models/convert.py:load_pretrained_ckpt``, ``overlay_tree``).

The files are written by the JAX package's converter CLI
(``python -m pixelpick_tpu.models.convert``, ``--kind deeplab`` and
``--kind mobilenet_v2``) from the port's own ``state_dict``, which is the
reference's torch layout the converter reads. Both packages overlay the
same file on a fresh model (width 0.5): the port's round-0 model must hold
the file's values on exactly the tensors whose JAX leaves the JAX overlay
replaced, and its own init everywhere else, bit for bit (the values are
copied, not computed). A classifier with another ``n_classes`` keeps its
init in both.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from pixelpick_tpu.config import default_args as jax_default_args
from pixelpick_tpu.models import get_model as jax_get_model, init_model
from pixelpick_tpu.models import convert as jax_convert
from pixelpick_tpu_torch.active.driver import round_seed
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.engine.flax_msgpack import flatten
from pixelpick_tpu_torch.models.convert import (
    load_pretrained_ckpt, state_dict_from_jax,
)
from pixelpick_tpu_torch.models.factory import get_model

WIDTH, HW, SEED = 0.5, (48, 64), 3


def convert_with_jax_cli(tmp_path, monkeypatch, kind):
    """The port's 11-class model, every tensor moved off its init (BatchNorm
    starts at the same values in both packages), saved as torch and
    converted by the JAX CLI."""
    src = get_model(default_args(device="cpu", width_multiplier=WIDTH),
                    "cpu", seed=99)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for k, v in src.state_dict().items():
            if k.endswith("running_var"):
                v.uniform_(0.5, 2.0, generator=gen)
            elif v.is_floating_point():
                v.add_(0.1 * torch.randn(v.shape, generator=gen))
    sd = src.backbone.state_dict() if kind == "mobilenet_v2" \
        else {"model": src.state_dict()}
    p_src, p_dst = tmp_path / f"{kind}.pth", tmp_path / f"{kind}.ckpt"
    torch.save(sd, p_src)
    monkeypatch.setattr(sys, "argv", ["convert", str(p_src), str(p_dst),
                                      "--kind", kind])
    jax_convert.main()
    return str(p_dst)


def jax_overlay(path, n_classes):
    """The JAX package's round model overlaid with the file: the overlaid
    leaves (path -> value) as two partial trees, params and batch_stats."""
    args = jax_default_args("cv", width_multiplier=WIDTH, n_classes=n_classes)
    params, stats = init_model(jax_get_model(args), jax.random.PRNGKey(0), HW)
    new_p, new_s = jax_convert.load_pretrained_ckpt(params, stats, path)
    parts = []
    for old, new in ((params, new_p), (stats, new_s)):
        part = {}
        for p, v in flatten(jax.tree.map(np.asarray, new)).items():
            if not np.array_equal(v, np.asarray(flatten(old)[p])):
                node = part
                for k in p[:-1]:
                    node = node.setdefault(k, {})
                node[p[-1]] = v
        parts.append(part)
    return parts


@pytest.mark.parametrize("kind,n_classes", [
    ("deeplab", 11), ("mobilenet_v2", 11), ("deeplab", 5)])
def test_overlay_matches_jax(tmp_path, monkeypatch, kind, n_classes):
    path = convert_with_jax_cli(tmp_path, monkeypatch, kind)
    want = state_dict_from_jax(*jax_overlay(path, n_classes))

    args = default_args(device="cpu", width_multiplier=WIDTH,
                        n_classes=n_classes)
    seed = round_seed(SEED, 0)
    fresh = get_model(args, "cpu", seed=seed).state_dict()
    model = get_model(args, "cpu", seed=seed)
    done = load_pretrained_ckpt(model, path)
    got = model.state_dict()

    # the same tensors as JAX's overlay (BatchNorm's step counters, which
    # JAX has no leaf for, come with their module's statistics)
    assert set(done) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k] if k in want else fresh[k]), k
    changed = {k for k in got if k in want and not k.endswith(
        "num_batches_tracked")}
    if kind == "mobilenet_v2":
        assert changed == {k for k in got if k.startswith("backbone.")
                           and not k.endswith("num_batches_tracked")}
    elif n_classes == 11:
        assert changed == {k for k in got
                           if not k.endswith("num_batches_tracked")}
    else:  # the classifier alone keeps its init
        assert {k for k in got if k not in want} == {
            "seg_head.classifier.weight", "seg_head.classifier.bias"}
