"""The plain reference against the port, at small widths on the CPU, from
one weight dict the benchmark makes."""

import json

import pytest
import torch

from pb import weights
from reference import nets, steps
from tests_paths import CONFIGS


def small(name, **kw):
    c = json.loads((CONFIGS / f"{name}.json").read_text())
    c.update(kw)
    return c


def port_model(c):
    from pixelpick_tpu_torch.models.deeplab import DeepLab
    from pixelpick_tpu_torch.models.fpn import FPNSeg

    if c["network"] == "deeplab":
        return DeepLab(c["n_classes"], width_mult=c["width_multiplier"],
                       fused_ir=True)
    return FPNSeg(c["n_classes"], 50, width_multiplier=c["width_multiplier"])


CASES = [("mv2dl_camvid", dict(width_multiplier=0.5), (64, 96)),
         ("r50fpn_voc", dict(width_multiplier=0.25), (64, 64))]


@pytest.mark.parametrize("name,kw,hw", CASES)
def test_forward_matches_the_port(name, kw, hw):
    c = small(name, **kw)
    w = weights.make(c, 7, "cpu")
    x = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    m = port_model(c)
    m.load_state_dict(w)
    xn = steps.normalise(x, c)
    for train in (False, True):
        m.train(train)
        m.set_dropout_generator(torch.Generator().manual_seed(3))
        with torch.no_grad():
            got = m(xn.permute(0, 2, 3, 1), upsample=False)["pred"]
            want = nets.forward(nets.Ctx(
                w, train, torch.Generator().manual_seed(3)), xn, c)
        got = got.permute(0, 3, 1, 2)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale, train


@pytest.mark.parametrize("name,kw,hw", CASES)
def test_classifier_gradient_matches_the_port(name, kw, hw):
    """The sparse loss and its gradient at the classifier, the leaf next to
    the loss (deeper leaves' small gradients are rounding-dominated in f32
    at these sizes, in the reference itself)."""
    c = small(name, **kw)
    w = weights.make(c, 11, "cpu")
    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8, generator=g)
    coords = torch.stack([torch.randint(0, hw[0], (2, 20), generator=g),
                          torch.randint(0, hw[1], (2, 20), generator=g)], -1)
    labels = torch.randint(0, c["n_classes"], (2, 20), generator=g)
    valid = torch.rand((2, 20), generator=g) < 0.8
    batch = {"x": x, "coords": coords.int(), "labels": labels.int(),
             "valid": valid}
    ref = steps.train_steps(w, [batch], c, dropout_seed=5)

    from pixelpick_tpu_torch.engine.trainer import sparse_ce_and_hist

    m = port_model(c).train()
    m.load_state_dict(w)
    m.set_dropout_generator(torch.Generator().manual_seed(5))
    out = m(steps.normalise(x, c).permute(0, 2, 3, 1), upsample=False)
    loss, _ = sparse_ce_and_hist(out["pred"], batch["coords"],
                                 batch["labels"], valid, hw,
                                 c["n_classes"])
    loss.backward()
    first = ref["losses"][0]
    assert abs(float(loss.detach()) - first) <= 1e-5 * first
    key = [k for k in w if k.endswith("classifier.weight")][0]
    got = dict(m.named_parameters())[key].grad
    wd = c["optimizer"]["weight_decay"]
    want = ref["first_grad"][key] - wd * w[key]
    assert float((got - want).norm()) <= 1e-4 * float(want.norm())


@pytest.mark.parametrize("name,kw", [
    ("mv2dl_camvid", dict(image_hw=[90, 120], n_train=6)),
    ("r50fpn_voc", dict(image_sizes=[[60, 80, 2], [80, 60, 1], [90, 90, 1]],
                        train_hw=[64, 64], size_base=80, n_train=6))])
def test_augment_replays_the_port_samples(tmp_path, name, kw):
    """The reference's training samples, from the written files and the
    benchmark's labelled pixels, equal the port's, image and labels."""
    from PIL import Image

    from pb import data
    from pb.phase import MODEL_FLAGS, port_overrides
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.data.factory import get_dataset
    from reference import augment

    c = small(name, **kw)
    ds = data.write(c, 5, tmp_path / "data", {"train": c["n_train"],
                                              "val": 1}, "cpu")
    args = default_args(c["dataset"], **port_overrides(c, {}, MODEL_FLAGS),
                        dir_dataset=str(ds.root), device="cpu", seed=77,
                        dir_checkpoints=str(tmp_path / "run"))
    port = get_dataset(args)
    labels = [augment.base_resized_label(y, c) for y in ds.labels["train"]]
    masks = data.labelled_masks(labels, c["labelled_per_image"],
                                c["ignore_index"], torch.Generator())
    port.queries = list(masks)
    for epoch in (1, 2, 3):
        for i in range(c["n_train"]):
            got = port.train_sample(i, epoch)
            with Image.open(ds.files["train"][i]) as im:
                x, rows, cols, lab, ok = augment.train_sample(
                    im.convert("RGB"), ds.labels["train"][i], masks[i],
                    augment.sample_rng(77, epoch, i), c)
            assert (x == got["x"]).all()
            n = len(rows)
            assert n > 0 and not got["valid"][n:].any()
            assert (got["coords"][:n, 0] == rows).all()
            assert (got["coords"][:n, 1] == cols).all()
            assert (got["labels"][:n] == lab).all()
            assert (got["valid"][:n] == ok).all()
