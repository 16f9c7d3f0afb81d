"""The operation and byte counts against hand counts."""

import json

from pb import counts
from tests_paths import CONFIGS


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_fused_block_by_hand():
    # one block: b 2, 4x5 map, 3 -> 18 -> 3 channels, dilation 1
    b, h, w, cin, cout, d = 2, 4, 5, 3, 3, 1
    ch = 18
    fwd_ops = 2 * b * 6 * 7 * cin * ch + 18 * b * h * w * ch \
        + 2 * b * h * w * ch * cout
    weights = (cin * ch + 9 * ch + ch * cout + 2 * ch + 2 * ch + 2 * cout) * 4
    moments = (ch * 4 + cout * 2) * 4
    x = y = b * h * w * 3 * 4
    assert counts.fused_block_work(b, h, w, cin, cout, d) == (
        fwd_ops, x + y + weights + moments, 2 * fwd_ops,
        x + y + x + 2 * weights + moments)


def test_fused_flops_equal_the_ports_formula():
    from pixelpick_tpu_torch.ops.fused_ir import block_flops

    for shape in [(4, 90, 120, 24, 24, 1), (4, 23, 30, 160, 160, 1),
                  (4, 23, 30, 160, 320, 2)]:
        b, h, w, cin, cout, d = shape
        fo, _, bo, _ = counts.fused_block_work(*shape)
        assert (fo, bo) == block_flops(b, h, w, cin, 6 * cin, cout, d)


def test_depthwise_by_hand():
    ops, nbytes = counts.depthwise_work(2, 4, 5, 8, 1)
    assert ops == 18 * 2 * 4 * 5 * 8
    assert nbytes == (2 * 6 * 7 * 8 + 9 * 8 + 2 * 4 * 5 * 8) * 4


def test_block_plan_of_the_main_path():
    c = cfg("mv2dl_camvid")
    shapes = counts.fused_shapes(c, (360, 480))
    assert len(shapes) == 13
    assert shapes[0] == (90, 120, 24, 24, 1)
    assert shapes[-1] == (23, 30, 160, 320, 2)
    assert counts.first_depthwise(c, (360, 480)) == (180, 240, 32, 1)


def test_conv_flops_against_the_modules():
    """Each network's count equals a count over the port's own modules'
    convolutions, taken from a forward hook at a small size."""
    import torch

    from pixelpick_tpu_torch.models.deeplab import DeepLab
    from pixelpick_tpu_torch.models.fpn import FPNSeg

    for model, c, hw in ((DeepLab(11), cfg("mv2dl_camvid"), (64, 96)),
                         (FPNSeg(21, 50), cfg("r50fpn_voc"), (64, 64))):
        seen = []

        def hook(m, args, out):
            w = m.weight
            o = out if out.dim() == 4 else out
            hh, ww = o.shape[2], o.shape[3]
            seen.append(2 * hh * ww * w.shape[0] * w.shape[1]
                        * w.shape[2] * w.shape[3])

        for m in model.modules():
            if hasattr(m, "weight") and getattr(m, "weight") is not None \
                    and m.weight.dim() == 4:
                m.register_forward_hook(hook)
        with torch.no_grad():
            model.eval()(torch.zeros(1, *hw, 3), upsample=False)
        assert sum(seen) == counts.forward_flops(c, hw)
