"""6-panel PNG visualiser (reference ``utils/utils.py:376-453``; an own copy
of ``pixelpick_tpu/utils/visualiser.py``): input | target | prediction |
confidence | margin | entropy, half-size, side by side."""

from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image

from pixelpick_tpu_torch.utils.palettes import get_palette, palette_lut


class Visualiser:
    def __init__(self, dataset_name: str):
        self.lut = palette_lut(get_palette(dataset_name))

    def _panel(self, arr: np.ndarray, seg: bool, downsample: int = 2) -> Image.Image:
        arr = np.asarray(arr)
        if seg:
            rgb = self.lut[np.clip(arr.astype(np.int64), 0, 255)]
        else:
            a = arr.astype(np.float32)
            a = a - a.min()
            a = a / (a.max() + 1e-7) * 255.0
            rgb = np.clip(a, 0, 255).astype(np.uint8)
            if rgb.ndim == 2:
                rgb = np.stack([rgb] * 3, -1)
        h, w = rgb.shape[:2]
        return Image.fromarray(rgb).resize((w // downsample, h // downsample))

    def __call__(self, dict_tensors: dict, fp: str = "") -> Optional[Image.Image]:
        panels = [self._panel(dict_tensors["input"], seg=False)]
        if dict_tensors.get("target") is not None:
            panels.append(self._panel(dict_tensors["target"], seg=True))
        panels.append(self._panel(dict_tensors["pred"], seg=True))
        for k in ("confidence", "margin", "entropy"):
            panels.append(self._panel(dict_tensors[k], seg=False))
        grid = Image.new("RGB", (sum(p.width for p in panels), panels[0].height))
        x = 0
        for p in panels:
            grid.paste(p, (x, 0))
            x += p.width
        if fp:
            grid.save(fp)
        return grid


def render_vis_panels(visualiser: Visualiser, x0, target, vis, fp: str) -> None:
    """The 6 panels from an eval step's ``vis`` maps (margin negated, so
    brighter = more uncertain, reference utils.py:405-418). ``vis`` may hold
    device tensors."""
    vis = {k: v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
           for k, v in vis.items()}
    pred = vis["pred"]
    h, w = pred.shape
    visualiser({
        "input": np.asarray(x0)[:h, :w],
        "target": None if target is None else np.asarray(target)[:h, :w],
        "pred": pred,
        "confidence": np.asarray(vis["least_confidence"]),
        "margin": -np.asarray(vis["margin_sampling"]),
        "entropy": np.asarray(vis["entropy"]),
    }, fp=fp)
