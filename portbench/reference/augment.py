"""The training samples as the original PixelPick repository makes them,
worked out again from the written files: the image and label map, the
labelled pixels, and the sample's own random stream.

The draws follow the order of ``datasets/base_dataset.py:48-141`` (VOC:
``datasets/voc.py:135-186``), each sample from a ``random.Random`` seeded
by ``(seed * 1000003 + epoch) * 1000003 + index``, the rule of the program
under test (so that its samples can be checked one by one):

- VOC only: the image resized bilinearly, the labels by nearest, so that
  the longer side is ``size_base``;
- a random scale U(0.5, 2.0) (bilinear image, nearest labels and masks);
- a right/bottom pad to the crop (image: the mean colour, labels: void,
  masks: 0) and a random crop;
- a horizontal flip with p 0.5;
- colour jitter with p 0.8 (brightness, contrast, saturation, hue, in a
  random order), grayscale with p 0.2, a Gaussian blur with p 0.5 (kernel a
  tenth of the shorter side, odd; sigma U(0.1, 2.0));
- the labelled pixels inside the crop, in row-major order, valid where
  their label is not void.

It imports PIL, numpy and (where it is installed) OpenCV, nothing of the
program under test.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np
from PIL import Image, ImageEnhance

try:
    import cv2
except ImportError:
    cv2 = None

JITTER = {"cv": (0.8, 0.8, 0.8, 0.2), "voc": (0.1, 0.1, 0.1, 0.1)}


def base_size(h: int, w: int, cfg) -> Tuple[int, int]:
    """(h, w) with the longer side at ``size_base`` (VOC); unchanged for a
    configuration without one."""
    base = cfg.get("size_base")
    if base is None:
        return h, w
    if w >= h:
        return int(float(h) / w * base), base
    return base, int(float(w) / h * base)


def base_resized_label(y: np.ndarray, cfg) -> np.ndarray:
    h, w = base_size(*y.shape, cfg)
    if (h, w) == y.shape:
        return y
    return np.asarray(Image.fromarray(y.astype(np.int32), mode="I").resize(
        (w, h), Image.NEAREST), np.int32)


def sample_rng(seed: int, epoch: int, index: int) -> random.Random:
    return random.Random((int(seed) * 1_000_003 + int(epoch)) * 1_000_003
                         + int(index))


def _resize(img: Image.Image, hw, nearest: bool) -> Image.Image:
    return img.resize((hw[1], hw[0]),
                      Image.NEAREST if nearest else Image.BILINEAR)


def _pad(img: Image.Image, pad_w: int, pad_h: int, fill) -> Image.Image:
    w, h = img.size
    out = Image.new(img.mode, (w + pad_w, h + pad_h), fill)
    out.paste(img, (0, 0))
    return out


def _hue(img: Image.Image, f: float) -> Image.Image:
    if f == 0:
        return img
    hsv = np.array(img.convert("HSV"), dtype=np.uint8)
    hsv[..., 0] = hsv[..., 0] + np.uint8(int(f * 255) & 0xFF)
    return Image.fromarray(hsv, "HSV").convert("RGB")


def _photometric(img: Image.Image, rng: random.Random,
                 jitter) -> Image.Image:
    if rng.random() < 0.8:
        ops = []
        for amount, op in zip(jitter[:3], (ImageEnhance.Brightness,
                                           ImageEnhance.Contrast,
                                           ImageEnhance.Color)):
            if amount > 0:
                f = rng.uniform(max(0.0, 1 - amount), 1 + amount)
                ops.append(lambda im, f=f, op=op: op(im).enhance(f))
        if jitter[3] > 0:
            f = rng.uniform(-jitter[3], jitter[3])
            ops.append(lambda im, f=f: _hue(im, f))
        rng.shuffle(ops)
        for op in ops:
            img = op(img)
    if rng.random() < 0.2:
        img = Image.merge("RGB", [img.convert("L")] * 3)
    if rng.random() < 0.5:
        w, h = img.size
        k = int((0.1 * min(w, h)) // 2 * 2 + 1)
        sigma = rng.uniform(0.1, 2.0)
        if cv2 is not None:
            img = Image.fromarray(cv2.GaussianBlur(np.array(img), (k, k),
                                                   sigma))
        else:
            from PIL import ImageFilter
            img = img.filter(ImageFilter.GaussianBlur(radius=sigma))
    return img


def train_sample(x: Image.Image, y: np.ndarray, mask: np.ndarray,
                 rng: random.Random, cfg):
    """One training sample from the image as decoded (RGB), its label map
    (int) and labelled-pixel mask (bool) at the written size. Returns x
    uint8 (h, w, 3) at the crop, and the labelled pixels' rows, columns,
    labels and validity."""
    h, w = base_size(y.shape[0], y.shape[1], cfg)
    if (h, w) != y.shape:
        x = _resize(x, (h, w), nearest=False)
    yi = _resize(Image.fromarray(y.astype(np.int32), mode="I"), (h, w), True)
    qi = Image.fromarray(mask.astype(np.uint8) * 255)
    rs = rng.uniform(0.5, 2.0)
    hw = (int(h * rs), int(w * rs))
    x, yi, qi = (_resize(x, hw, False), _resize(yi, hw, True),
                 _resize(qi, hw, True))
    ch, cw = cfg["train_hw"]
    pad_h, pad_w = max(ch - hw[0], 0), max(cw - hw[1], 0)
    if pad_h or pad_w:
        fill = tuple((np.array(cfg["mean"]) * 255.0).astype(np.uint8)
                     .tolist())
        x = _pad(x, pad_w, pad_h, fill)
        yi = _pad(yi, pad_w, pad_h, int(cfg["ignore_index"]))
        qi = _pad(qi, pad_w, pad_h, 0)
    w2, h2 = x.size
    top = rng.randint(0, h2 - ch)
    left = rng.randint(0, w2 - cw)
    box = (left, top, left + cw, top + ch)
    x, yi, qi = x.crop(box), yi.crop(box), qi.crop(box)
    if rng.random() > 0.5:
        x, yi, qi = (im.transpose(Image.FLIP_LEFT_RIGHT)
                     for im in (x, yi, qi))
    x = _photometric(x, rng, JITTER[cfg["dataset"]])
    lab = np.asarray(yi, np.int32)
    rows, cols = np.nonzero(np.asarray(qi, np.uint8) // 255)
    labels = lab[rows, cols]
    return (np.asarray(x, np.uint8), rows, cols, labels,
            labels != cfg["ignore_index"])
