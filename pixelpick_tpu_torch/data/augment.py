"""Host-side augmentation pipeline (an own copy of
``pixelpick_tpu/data/augment.py``: the same code, so the same
``random.Random`` stream gives the same samples).

Distribution-parity with the reference's PIL/torchvision pipeline
(``datasets/base_dataset.py:48-141``, VOC variants ``datasets/voc.py:135-186``):

geometric (co-transforms image, label, query mask, labelled-query map):
  - random scale U(0.5, 2.0), bilinear for x / nearest for masks
  - pad right/bottom to crop size (x: dataset-mean fill, y: ignore_index,
    queries: 0, labelled: ignore_index), then random crop
  - horizontal flip p=0.5

photometric:
  - ColorJitter(brightness, contrast, saturation, hue) with p=0.8, random
    op order (torchvision semantics)
  - RandomGrayscale p=0.2
  - Gaussian blur p=0.5, kernel = 10% of the shorter side (odd), sigma
    U(0.1, 2.0)

Every sample gets its own ``random.Random`` stream seeded from (seed,
epoch, index) instead of the reference's shared global RNG, so augmentation
is reproducible and safe under the threaded prefetch loader. The *distributions* are unchanged (what matters for the mIoU parity
bands, SURVEY.md §7 hard-part 3).
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance

try:
    import cv2
except Exception:  # pragma: no cover - cv2 is present in the target image
    cv2 = None


# ----------------------------- photometric -----------------------------

def adjust_hue(img: Image.Image, hue_factor: float) -> Image.Image:
    if hue_factor == 0:
        return img
    hsv = np.array(img.convert("HSV"), dtype=np.uint8)
    # PIL hue channel is uint8 [0, 255] wrapping
    shift = np.uint8(int(hue_factor * 255) & 0xFF)
    hsv[..., 0] = hsv[..., 0] + shift  # uint8 wraps like torchvision's impl
    return Image.fromarray(hsv, "HSV").convert("RGB")


def color_jitter(img: Image.Image, rng: random.Random, brightness: float,
                 contrast: float, saturation: float, hue: float) -> Image.Image:
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f2 = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation > 0:
        f3 = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    if hue > 0:
        f4 = rng.uniform(-hue, hue)
        ops.append(lambda im: adjust_hue(im, f4))
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def gaussian_blur(img: Image.Image, rng: random.Random,
                  sigma_min: float = 0.1, sigma_max: float = 2.0) -> Image.Image:
    """SimCLR-style blur (base_dataset.py:192-209): kernel ~10% of the
    shorter side (odd), applied with p=0.5."""
    if rng.random() >= 0.5:
        return img
    w, h = img.size
    k = int((0.1 * min(w, h)) // 2 * 2 + 1)
    sigma = rng.uniform(sigma_min, sigma_max)
    arr = np.array(img)
    if cv2 is not None:
        arr = cv2.GaussianBlur(arr, (k, k), sigma)
        return Image.fromarray(arr)
    from PIL import ImageFilter
    return img.filter(ImageFilter.GaussianBlur(radius=sigma))


def photometric_augment(img: Image.Image, rng: random.Random, *,
                        jitter=(0.8, 0.8, 0.8, 0.2), p_jitter: float = 0.8,
                        p_grayscale: float = 0.2, blur: bool = True,
                        enabled=None) -> Image.Image:
    enabled = enabled or {}
    if enabled.get("random_color_jitter", True) and rng.random() < p_jitter:
        img = color_jitter(img, rng, *jitter)
    if enabled.get("random_grayscale", True) and rng.random() < p_grayscale:
        img = Image.merge("RGB", [img.convert("L")] * 3)
    if enabled.get("random_gaussian_blur", True) and blur:
        img = gaussian_blur(img, rng)
    return img


# ----------------------------- geometric -----------------------------

def _resize(img: Image.Image, hw: Tuple[int, int], nearest: bool) -> Image.Image:
    return img.resize((hw[1], hw[0]),
                      Image.NEAREST if nearest else Image.BILINEAR)


def geometric_augment(
    x: Image.Image,
    y: Optional[Image.Image],
    queries: Optional[np.ndarray],
    labelled: Optional[np.ndarray],
    rng: random.Random,
    *,
    crop_size: Tuple[int, int],
    mean_fill: Tuple[int, int, int],
    ignore_index: int,
    enabled=None,
):
    """Co-transforming scale/pad+crop/hflip (base_dataset.py:48-127).

    queries: bool (H, W); labelled: int (H, W) or None.
    Returns PIL x and numpy y/queries/labelled at crop_size.
    """
    enabled = enabled or {}
    q_img = Image.fromarray(queries.astype(np.uint8) * 255) if queries is not None else None
    l_img = Image.fromarray(labelled.astype(np.int32), mode="I") if labelled is not None else None

    if enabled.get("random_scale", True):
        w, h = x.size
        rs = rng.uniform(0.5, 2.0)
        hw = (int(h * rs), int(w * rs))
        x = _resize(x, hw, nearest=False)
        if y is not None:
            y = _resize(y, hw, nearest=True)
        if q_img is not None:
            q_img = _resize(q_img, hw, nearest=True)
        if l_img is not None:
            l_img = _resize(l_img, hw, nearest=True)

    if enabled.get("crop", True):
        w, h = x.size
        pad_h, pad_w = max(crop_size[0] - h, 0), max(crop_size[1] - w, 0)
        if pad_h or pad_w:
            x = _pad_rb(x, pad_w, pad_h, mean_fill)
            if y is not None:
                y = _pad_rb(y, pad_w, pad_h, ignore_index)
            if q_img is not None:
                q_img = _pad_rb(q_img, pad_w, pad_h, 0)
            if l_img is not None:
                l_img = _pad_rb(l_img, pad_w, pad_h, ignore_index)
        w, h = x.size
        top = rng.randint(0, h - crop_size[0])
        left = rng.randint(0, w - crop_size[1])
        box = (left, top, left + crop_size[1], top + crop_size[0])
        x = x.crop(box)
        y = y.crop(box) if y is not None else None
        q_img = q_img.crop(box) if q_img is not None else None
        l_img = l_img.crop(box) if l_img is not None else None

    if enabled.get("random_hflip", True) and rng.random() > 0.5:
        x = x.transpose(Image.FLIP_LEFT_RIGHT)
        y = y.transpose(Image.FLIP_LEFT_RIGHT) if y is not None else None
        q_img = q_img.transpose(Image.FLIP_LEFT_RIGHT) if q_img is not None else None
        l_img = l_img.transpose(Image.FLIP_LEFT_RIGHT) if l_img is not None else None

    y_np = np.asarray(y, dtype=np.int32) if y is not None else None
    q_np = (np.asarray(q_img, dtype=np.uint8) // 255).astype(bool) if q_img is not None else None
    l_np = np.asarray(l_img, dtype=np.int32) if l_img is not None else None
    return x, y_np, q_np, l_np


def _pad_rb(img: Image.Image, pad_w: int, pad_h: int, fill):
    """Right/bottom constant pad, matching TF.pad(..., (0,0,pad_w,pad_h))."""
    w, h = img.size
    if img.mode == "RGB":
        out = Image.new("RGB", (w + pad_w, h + pad_h), tuple(fill))
    elif img.mode == "I":
        out = Image.new("I", (w + pad_w, h + pad_h), int(fill))
    else:
        out = Image.new(img.mode, (w + pad_w, h + pad_h), int(fill))
    out.paste(img, (0, 0))
    return out
