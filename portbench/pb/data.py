"""Synthetic datasets in the real layouts, sizes and counts, from the seed.

The card's machine holds no dataset, so every run writes the splits its
cell reads under a directory of the run's ``TMPDIR`` and deletes them at the
end. Label maps are tiles of random classes with void pixels among them;
images are a colour per class plus a little noise (the content changes no
work the cells time). Pixels are drawn on the device in a few large calls.

- CamVid (``dataset`` ``cv``): ``{train,test}/NNNN.png`` RGB and
  ``{train,test}annot/NNNN.png`` labels 0..n_classes-1, void
  ``ignore_index``; every image ``image_hw``.
- PASCAL VOC 2012 (``voc``): ``VOCdevkit/VOC2012/ImageSets/Segmentation/
  {train,val}.txt``, ``JPEGImages/*.jpg`` and palette ``SegmentationClass/
  *.png`` (void 255), the image sizes the configuration's ``image_sizes``
  lists (the same multiset for every seed, in the seed's order).

A split the cell does not read, but that the port's round driver opens
when it is built, holds one image.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
from PIL import Image

TILE = (30, 40)  # label tiles, in pixels
VOID_SHARE = 0.05
NOISE = 6  # +- image noise around each class colour


def _sizes(cfg, n: int, rng: np.random.RandomState) -> List[Tuple[int, int]]:
    if "image_sizes" not in cfg:
        return [tuple(cfg["image_hw"])] * n
    sizes = []
    total = sum(c for _, _, c in cfg["image_sizes"])
    for h, w, c in cfg["image_sizes"]:
        sizes += [(h, w)] * round(c * n / total)
    sizes = sizes or [tuple(cfg["image_sizes"][0][:2])]
    sizes = (sizes * (n // len(sizes) + 1))[:n]
    rng.shuffle(sizes)
    return sizes


def draw_split(cfg, n: int, generator: torch.Generator, sizes,
               chunk: int = 32):
    """``n`` (image uint8 (h, w, 3), label uint8 (h, w)) pairs, drawn on the
    generator's device ``chunk`` images to a call at the largest size, then
    cropped to each image's size."""
    dev = generator.device
    big_h = max(h for h, _ in sizes)
    big_w = max(w for _, w in sizes)
    th, tw = TILE
    n_cls, void = cfg["n_classes"], cfg["ignore_index"]
    palette = torch.randint(0, 256, (256, 3), generator=generator,
                            device=dev, dtype=torch.int16)
    out = []
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        tiles = torch.randint(0, n_cls, (m, math.ceil(big_h / th),
                                         math.ceil(big_w / tw)),
                              generator=generator, device=dev)
        tiles = torch.where(torch.rand(tiles.shape, generator=generator,
                                       device=dev) < VOID_SHARE,
                            torch.full_like(tiles, void), tiles)
        lab = tiles.repeat_interleave(th, 1).repeat_interleave(tw, 2)
        lab = lab[:, :big_h, :big_w]
        noise = torch.randint(-NOISE, NOISE + 1, (m, big_h, big_w, 3),
                              generator=generator, device=dev,
                              dtype=torch.int16)
        img = (palette[lab] + noise).clamp(0, 255).to(torch.uint8)
        img, lab = img.cpu().numpy(), lab.to(torch.uint8).cpu().numpy()
        out += [(img[i, :h, :w], lab[i, :h, :w])
                for i, (h, w) in enumerate(sizes[lo:lo + m])]
    return out


def _voc_palette() -> List[int]:
    pal = []
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal += [r, g, b]
    return pal


class Dataset:
    """The written dataset: its root, and per split the arrays, in the
    order the port's loaders read them."""

    def __init__(self, root: Path):
        self.root = root
        self.images: Dict[str, list] = {}
        self.labels: Dict[str, list] = {}
        self.files: Dict[str, list] = {}  # each image's file


def write(cfg, seed: int, root: Path, counts: Dict[str, int],
          device) -> Dataset:
    """Write the splits ``counts`` names ({split: images}; ``train`` and
    ``val``) under ``root``; return them."""
    ds = Dataset(root)
    rng = np.random.RandomState(seed % (2 ** 32))
    gen = torch.Generator(device=device).manual_seed(seed)
    jobs = []
    for split, n in counts.items():
        pairs = draw_split(cfg, n, gen, _sizes(cfg, n, rng))
        ds.images[split] = [p[0] for p in pairs]
        ds.labels[split] = [p[1] for p in pairs]
        split_jobs, ds.files[split] = _layout(cfg, root, split, pairs)
        jobs += split_jobs
    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(lambda job: job(), jobs))
    return ds


def _layout(cfg, root: Path, split: str, pairs) -> list:
    """The file writes of one split, as callables, and each image's
    file."""
    if cfg["dataset"] == "cv":
        name = {"train": "train", "val": "test"}[split]
        (root / name).mkdir(parents=True, exist_ok=True)
        (root / f"{name}annot").mkdir(parents=True, exist_ok=True)
        files = [root / name / f"{i:04d}.png" for i in range(len(pairs))]
        return [lambda i=i, x=x, y=y: (
            Image.fromarray(x).save(files[i], compress_level=1),
            Image.fromarray(y).save(root / f"{name}annot" / f"{i:04d}.png",
                                    compress_level=1))
            for i, (x, y) in enumerate(pairs)], files
    if cfg["dataset"] == "voc":
        voc = root / "VOCdevkit" / "VOC2012"
        for d in ("ImageSets/Segmentation", "JPEGImages", "SegmentationClass"):
            (voc / d).mkdir(parents=True, exist_ok=True)
        stems = [f"{split}_{i:05d}" for i in range(len(pairs))]
        (voc / "ImageSets" / "Segmentation" / f"{split}.txt").write_text(
            "".join(f"{s}\n" for s in stems))
        pal = _voc_palette()

        def label_png(y, path):
            im = Image.fromarray(y, mode="P")
            im.putpalette(pal)
            im.save(path, compress_level=1)

        files = [voc / "JPEGImages" / f"{s}.jpg" for s in stems]
        return [lambda f=f, s=s, x=x, y=y: (
            Image.fromarray(x).save(f, quality=90),
            label_png(y, voc / "SegmentationClass" / f"{s}.png"))
            for f, s, (x, y) in zip(files, stems, pairs)], files
    raise ValueError(cfg["dataset"])


def labelled_masks(labels: List[np.ndarray], n: int, void: int,
                   generator: torch.Generator) -> List[np.ndarray]:
    """``n`` labelled pixels per image, uniformly among its non-void ones,
    as bool masks: the picks of the rounds before."""
    dev = generator.device
    masks = []
    for lab in labels:
        y = torch.from_numpy(np.array(lab)).to(dev)
        keys = torch.rand(y.shape, generator=generator, device=dev)
        keys = keys.masked_fill(y == void, -1.0).reshape(-1)
        mask = torch.zeros_like(keys, dtype=torch.bool)
        mask[torch.topk(keys, n).indices] = True
        masks.append(mask.reshape(y.shape))
    return [m.cpu().numpy() for m in masks]
