"""Keyboard annotation GUI — reference ``annotation_tool/``.

Counterpart of ``pixelpick_tpu/human/annotation.py``, an own copy on the
port's ``utils/palettes.py`` and ``active/codec.py``.

Mouse-free pixel labelling: for every queried pixel, render the image with a
marker on the pixel and a key->category legend, wait for a keypress
(``cv2.waitKey``), record the chosen label plus per-click timing, and track
live accuracy against GT when available (``annotation_tool/launch_gui.py``,
``annotation_tool/utils/utils.py:56-152``).

Input: a ``query.npy`` bool array ``(N, H, W)`` (the reference's format,
``launch_gui.py:58``) or a ``queries.pkl`` codec dict. Output: per-image CSV
logs ``loc,label,elapsed_time,total_time`` and a labelled ``queries.pkl``
(with ``category_id``) the training CLI consumes.

Head-less environments: pass ``--labels-from-gt`` to auto-answer from GT
(useful for testing the plumbing without a display); that mode needs no
cv2, which stays optional.

    python -m pixelpick_tpu_torch.human.annotation --dir_imgs IMGS \
        --dir_gts GTS --path_query queries.pkl --labels-from-gt \
        --out labelled_queries.pkl
"""

from __future__ import annotations

import os
import pickle as pkl
import string
from datetime import datetime
from time import time
from typing import Dict, List, Optional

import numpy as np

from pixelpick_tpu_torch.utils.palettes import CV_LABEL_CATEGORY

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

ALPHABET = string.ascii_lowercase


def default_key_mapping(label_category: Dict[int, str]) -> Dict[str, int]:
    """letter -> category_id, alphabetical like the reference's legend."""
    return {ALPHABET[i]: cid for i, cid in enumerate(sorted(label_category))}


def color_point(img: np.ndarray, y: int, x: int, fc=(255, 0, 0),
                ec=(255, 255, 255), ms: int = 5, es: int = 2) -> np.ndarray:
    img = cv2.circle(img.copy(), (x, y), ms + es, color=ec, thickness=-1)
    return cv2.circle(img, (x, y), ms, color=fc, thickness=-1)


def render_frame(img: np.ndarray, label_category: Dict[int, str],
                 key_mapping: Dict[str, int]) -> np.ndarray:
    """Image + right-hand key legend, pure numpy/cv2 (no matplotlib)."""
    h, w = img.shape[:2]
    legend_w = 220
    frame = np.full((max(h, 20 * len(label_category) + 40), w + legend_w, 3),
                    240, np.uint8)
    frame[:h, :w] = img
    inv = {v: k for k, v in key_mapping.items()}
    for i, (cid, name) in enumerate(sorted(label_category.items())):
        text = f"{inv.get(cid, '?')} - {name}"
        cv2.putText(frame, text, (w + 10, 25 + 20 * i),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1, cv2.LINE_AA)
    cv2.putText(frame, "Enter a label for the red marker",
                (10, frame.shape[0] - 8), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (0, 0, 200), 1, cv2.LINE_AA)
    return frame


class Logger:
    """Per-image CSV logs (annotation_tool/utils/utils.py:144-152)."""

    def __init__(self, dir_log: str):
        self.dir_log = dir_log
        os.makedirs(dir_log, exist_ok=True)

    def __call__(self, fname: str, line: str, mode: str) -> None:
        with open(f"{self.dir_log}/{fname}.txt", mode) as f:
            f.write(line)


def annotate_dataset(
    imgs: List[np.ndarray],
    queries: List[np.ndarray],
    paths: List[str],
    label_category: Dict[int, str],
    gt_labels: Optional[List[np.ndarray]] = None,
    key_mapping: Optional[Dict[str, int]] = None,
    dir_log: str = "logs",
    display_all_queries: bool = False,
    labels_from_gt: bool = False,
) -> Dict[str, dict]:
    """Run the labelling loop; returns the labelled pkl-codec dict."""
    key_mapping = key_mapping or default_key_mapping(label_category)
    logger = Logger(dir_log)
    out: Dict[str, dict] = {}
    n_correct, n_total, time_total = 0, 0, 0.0

    for idx, (img, q, p) in enumerate(zip(imgs, queries, paths)):
        fname = os.path.splitext(os.path.basename(p))[0]
        logger(fname, "loc,label,elapsed_time,total_time\n", "w")
        locs = sorted(zip(*np.nonzero(q)), key=lambda v: v[1])
        h, w = q.shape
        rec = {"height": h, "width": w, "x_coords": [], "y_coords": [],
               "category": [], "category_id": []}
        img_total = 0.0
        canvas = img
        if display_all_queries:
            for y, x in locs:
                canvas = color_point(canvas, y, x, fc=(0, 128, 192))
        for y, x in locs:
            t0 = time()
            if labels_from_gt:
                cid = int(gt_labels[idx][y, x])
                cid = min(cid, max(label_category))
            else:
                if cv2 is None:
                    raise RuntimeError("cv2 unavailable; use labels_from_gt")
                frame = render_frame(color_point(canvas, y, x), label_category,
                                     key_mapping)
                cv2.imshow("PixelPick annotation", frame)
                while True:
                    key = cv2.waitKey(0) & 0xFF
                    ch = chr(key) if 0 < key < 128 else ""
                    if ch in key_mapping:
                        cid = key_mapping[ch]
                        break
            dt = time() - t0
            img_total += dt
            time_total += dt
            rec["x_coords"].append(int(x))
            rec["y_coords"].append(int(y))
            rec["category"].append(label_category[cid].lower())
            rec["category_id"].append(cid)
            if gt_labels is not None:
                n_correct += int(cid == int(gt_labels[idx][y, x]))
                n_total += 1
            logger(fname, f"({y}, {x}),{label_category[cid].lower()},"
                          f"{dt},{img_total}\n", "a")
        out[p] = rec
    if cv2 is not None and not labels_from_gt:
        cv2.destroyAllWindows()
    if n_total:
        print(f"accuracy vs GT: {100.0 * n_correct / n_total:.2f}% | "
              f"avg sec/click: {time_total / max(n_total, 1):.2f}")
    return out


def main():
    from argparse import ArgumentParser
    from glob import glob

    from PIL import Image

    parser = ArgumentParser("Mouse-free annotation")
    parser.add_argument("--dir_imgs", type=str, required=True)
    parser.add_argument("--dir_gts", type=str, default="")
    parser.add_argument("--path_query", type=str, required=True,
                        help="query.npy (N,H,W bool) or queries.pkl")
    parser.add_argument("--dataset_name", type=str, default="camvid")
    parser.add_argument("--display_all_queries", "-a", action="store_true")
    parser.add_argument("--n_imgs", type=int, default=-1)
    parser.add_argument("--labels-from-gt", action="store_true",
                        help="auto-answer from GT (headless testing)")
    parser.add_argument("--out", type=str, default="labelled_queries.pkl")
    args = parser.parse_args()

    paths = sorted(glob(f"{args.dir_imgs}/*.png"))
    imgs = [np.array(Image.open(p)) for p in paths]
    gts = None
    if args.dir_gts:
        gts = [np.array(Image.open(p))
               for p in sorted(glob(f"{args.dir_gts}/*.png"))]

    if args.path_query.endswith(".npy"):
        queries = list(np.load(args.path_query).astype(bool))
    else:
        from pixelpick_tpu_torch.active import codec
        with open(args.path_query, "rb") as f:
            queries = codec.decode_queries(pkl.load(f))
    assert len(imgs) == len(queries), (len(imgs), len(queries))

    if args.n_imgs > 0:
        idxs = np.random.choice(len(imgs), args.n_imgs, replace=False)
        imgs = [imgs[i] for i in idxs]
        queries = [queries[i] for i in idxs]
        paths = [paths[i] for i in idxs]
        gts = [gts[i] for i in idxs] if gts else None

    label_category = CV_LABEL_CATEGORY if args.dataset_name == "camvid" else \
        {i: str(i) for i in range(256)}
    dir_log = f"logs/{args.dataset_name}_{datetime.now().strftime('%b_%d_%H_%M')}"
    out = annotate_dataset(imgs, queries, paths, label_category, gts,
                           dir_log=dir_log,
                           display_all_queries=args.display_all_queries,
                           labels_from_gt=args.labels_from_gt)
    with open(args.out, "wb") as f:
        pkl.dump(out, f)
    print(f"labelled queries saved to {args.out}")


if __name__ == "__main__":
    main()
