"""Query file codec — the on-disk interchange format of the AL loop.

Byte-compatible with the reference's pickled query files (and with
``pixelpick_tpu.active.codec``) so that the annotation tools interoperate:

- ``encode_query`` (reference ``query.py:71-87``): one image's picked pixels
  as ``{p_img: {"height", "width", "x_coords", "y_coords"}}`` with numpy
  coordinate arrays in ``np.where`` order (row-major).
- ``decode_queries`` (reference ``query.py:89-142``): inverse; a plain bool
  mask when no labels are attached, or an int64 label map filled with
  ``ignore_index`` when the human-annotation path added per-pixel
  ``category_id`` lists.
- ``merge_previous_query_files`` (reference ``query.py:316-351``): overlay
  every round's label maps into one per-image map (later files win where
  both are labelled).
- ``save_query_npy`` / ``load_query_npy``: the stacked bool masks of the
  reference's ``query.npy``, which the annotation tool reads
  (``human/annotation.py``).

Host-side NumPy only.
"""

from __future__ import annotations

import pickle as pkl
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np


def encode_query(p_img: str, size: Tuple[int, int],
                 query: np.ndarray) -> Dict[str, dict]:
    y_coords, x_coords = np.where(query)
    return {
        p_img: {
            "height": size[0],
            "width": size[1],
            "x_coords": x_coords,
            "y_coords": y_coords,
        }
    }


def decode_query(query_info: dict, ignore_index: int = 255) -> np.ndarray:
    ys = np.asarray(query_info["y_coords"], dtype=np.int64)
    xs = np.asarray(query_info["x_coords"], dtype=np.int64)
    labels = query_info.get("category_id", None)
    h, w = query_info["height"], query_info["width"]
    if labels is None:
        out = np.zeros((h, w), dtype=bool)
        out[ys, xs] = True
    else:
        out = np.full((h, w), ignore_index, dtype=np.int64)
        out[ys, xs] = np.asarray(labels, dtype=np.int64)
    return out


def decode_queries(
    encoded_query: Dict[str, dict],
    ignore_index: int = 255,
    return_as_dict: bool = False,
) -> Union[List[np.ndarray], Dict[str, np.ndarray]]:
    if len(encoded_query) == 0:
        raise ValueError("empty query file")
    items = sorted(encoded_query.items())
    if return_as_dict:
        return {p: decode_query(info, ignore_index) for p, info in items}
    return [decode_query(info, ignore_index) for _, info in items]


def gather_previous_query_files(dir_base: str, ext: str = "pkl") -> List[str]:
    """Find every round's ``queries.pkl`` under a checkpoint dir
    (reference ``query.py:311-313``)."""
    pattern = f"*/queries.{ext}" if ext is not None else "*"
    return [str(p) for p in Path(dir_base).rglob(pattern)]


def merge_previous_query_files(
    list_previous_query_files: List[str],
    ignore_index: int,
    verbose: bool = True,
) -> Dict[str, np.ndarray]:
    per_image: Dict[str, List[np.ndarray]] = {}
    for p_file in list_previous_query_files:
        with open(p_file, "rb") as f:
            encoded = pkl.load(f)
        decoded = decode_queries(encoded, ignore_index=ignore_index,
                                 return_as_dict=True)
        for p_img, q in decoded.items():
            per_image.setdefault(p_img, []).append(q)

    merged: Dict[str, np.ndarray] = {}
    cnt = 0
    for p_img, qs in per_image.items():
        out = np.full_like(qs[0], ignore_index, dtype=np.int64)
        for q in qs:
            labelled = q != ignore_index
            out[labelled] = q[labelled]
            cnt += int(labelled.sum())
        merged[p_img] = out
    if verbose:
        print(f"# merged pixels: {cnt}")
    return merged


def save_query_npy(queries: List[np.ndarray], path: str) -> None:
    """Stacked bool-array export, the ``query.npy`` format consumed by the
    annotation tool (reference ``annotation_tool/launch_gui.py:58``:
    ``np.load(...).astype(bool)`` of shape (N, H, W))."""
    np.save(path, np.stack([np.asarray(q, dtype=bool) for q in queries]))


def load_query_npy(path: str) -> List[np.ndarray]:
    arr = np.load(path).astype(bool)
    return [arr[i] for i in range(arr.shape[0])]
