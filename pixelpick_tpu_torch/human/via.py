"""VIA (VGG Image Annotator) integration — reference ``via/`` package.

Counterpart of ``pixelpick_tpu/human/via.py``, an own copy with an own copy
of the vendored annotator (``human/assets/``).

Bridges the AL loop's query files to browser-based human annotation:

- :func:`build_via_project` turns a ``queries.pkl`` dict into a VIA-3.1.1
  project (reference ``via/via_utils.py:105-131``): one view per image, one
  point region per queried pixel, a dropdown attribute with the dataset's
  key->category mapping;
- :func:`write_project_js` emits the ``_via_dp`` JS preamble the annotator
  html auto-loads (``via/launch_via.py:53-56``);
- :func:`convert_via_json` maps a VIA JSON export back to the pkl codec
  *with* ``category``/``category_id`` per pixel
  (``via/convert_json_to_pkl.py:20-73``) — the format the human-label
  training path consumes;
- :func:`serve` hosts a directory on localhost (``via/launch_via.py:59-95``).

    python -m pixelpick_tpu_torch.human.via -pdc CFG.yaml \
        --p_queries queries.pkl [--serve_dir DIR --no_browser]
    python -m pixelpick_tpu_torch.human.via -pdc CFG.yaml \
        --via_annot_file export.json [--converted_file labelled.pkl]

``CFG.yaml`` holds ``mapping`` (key -> category name) and
``k_to_category_id`` (key -> category id), and optionally ``dir_dataset``
and ``dataset_name``.

The VIA annotator html is vendored third-party software (BSD — see
``human/assets/THIRD_PARTY.md``), exactly as the reference vendors it
(``via/launch_via.py:53-56``): :func:`serve` stages it into the served
directory automatically, so the browser flow works out of the box.
"""

from __future__ import annotations

import json
import os
import pickle as pkl
import random
import string
import time
from typing import Dict, Tuple

import numpy as np

_ALNUM = [c for c in string.printable if c.isalnum()]


def _metadata_id(prefix) -> str:
    return f"{prefix}_{''.join(random.choices(_ALNUM, k=8))}"


def build_via_project(dict_queries: Dict[str, dict], mapping: Dict[str, str],
                      url: str = "http://localhost:8001/") -> dict:
    """queries.pkl dict -> VIA 3.1.1 project with point annotations."""
    vid_list = [str(i) for i in range(len(dict_queries))]
    files = {str(i): {"fid": str(i), "fname": p, "type": 2, "loc": 2, "src": p}
             for i, p in enumerate(dict_queries)}
    metadata = {}
    for i, (p, info) in enumerate(dict_queries.items()):
        for x, y in zip(np.asarray(info["x_coords"]).tolist(),
                        np.asarray(info["y_coords"]).tolist()):
            metadata[_metadata_id(i)] = {
                "vid": str(i), "flg": 0, "z": [],
                "xy": [1, int(x), int(y)], "av": {},
            }
    return {
        "project": {
            "pid": "__VIA_PROJECT_ID__",
            "rev": "__VIA_PROJECT_REV_ID__",
            "rev_timestamp": "__VIA_PROJECT_REV_TIMESTAMP__",
            "pname": "Pixel Pick Annotation",
            "creator": "Pixel Pick",
            "created": int(time.time() * 1000),
            "data_format_version": "3.1.1",
            "vid_list": vid_list,
        },
        "config": {
            "file": {"loc_prefix": {"1": "", "2": url, "3": "", "4": ""}},
            "ui": {
                "file_content_align": "center",
                "file_metadata_editor_visible": False,
                "spatial_metadata_editor_visible": True,
                "spatial_region_label_attribute_id": "1",
            },
        },
        "attribute": {
            "1": {
                "aname": "Class",
                "anchor_id": "FILE1_Z0_XY1",
                "type": 3,
                "desc": "Segmentation classes",
                "options": {k.upper(): v for k, v in mapping.items()},
                "default_option_id": "",
            }
        },
        "view": {str(i): {"fid_list": [i]} for i in range(len(dict_queries))},
        "file": files,
        "metadata": metadata,
    }


def write_project_js(project: dict, path: str = "via_debug_project.js") -> str:
    with open(path, "w") as f:
        f.write("_via_dp = ")
        json.dump(project, f, indent=2)
    return path


def convert_via_json(via_annot: dict, k_to_category: Dict[str, str],
                     k_to_category_id: Dict[str, int],
                     image_sizes: Dict[str, Tuple[int, int]] | None = None,
                     verbose: bool = True) -> dict:
    """VIA JSON export -> pkl codec dict with category(_id) lists.

    ``image_sizes`` maps filepath -> (h, w); if None, sizes are read from
    the image files (reference behaviour, convert_json_to_pkl.py:62-63).
    """
    file_info = via_annot["file"]
    out: dict = {}
    for _mid, annot in via_annot["metadata"].items():
        filepath = file_info[annot["vid"]]["src"]
        x, y = int(annot["xy"][1]), int(annot["xy"][2])
        av = list(annot["av"].values())
        if not av:
            if verbose:
                print(f"WARNING: pixel at [{x}, {y}] (x, y) for {filepath} "
                      f"was not labelled.")
            continue
        key = av[0]
        if filepath not in out:
            if image_sizes and filepath in image_sizes:
                h, w = image_sizes[filepath]
            else:
                from PIL import Image
                w, h = Image.open(filepath).size
            out[filepath] = {"height": h, "width": w, "x_coords": [],
                             "y_coords": [], "category": [], "category_id": []}
        rec = out[filepath]
        rec["x_coords"].append(x)
        rec["y_coords"].append(y)
        rec["category"].append(k_to_category[key].lower())
        rec["category_id"].append(k_to_category_id[key])
    return out


def coords_to_grid(size: Tuple[int, int], x_coords, y_coords) -> np.ndarray:
    grid = np.zeros(size, dtype=bool)
    grid[np.asarray(y_coords, int), np.asarray(x_coords, int)] = True
    return grid


def annotator_asset_path() -> str:
    """Path of the vendored VIA annotator html (BSD third-party asset)."""
    return os.path.join(os.path.dirname(__file__), "assets",
                        "via_pixelpick_annotator.html")


def stage_annotator(directory: str,
                    page: str = "via_pixelpick_annotator.html") -> str:
    """Copy the vendored annotator into ``directory`` unless already there,
    so ``serve`` delivers it next to the generated project JS."""
    import shutil

    dst = os.path.join(directory, page)
    if not os.path.isfile(dst):
        shutil.copyfile(annotator_asset_path(), dst)
    return dst


def serve(directory: str, host: str = "localhost", port: int = 8001,
          open_browser: bool = True,
          page: str = "via_pixelpick_annotator.html", block: bool = True):
    """Serve ``directory`` (with the annotator staged into it) and
    optionally open the annotator page. ``block=False`` starts the server
    on a daemon thread and returns the ``HTTPServer`` (tests; call
    ``.shutdown()`` when done)."""
    import functools
    import threading
    import webbrowser
    from http.server import HTTPServer, SimpleHTTPRequestHandler

    stage_annotator(directory, page)
    handler = functools.partial(SimpleHTTPRequestHandler, directory=directory)
    httpd = HTTPServer((host, port), handler)
    if open_browser:
        threading.Timer(
            1.0, lambda: webbrowser.open(
                f"http://{host}:{httpd.server_port}/{page}")).start()
    print(f"Serving {directory} at http://{host}:{httpd.server_port}/{page}")
    if not block:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    try:
        httpd.serve_forever()
    finally:
        httpd.shutdown()
    return None


def main():
    """CLI: queries.pkl -> VIA project JS (+ optional server), or VIA JSON
    export -> labelled queries.pkl."""
    from argparse import ArgumentParser

    import yaml

    parser = ArgumentParser("PixelPick VIA bridge")
    parser.add_argument("--p_dataset_config", "-pdc", type=str, required=True)
    parser.add_argument("--p_queries", type=str, default="")
    parser.add_argument("--via_annot_file", "-vaf", type=str, default="")
    parser.add_argument("--converted_file", "-cf", type=str, default="")
    parser.add_argument("--serve_dir", type=str, default="")
    parser.add_argument("--no_browser", action="store_true")
    args = parser.parse_args()

    with open(args.p_dataset_config) as f:
        cfg = yaml.safe_load(f)

    if args.p_queries:
        with open(args.p_queries, "rb") as f:
            dict_queries = pkl.load(f)
        # rewrite to server-relative paths (launch_via.py:37-42)
        dir_dataset = cfg.get("dir_dataset", "")
        name = cfg.get("dataset_name", "custom")
        dict_queries = {
            k.replace(dir_dataset, f"datasets/{name}"): v
            for k, v in dict_queries.items()
        }
        mapping = dict(cfg["mapping"])
        mapping.update({k.lower(): v for k, v in list(mapping.items())})
        path = write_project_js(build_via_project(dict_queries, mapping))
        print(f"VIA project written to {path}")
        if args.serve_dir:
            serve(args.serve_dir, open_browser=not args.no_browser)
    elif args.via_annot_file:
        with open(args.via_annot_file) as f:
            via_annot = json.load(f)
        converted = convert_via_json(via_annot, cfg["mapping"],
                                     cfg["k_to_category_id"])
        fp = args.converted_file or args.via_annot_file.replace("json", "pkl")
        with open(fp, "wb") as f:
            pkl.dump(converted, f)
        print(f"Converted annotations saved to {fp}")
    else:
        parser.error("pass --p_queries (export) or --via_annot_file (import)")


if __name__ == "__main__":
    main()
