"""The port's human annotation tools (pixelpick_tpu_torch/human/: the VIA
bridge and the keyboard annotator, with their own copy of the vendored
annotator page) and the codec's ``query.npy`` pair, against the JAX
package's: every case of ``tests/test_human_tooling.py`` through both
packages, and the port's two CLIs head-less in a subprocess.

VIA region ids come from ``random``: both packages draw them after the
same ``random.seed``, so their projects are compared whole, but for the
``created`` timestamp. The annotator's CSV logs are compared with their
two time columns set aside. Everything else is compared exactly.
"""

import json
import os
import pickle as pkl
import random
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import yaml
from PIL import Image

from pixelpick_tpu.active import codec as jax_codec
from pixelpick_tpu.human import annotation as jax_annotation
from pixelpick_tpu.human import via as jax_via
from pixelpick_tpu.utils.palettes import CV_LABEL_CATEGORY as JAX_CATEGORIES
from pixelpick_tpu_torch.active import codec
from pixelpick_tpu_torch.human import annotation, via
from pixelpick_tpu_torch.utils.palettes import CV_LABEL_CATEGORY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_via, jax_annotation, jax_codec),
            "torch": (via, annotation, codec)}


def _queries_dict(cod):
    """tests/test_human_tooling.py's two images of 6x8 with 3 picks."""
    q = np.zeros((6, 8), bool)
    q[1, 2] = q[4, 7] = True
    enc = cod.encode_query("imgs/a.png", (6, 8), q)
    q2 = np.zeros((6, 8), bool)
    q2[0, 0] = True
    enc.update(cod.encode_query("imgs/b.png", (6, 8), q2))
    return enc


def _project(pkg, mapping, seed=0):
    v, _, cod = PACKAGES[pkg]
    random.seed(seed)
    proj = v.build_via_project(_queries_dict(cod), mapping)
    proj["project"]["created"] = 0
    return proj


def test_via_project_equals_jax(tmp_path):
    """``build_via_project`` and ``write_project_js``: the same project and
    the same file, and the structure the JAX test asks for."""
    mapping = {"A": "sky", "B": "road"}
    ours, ref = _project("torch", mapping), _project("jax", mapping)
    assert ours == ref
    assert ours["project"]["data_format_version"] == "3.1.1"
    assert len(ours["file"]) == 2 and len(ours["view"]) == 2
    assert len(ours["metadata"]) == 3
    assert all(md["xy"][0] == 1 and len(md["xy"]) == 3
               for md in ours["metadata"].values())
    assert ours["attribute"]["1"]["options"] == {"A": "sky", "B": "road"}
    p = via.write_project_js(ours, str(tmp_path / "ours.js"))
    q = jax_via.write_project_js(ref, str(tmp_path / "ref.js"))
    text = open(p).read()
    assert text == open(q).read()
    assert text.startswith("_via_dp = ")
    json.loads(text[len("_via_dp = "):])


@pytest.mark.parametrize("labelled", [True, False])
def test_via_roundtrip_equals_jax(labelled):
    """``convert_via_json`` on a project labelled with key 'a' (and on one
    left unlabelled, whose points are skipped): the same labelled dict,
    which the port's codec decodes as the JAX codec does."""
    outs = {}
    for pkg in PACKAGES:
        proj = _project(pkg, {"A": "sky", "B": "road"})
        if labelled:
            for md in proj["metadata"].values():
                md["av"] = {"1": "a"}
        outs[pkg] = PACKAGES[pkg][0].convert_via_json(
            proj, k_to_category={"a": "sky", "b": "road"},
            k_to_category_id={"a": 0, "b": 3},
            image_sizes={"imgs/a.png": (6, 8), "imgs/b.png": (6, 8)},
            verbose=False)
    assert outs["torch"] == outs["jax"]
    if not labelled:
        assert outs["torch"] == {}
        return
    rec = outs["torch"]["imgs/a.png"]
    assert rec["category_id"] == [0, 0] and rec["category"] == ["sky", "sky"]
    m = codec.decode_query(rec, ignore_index=255)
    np.testing.assert_array_equal(m, jax_codec.decode_query(rec, 255))
    assert m.dtype == np.int64 and (m != 255).sum() == 2


def test_serve_delivers_the_annotator_and_project_js(tmp_path):
    """``serve`` stages the port's copy of the annotator page, which is
    byte for byte the JAX package's, and delivers it and the project JS
    over localhost."""
    with open(via.annotator_asset_path(), "rb") as f:
        page_ours = f.read()
    with open(jax_via.annotator_asset_path(), "rb") as f:
        assert page_ours == f.read()
    assert via.annotator_asset_path() != jax_via.annotator_asset_path()
    with open(os.path.join(os.path.dirname(via.annotator_asset_path()),
                           "THIRD_PARTY.md")) as f:
        assert "BSD" in f.read()
    via.write_project_js(_project("torch", {"A": "sky"}),
                         str(tmp_path / "via_debug_project.js"))
    httpd = via.serve(str(tmp_path), port=0, open_browser=False, block=False)
    try:
        base = f"http://localhost:{httpd.server_port}"
        page = urllib.request.urlopen(
            f"{base}/via_pixelpick_annotator.html", timeout=10).read()
        assert page == page_ours and b"draw_pixelpick" in page
        js = urllib.request.urlopen(f"{base}/via_debug_project.js",
                                    timeout=10).read()
        assert js.startswith(b"_via_dp = ")
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_coords_to_grid_equals_jax():
    args = ((4, 5), [1, 3], [0, 2])
    g = via.coords_to_grid(*args)
    np.testing.assert_array_equal(g, jax_via.coords_to_grid(*args))
    assert g[0, 1] and g[2, 3] and g.sum() == 2


def _csv_without_times(path):
    lines = open(path).read().splitlines()
    return [lines[0]] + [",".join(line.split(",")[:-2]) for line in lines[1:]]


@pytest.mark.parametrize("display_all", [False, True])
def test_annotation_headless_equals_jax(tmp_path, display_all):
    """``annotate_dataset`` answering from the ground truth: the same
    labelled records and the same CSV logs but for their times, on the
    JAX test's image and on a second one with a void pick (clipped to the
    largest category, as the JAX tool does)."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (6, 8, 3), dtype=np.uint8)
            for _ in range(2)]
    gts = [rng.integers(0, 11, (6, 8)).astype(np.int32) for _ in range(2)]
    gts[1][5, 1] = 255
    qs = [np.zeros((6, 8), bool), np.zeros((6, 8), bool)]
    qs[0][1, 2] = qs[0][3, 4] = True
    qs[1][5, 1] = qs[1][0, 7] = qs[1][2, 2] = True
    outs = {}
    for pkg, (_, ann, _) in PACKAGES.items():
        cats = CV_LABEL_CATEGORY if pkg == "torch" else JAX_CATEGORIES
        outs[pkg] = ann.annotate_dataset(
            imgs, qs, ["x.png", "d/y.png"], cats, gt_labels=gts,
            dir_log=str(tmp_path / pkg), labels_from_gt=True,
            display_all_queries=display_all)
    assert outs["torch"] == outs["jax"]
    rec = outs["torch"]["x.png"]
    assert len(rec["category_id"]) == 2
    assert rec["category_id"][0] == int(
        gts[0][rec["y_coords"][0], rec["x_coords"][0]])
    assert outs["torch"]["d/y.png"]["category_id"][0] == 11
    for name in ("x", "y"):
        ours = _csv_without_times(tmp_path / "torch" / f"{name}.txt")
        assert ours == _csv_without_times(tmp_path / "jax" / f"{name}.txt")
        assert ours[0] == "loc,label,elapsed_time,total_time"
    assert len(ours) == 4


def test_default_key_mapping_equals_jax():
    m = annotation.default_key_mapping(CV_LABEL_CATEGORY)
    assert m == jax_annotation.default_key_mapping(JAX_CATEGORIES)
    assert m["a"] == 0 and m["l"] == 11 and len(m) == 12
    assert CV_LABEL_CATEGORY == JAX_CATEGORIES


def test_query_npy_round_trip_equals_jax(tmp_path):
    """``save_query_npy``/``load_query_npy``: each package reads what the
    other writes, the masks come back exactly as bool."""
    rng = np.random.default_rng(3)
    masks = [rng.random((6, 8)) < 0.2 for _ in range(3)]
    codec.save_query_npy(masks, str(tmp_path / "ours.npy"))
    jax_codec.save_query_npy(masks, str(tmp_path / "ref.npy"))
    assert open(tmp_path / "ours.npy", "rb").read() == \
        open(tmp_path / "ref.npy", "rb").read()
    for load in (codec.load_query_npy, jax_codec.load_query_npy):
        for name in ("ours", "ref"):
            got = load(str(tmp_path / f"{name}.npy"))
            assert len(got) == 3
            for g, m in zip(got, masks):
                assert g.dtype == bool
                np.testing.assert_array_equal(g, m)


def _run(module, args, cwd):
    """``python -m module args`` in a fresh interpreter, as a user runs
    the port's CLI (no JAX on its path)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _tiny_dataset(root, n=3, hw=(6, 8)):
    """n images and label maps (labels 0-11) under root/{imgs,gts}, and
    their random queries."""
    rng = np.random.default_rng(5)
    os.makedirs(root / "imgs")
    os.makedirs(root / "gts")
    masks = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)) \
            .save(root / "imgs" / f"{i:03d}.png")
        Image.fromarray(rng.integers(0, 12, hw).astype(np.uint8)) \
            .save(root / "gts" / f"{i:03d}.png")
        m = rng.random(hw) < 0.15
        m[0, i] = True
        masks.append(m)
    return masks


@pytest.mark.parametrize("fmt", ["npy", "pkl"])
def test_annotation_cli_labels_from_gt(tmp_path, fmt):
    """``python -m pixelpick_tpu_torch.human.annotation --labels-from-gt``
    on a ``query.npy`` and on a ``queries.pkl``: the labelled file equals
    what JAX's ``annotate_dataset`` gives for the same images."""
    masks = _tiny_dataset(tmp_path)
    paths = sorted(str(tmp_path / "imgs" / p)
                   for p in os.listdir(tmp_path / "imgs"))
    if fmt == "npy":
        query = str(tmp_path / "query.npy")
        codec.save_query_npy(masks, query)
    else:
        query = str(tmp_path / "queries.pkl")
        enc = {}
        for p, m in zip(paths, masks):
            enc.update(codec.encode_query(p, m.shape, m))
        with open(query, "wb") as f:
            pkl.dump(enc, f)
    out = tmp_path / "labelled.pkl"
    stdout = _run("pixelpick_tpu_torch.human.annotation",
                  ["--dir_imgs", str(tmp_path / "imgs"), "--dir_gts",
                   str(tmp_path / "gts"), "--path_query", query,
                   "--labels-from-gt", "--out", str(out)], cwd=tmp_path)
    assert "accuracy vs GT: 100.00%" in stdout
    with open(out, "rb") as f:
        got = pkl.load(f)
    gts = [np.array(Image.open(p.replace("imgs", "gts"))) for p in paths]
    imgs = [np.array(Image.open(p)) for p in paths]
    ref = jax_annotation.annotate_dataset(
        imgs, masks, paths, JAX_CATEGORIES, gt_labels=gts,
        dir_log=str(tmp_path / "jax_logs"), labels_from_gt=True)
    assert got == ref
    # the CSV logs under logs/{dataset}_{date}/ in the working directory
    (run,) = os.listdir(tmp_path / "logs")
    assert run.startswith("camvid_")
    assert sorted(os.listdir(tmp_path / "logs" / run)) == [
        "000.txt", "001.txt", "002.txt"]


def test_via_cli_round_trip(tmp_path):
    """``python -m pixelpick_tpu_torch.human.via``: a ``queries.pkl`` to
    the project JS (paths rewritten under ``datasets/``), then a VIA
    export labelled from the ground truth back to a labelled
    ``queries.pkl`` (image sizes read from the files), equal to JAX's
    ``convert_via_json`` of the same export and to the ground truth."""
    masks = _tiny_dataset(tmp_path / "ds")
    os.makedirs(tmp_path / "datasets")
    os.symlink(tmp_path / "ds", tmp_path / "datasets" / "custom")
    paths = sorted(str(tmp_path / "ds" / "imgs" / p)
                   for p in os.listdir(tmp_path / "ds" / "imgs"))
    enc = {}
    for p, m in zip(paths, masks):
        enc.update(codec.encode_query(p, m.shape, m))
    with open(tmp_path / "queries.pkl", "wb") as f:
        pkl.dump(enc, f)
    letters = "abcdefghijkl"
    cfg = {"dir_dataset": str(tmp_path / "ds"), "dataset_name": "custom",
           "mapping": {letters[c].upper(): CV_LABEL_CATEGORY[c]
                       for c in range(12)},
           "k_to_category_id": {letters[c]: c for c in range(12)}}
    cfg["mapping"].update({letters[c]: CV_LABEL_CATEGORY[c]
                           for c in range(12)})
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    _run("pixelpick_tpu_torch.human.via",
         ["-pdc", "cfg.yaml", "--p_queries", "queries.pkl"], cwd=tmp_path)
    text = (tmp_path / "via_debug_project.js").read_text()
    proj = json.loads(text[len("_via_dp = "):])
    n_points = sum(int(m.sum()) for m in masks)
    assert len(proj["metadata"]) == n_points
    for md in proj["metadata"].values():
        src = proj["file"][md["vid"]]["src"]
        assert src.startswith("datasets/custom/imgs/")
        gt = np.array(Image.open(tmp_path / "ds" / "gts" /
                                 os.path.basename(src)))
        md["av"] = {"1": letters[int(gt[md["xy"][2], md["xy"][1]])]}
    (tmp_path / "export.json").write_text(json.dumps(proj))
    _run("pixelpick_tpu_torch.human.via",
         ["-pdc", "cfg.yaml", "--via_annot_file", "export.json",
          "--converted_file", "labelled.pkl"], cwd=tmp_path)
    with open(tmp_path / "labelled.pkl", "rb") as f:
        got = pkl.load(f)
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the export's paths are relative to the server
    try:
        ref = jax_via.convert_via_json(proj, cfg["mapping"],
                                       cfg["k_to_category_id"],
                                       verbose=False)
    finally:
        os.chdir(cwd)
    assert got == ref
    labels = codec.decode_queries(got, ignore_index=255, return_as_dict=True)
    for p, lab in labels.items():
        gt = np.array(Image.open(tmp_path / "ds" / "gts" /
                                 os.path.basename(p))).astype(np.int64)
        picked = lab != 255
        assert picked.sum() == masks[paths.index(
            str(tmp_path / "ds" / "imgs" / os.path.basename(p)))].sum()
        np.testing.assert_array_equal(lab[picked], gt[picked])
