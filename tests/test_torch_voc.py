"""The port's PASCAL VOC path (data/voc.py, the Loader's shape buckets, the
bucketed score step, selector, driver validation and the eval and query
CLIs) against the JAX package's, on the CPU, over the JAX tests' synthetic
VOCdevkit tree (``tests/test_datasets_cs_voc.py:_make_voc``: JPEGs of
60x80, 90x60 and 70x70, labels 0-20 with a void top row), at the JAX
tests' ``size_base`` 100 and ``size_crop`` 64.

Exact equality throughout the data path: the init-query pickle and
``label.pkl``, train / dense / val / query samples, the augmented-pairs
layout, the bucket plan and every bucketed batch (x, y, excluded, index,
hw), ``label_queries`` on raw masks and on the encoded dict. The pick rule
on bucket-padded maps (``_select_topk`` with the padding mask and the true
areas) equals JAX's on the same uniforms. A VOC round through
``pixelpick_tpu_torch.cli.main_al --device cpu`` (DeepLab at width 0.5):
the JAX selector on the round's trained weights picks the same pixel sets
(compared as sets; ``top_n_percent`` 0), none in padding, and the picks
decode with the JAX codec; the eval CLI's confusion matrix over the
bucketed val set equals JAX's ``evaluate`` at the same weights; the query
CLI in human mode over the mixed-shape pool picks JAX's CLI's pixels.
"""

import contextlib
import copy
import io
import os
import pickle as pkl
import shutil
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pixelpick_tpu.active import acquisition as jax_acq
from pixelpick_tpu.active import codec as jax_codec
from pixelpick_tpu.active.selector import QuerySelector as JaxQuerySelector
from pixelpick_tpu.config import default_args as jax_default_args
from pixelpick_tpu.data.loader import Loader as JaxLoader
from pixelpick_tpu.data.voc import VOC2012Segmentation as JaxVOC
from pixelpick_tpu.models import get_model as jax_get_model
from pixelpick_tpu_torch.active import acquisition, driver
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.data.loader import Loader, pad_sample_to
from pixelpick_tpu_torch.data.voc import VOC2012Segmentation
from pixelpick_tpu_torch.models.convert import jax_tree_from_state_dict
from tests.test_datasets_cs_voc import _make_voc
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

N_IMAGES = 6
SMALL = dict(n_pixels_by_us=4, size_base=100, size_crop=64, n_workers=2)
pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _pair(tmp_path, **kw):
    """The JAX and the port args over two copies of one VOC tree (each
    package writes its init-query cache beside the data)."""
    out = []
    for name, make in (("jax", jax_default_args), ("port", default_args)):
        root = _make_voc(str(tmp_path / name / "voc"), n=N_IMAGES)
        extra = {} if make is jax_default_args else {"device": "cpu"}
        args = make("voc", dir_dataset=root,
                    dir_checkpoints=str(tmp_path / name / "ck"),
                    **SMALL, **kw, **extra)
        os.makedirs(args.dir_checkpoints, exist_ok=True)
        out.append(args)
    return out


def _assert_samples_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_samples_and_init_queries_equal_jax(tmp_path):
    jargs, pargs = _pair(tmp_path)
    jds, pds = JaxVOC(jargs), VOC2012Segmentation(pargs)
    for args in (jargs, pargs):
        with open(f"{args.dir_dataset}/init_labelled_pixels_0.pkl", "rb") as f:
            cached = pkl.load(f)
        with open(f"{args.dir_checkpoints}/0_query/label.pkl", "rb") as f:
            label = pkl.load(f)
        for a, b, c in zip(cached, label, jds.queries):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)
    assert pds.n_pixels_total == jds.n_pixels_total == N_IMAGES * 4
    for i in range(N_IMAGES):
        assert pds.sample_hw(i, "val") == jds.sample_hw(i, "val")
        assert pds.sample_hw(i, "query") == jds.sample_hw(i, "query")
        for epoch in (1, 2):
            _assert_samples_equal(pds.train_sample(i, epoch),
                                  jds.train_sample(i, epoch))
        _assert_samples_equal(pds.train_sample(i, 1, fully_sup=True),
                              jds.train_sample(i, 1, fully_sup=True))
    jq, pq = (JaxVOC(jargs, query=True, generate_init_queries=False),
              VOC2012Segmentation(pargs, query=True,
                                  generate_init_queries=False))
    jq.queries, pq.queries = jds.queries, pds.queries
    jv, pv = JaxVOC(jargs, val=True), VOC2012Segmentation(pargs, val=True)
    for i in range(N_IMAGES):
        _assert_samples_equal(pq.query_sample(i), jq.query_sample(i))
        _assert_samples_equal(pv.val_sample(i), jv.val_sample(i))
    # a round's picks as raw masks, then as the encoded dict
    rng = np.random.default_rng(2)
    masks = [rng.random(q.shape) < 0.01 for q in jds.queries]
    enc = {}
    for p, m in zip(pds.list_inputs, masks):
        enc.update(jax_codec.encode_query(p, m.shape, m))
    for picks in (masks, enc):
        assert pds.label_queries(picks, 1) == jds.label_queries(masks, 1)
        for a, b in zip(pds.queries, jds.queries):
            np.testing.assert_array_equal(a, b)
    with open(f"{pargs.dir_checkpoints}/1_query/label.pkl", "rb") as f:
        for a, b in zip(pkl.load(f), jds.queries):
            np.testing.assert_array_equal(a, b)


def test_augmented_pairs_equal_jax(tmp_path):
    pair = _pair(tmp_path, use_augmented_dataset=True)
    rng = np.random.default_rng(5)
    for args in pair:
        os.makedirs(f"{args.dir_augmented_dataset}/images")
        os.makedirs(f"{args.dir_augmented_dataset}/annot")
    for i in range(3):
        img = rng.integers(0, 255, (50, 66, 3), dtype=np.uint8)
        lab = rng.integers(0, 21, (50, 66)).astype(np.uint8)
        for args in pair:
            d = args.dir_augmented_dataset
            from PIL import Image
            Image.fromarray(img).save(f"{d}/images/aug_{i:04d}.jpg")
            Image.fromarray(lab).save(f"{d}/annot/aug_{i:04d}.png")
    jds, pds = JaxVOC(pair[0]), VOC2012Segmentation(pair[1])
    assert [os.path.basename(p) for p in pds.list_inputs] \
        == [os.path.basename(p) for p in jds.list_inputs]
    for i in range(3):
        _assert_samples_equal(pds.train_sample(i, 1), jds.train_sample(i, 1))


def test_pad_sample_to_equals_jax():
    from pixelpick_tpu.data.loader import pad_sample_to as jax_pad

    rng = np.random.default_rng(0)
    s = {"x": rng.integers(0, 255, (5, 7, 3), dtype=np.uint8),
         "y": rng.integers(0, 21, (5, 7)).astype(np.int32),
         "excluded": rng.random((5, 7)) < 0.5}
    for hw in ((5, 7), (8, 8), (16, 9)):
        _assert_samples_equal(pad_sample_to(s, hw, 255), jax_pad(s, hw, 255))


@pytest.mark.parametrize("mode,bs", [("val", 1), ("val", 2), ("query", 4)])
def test_bucketed_batches_equal_jax(tmp_path, mode, bs):
    jargs, pargs = _pair(tmp_path)
    val = mode == "val"
    jds = JaxVOC(jargs, val=val, query=not val)
    pds = VOC2012Segmentation(pargs, val=val, query=not val)
    if not val:  # the same picks in both (their own init caches agree)
        pds.queries = [q.copy() for q in JaxVOC(jargs).queries]
        jds.queries = [q.copy() for q in pds.queries]
    with JaxLoader(jds, bs, mode=mode, n_workers=2, bucket_stride=8,
                   pad_label=255) as jl, \
            Loader(pds, bs, mode=mode, n_workers=2, bucket_stride=8,
                   pad_label=255) as pl:
        assert pl.bucket_plan() == jl._bucket_plan()
        assert len(pl) == len(jl)
        jb, pb = list(jl), list(pl)
    assert len(pb) == len(jb) == len(pl)
    for a, b in zip(pb, jb):
        _assert_samples_equal(a, b)
    n_fill = sum(int((b["index"] < 0).sum()) for b in pb)
    assert n_fill == len(pb) * bs - N_IMAGES
    if bs == 4:
        assert n_fill > 0  # the landscape bucket's batch is filled


@pytest.mark.parametrize("reverse", [False, True])
def test_select_topk_on_padded_maps_equals_jax(reverse):
    """The pick rule on bucket-padded maps: padding never picked, the
    candidate count from each image's true area; the port fed JAX's own
    uniforms."""
    rng = np.random.default_rng(4)
    big = (24, 32)
    n = big[0] * big[1]
    hw = np.array([[24, 32], [17, 30], [9, 12]], np.int32)
    uc = rng.random((3, n)).astype(np.float32)
    pad = np.stack([((np.arange(big[0])[:, None] >= h)
                     | (np.arange(big[1])[None] >= w)).reshape(-1)
                    for h, w in hw])
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    kw = dict(strategy="margin_sampling", n_pixels=5, top_n_percent=0.1,
              reverse_order=reverse)
    for i in range(3):
        ref = jax_acq._select_topk(
            jnp.asarray(uc[i]), keys[i], hw=big, pad_mask=jnp.asarray(pad[i]),
            true_n=jnp.asarray(hw[i, 0] * hw[i, 1]), **kw)
        rng_a, rng_b = jax.random.split(keys[i])
        u = np.array(jax.random.uniform(rng_a if reverse else rng_b, (n,)))
        got = acquisition._select_topk(
            torch.from_numpy(uc[i:i + 1]), torch.from_numpy(u[None]),
            pad_mask=torch.from_numpy(pad[i:i + 1]),
            true_n=torch.from_numpy(hw[i:i + 1, 0] * hw[i:i + 1, 1]), **kw)
        assert set(got[0].tolist()) == set(np.asarray(ref).tolist())
        assert not pad[i][got[0].numpy()].any()


def _cfg(tmp_path, args) -> str:
    cfg = {k: getattr(args, k) for k in (
        "dataset_name", "dir_dataset", "ignore_index", "n_classes", "mean",
        "std", "size_base", "size_crop", "optimizer_type",
        "lr_scheduler_type", "optimizer_params")}
    cfg.update(batch_size=4, n_epochs=2)
    path = tmp_path / "voc.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def voc_round(tmp_path_factory):
    """One VOC round of the port's main_al on the CPU (DeepLab at width 0.5,
    bs 4, 2 epochs, 4 picks per image, pool batch 4, val batch 2); the
    selector's returned picks are kept."""
    from pixelpick_tpu_torch.cli.main_al import main

    tmp = tmp_path_factory.mktemp("voc_round")
    jargs, pargs = _pair(tmp, width_multiplier=0.5, top_n_percent=0.0,
                         pool_batch_size=4, val_batch_size=2, max_budget=4)
    cfg = _cfg(tmp, pargs)
    initial = [q.copy() for q in JaxVOC(jargs).queries]
    returned = []
    call = driver.QuerySelector.__call__

    def keep(self, *a, **k):
        returned.append(call(self, *a, **k))
        return returned[-1]

    driver.QuerySelector.__call__ = keep
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            al = main(["-pdc", cfg, "--dir_checkpoints",
                       pargs.dir_checkpoints, "--device", "cpu",
                       "--width_multiplier", "0.5", "--n_pixels_by_us", "4",
                       "--max_budget", "4", "--top_n_percent", "0",
                       "--pool_batch_size", "4", "--val_batch_size", "2",
                       "--n_workers", "2", "--seed", "0"])
    finally:
        driver.QuerySelector.__call__ = call
    return jargs, pargs, al, initial, returned[0]


def test_voc_round_picks_equal_jax(voc_round):
    jargs, pargs, al, initial, picks = voc_round
    run = pargs.dir_checkpoints
    for f in ("0_query/label.pkl", "0_query/best_miou_model.ckpt",
              "0_query/log_val.txt", "0_query/query_stats.pkl",
              "1_query/label.pkl"):
        assert os.path.isfile(f"{run}/{f}"), f
    params, stats, _ = jax_tree_from_state_dict(al.model.state_dict())
    jds = JaxVOC(jargs, query=True, generate_init_queries=False)
    jds.queries = [q.copy() for q in initial]
    with JaxLoader(jds, 4, mode="query", n_workers=2, bucket_stride=8,
                   pad_label=255) as jl:
        ref = JaxQuerySelector(jargs, jl, jax_get_model(jargs))(
            0, jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, stats))
    ref = {os.path.basename(p): v for p, v in ref.items()}
    decoded = jax_codec.decode_queries(picks, return_as_dict=True)
    assert len(decoded) == len(ref) == N_IMAGES
    for p, mask in decoded.items():
        want = jax_codec.decode_query(ref[os.path.basename(p)])
        assert mask.shape == want.shape  # the true (base) size, pad cut off
        assert set(zip(*np.nonzero(mask))) == set(zip(*np.nonzero(want)))
        assert mask.sum() == 4
    with open(f"{run}/1_query/label.pkl", "rb") as f:
        merged = pkl.load(f)
    for m, q0, p in zip(merged, initial, al.dataset.list_inputs):
        np.testing.assert_array_equal(m, q0 | decoded[p])
        assert not (q0 & decoded[p]).any()


def _confusions(monkeypatch, *modules):
    """Record every confusion matrix ``RunningScore.get_scores`` reads."""
    seen = []
    for m in modules:
        get = m.RunningScore.get_scores

        def recorded(self, _get=get):
            seen.append(np.array(self.confusion))
            return _get(self)

        monkeypatch.setattr(m.RunningScore, "get_scores", recorded)
    return seen


def test_eval_cli_on_voc_equals_jax(voc_round, tmp_path, monkeypatch):
    from pixelpick_tpu.cli.eval import evaluate as jax_evaluate
    from pixelpick_tpu.utils import metrics as jax_metrics
    from pixelpick_tpu_torch.cli.eval import main
    from pixelpick_tpu_torch.utils import metrics

    jargs, pargs, _, _, _ = voc_round
    ckpt = f"{pargs.dir_checkpoints}/0_query/best_miou_model.ckpt"
    os.symlink(pargs.dir_dataset, tmp_path / "VOC2012")
    seen = _confusions(monkeypatch, metrics, jax_metrics)
    with contextlib.redirect_stdout(io.StringIO()):
        main(["--dataset_name", "voc", "--dir_datasets", str(tmp_path),
              "--dir_checkpoints", str(tmp_path / "eval"), "--device", "cpu",
              "--width_multiplier", "0.5", "--p_state_dict", ckpt,
              "--val_batch_size", "2", "--n_workers", "2"])
    state = torch.load(ckpt, map_location="cpu", weights_only=False)["model"]
    params, stats, _ = jax_tree_from_state_dict(state)
    with contextlib.redirect_stdout(io.StringIO()):
        jax_evaluate(jargs, jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, stats))
    got, ref = seen
    # every val pixel once, the bucket pads and the void row dropped
    n_void = sum(w for _, w in ((60, 80), (90, 60), (70, 70))) * 2
    assert got.sum() == sum(h * w for h, w in ((60, 80), (90, 60), (70, 70))
                            ) * 2 - n_void
    np.testing.assert_array_equal(got, ref)
    assert os.path.isfile(tmp_path / "eval" / "val" / "log_val.txt")


def test_eval_unbucketed_voc_loader_equals_jax(voc_round, monkeypatch):
    """A VOC loader built without buckets: each batch reflect-padded to the
    stride and its logits cropped back (``active/driver.py:pad_to_stride``,
    JAX's ``_pad_to_stride`` branch of ``evaluate``)."""
    from pixelpick_tpu.cli.eval import evaluate as jax_evaluate
    from pixelpick_tpu.utils import metrics as jax_metrics
    from pixelpick_tpu_torch.cli.eval import evaluate
    from pixelpick_tpu_torch.utils import metrics

    jargs, pargs, al, _, _ = voc_round
    params, stats, _ = jax_tree_from_state_dict(al.model.state_dict())
    seen = _confusions(monkeypatch, metrics, jax_metrics)
    with Loader(VOC2012Segmentation(pargs, val=True), 1, mode="val",
                n_workers=2) as pl, \
            JaxLoader(JaxVOC(jargs, val=True), 1, mode="val",
                      n_workers=2) as jl, \
            contextlib.redirect_stdout(io.StringIO()):
        evaluate(pargs, al.model, loader=pl)
        jax_evaluate(jargs, jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, stats), loader=jl)
    got, ref = seen
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0


def test_query_cli_on_voc_equals_jax(voc_round, tmp_path, monkeypatch):
    """Human mode over the mixed-shape pool: the labelled files hold 3 picks
    per image at its base size; both CLIs read the images under
    ``{dir_dataset}/train/``, a checkpoint of the same weights and the
    round's dataset config (``size_base`` 100)."""
    from pixelpick_tpu.cli.query import main as jax_main
    from pixelpick_tpu_torch.cli.query import main

    jargs, pargs, al, _, _ = voc_round
    pargs = copy.copy(pargs)
    root = tmp_path / "voc"
    shutil.copytree(pargs.dir_dataset, root)
    os.makedirs(root / "train")
    rng = np.random.default_rng(9)
    first = {}
    ds = VOC2012Segmentation(default_args(
        "voc", dir_dataset=str(root), dir_checkpoints=str(tmp_path / "x"),
        device="cpu", **SMALL), query=True, generate_init_queries=False)
    pargs.dir_dataset = str(root)
    cfg = _cfg(tmp_path, pargs)
    for i, p in enumerate(ds.list_inputs):
        shutil.copy(p, root / "train")
        h, w = ds.sample_hw(i, "query")
        q = np.zeros(h * w, bool)
        q[rng.choice(h * w, 3, replace=False)] = True
        enc = jax_codec.encode_query(p, (h, w), q.reshape(h, w))
        enc[p]["category_id"] = rng.integers(0, 21, 3).tolist()
        first.update(enc)
    params, stats, _ = jax_tree_from_state_dict(al.model.state_dict())
    ckpt = tmp_path / "model.ckpt"
    ckpt.write_bytes(flax.serialization.msgpack_serialize(
        {"params": params, "batch_stats": stats}))
    out = {}
    for name in ("jax", "port"):
        run = tmp_path / name
        os.makedirs(run / "0_query")
        with open(run / "0_query" / "queries.pkl", "wb") as f:
            pkl.dump(first, f)
        argv = ["-pdc", cfg, "--dataset_name", "voc",
                "--dir_checkpoints", str(run), "--p_state_dict", str(ckpt),
                "--width_multiplier", "0.5", "--n_pixels_by_us", "2",
                "--top_n_percent", "0", "--pool_batch_size", "4",
                "--n_workers", "2"]
        with contextlib.redirect_stdout(io.StringIO()):
            if name == "jax":
                monkeypatch.setattr(sys, "argv", ["query", *argv])
                jax_main()
            else:
                main(argv + ["--device", "cpu"])
        with open(run / "1_query" / "queries.pkl", "rb") as f:
            out[name] = jax_codec.decode_queries(pkl.load(f),
                                                 return_as_dict=True)
    assert sorted(out["port"]) == sorted(out["jax"])
    for p, mask in out["port"].items():
        labelled = jax_codec.decode_query(first[
            next(k for k in first if os.path.basename(k)
                 == os.path.basename(p))]) != 255
        assert mask.shape == labelled.shape and mask.sum() == 2
        assert not (mask & labelled).any()
        np.testing.assert_array_equal(mask, out["jax"][p])
