"""The port's train and eval CLIs (``pixelpick_tpu_torch/cli/{train,eval}.py``)
and its human-label train mode against the JAX package's, on the CPU at
width 0.5, 48x64 (a synthetic CamVid in the custom-dataset layout).

- ``train_sample(..., human_labels=True)``: x, coords, labels and valid
  equal to JAX's exactly, for the same merged label maps, augmentation on,
  at several (epoch, index).
- ``cli/train.py`` on two rounds of labelled ``queries.pkl`` (written as
  tests/test_human_label_training.py writes them) trains the stage
  ``1_query`` and leaves the files the JAX CLI leaves, logs of the same
  header and length.
- ``cli/eval.py`` at weights the JAX package saved (its msgpack
  ``save_checkpoint``) gives JAX ``evaluate``'s confusion matrix exactly and
  its mIoU to 1e-6, and at a batch of 8 the PNG names of
  tests/test_eval_cli.py::test_eval_cli_cadence_multibatch (0 and 9 of 12
  images at interval 3, one PNG per batch at most).
- ``cli/query.py`` at such a file picks what the JAX query CLI picks on
  the same human-labelled rounds, image by image (``top_n_percent 0``: the
  sub-sample's random streams differ between the packages).
"""

import os
import pickle as pkl
import sys

import numpy as np
import pytest

from pixelpick_tpu.active.codec import (
    gather_previous_query_files, merge_previous_query_files,
)
from pixelpick_tpu.cli import eval as jax_eval
from pixelpick_tpu.config import default_args as jax_default_args
from pixelpick_tpu.data import get_dataset as jax_get_dataset
from pixelpick_tpu.engine.checkpoint import save_checkpoint as jax_save
from pixelpick_tpu_torch.cli import eval as port_eval
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.data.factory import get_dataset
from pixelpick_tpu_torch.models import layers
from torch_helpers import HW, N_CLASSES, custom_camvid, jax_deeplab_variables
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

WIDTH = 0.5
pytestmark = pytest.mark.usefixtures("few_torch_threads")


def write_labelled_round(dir_ckpt, nth, img_paths, rng, n_px=4):
    """A round of human-labelled picks, as tests/test_human_label_training.py
    writes them."""
    d = f"{dir_ckpt}/{nth}_query"
    os.makedirs(d, exist_ok=True)
    enc = {}
    for p in img_paths:
        enc[p] = {"height": HW[0], "width": HW[1],
                  "y_coords": rng.integers(0, HW[0], n_px),
                  "x_coords": rng.integers(0, HW[1], n_px),
                  "category": ["x"] * n_px,
                  "category_id": rng.integers(0, 11, n_px).tolist()}
    with open(f"{d}/queries.pkl", "wb") as f:
        pkl.dump(enc, f)


def labelled_rounds(cfg_path, dir_ckpt):
    import yaml

    ds = yaml.safe_load(cfg_path.read_text())["dir_dataset"]
    imgs = sorted(f"/annotator/train/{f}" for f in os.listdir(f"{ds}/train"))
    rng = np.random.default_rng(0)
    for nth in (0, 1):
        write_labelled_round(dir_ckpt, nth, imgs, rng)
    return ds


def test_human_train_sample_matches_jax(tmp_path):
    cfg = custom_camvid(tmp_path)
    ds = labelled_rounds(cfg, tmp_path / "labels")
    merged = merge_previous_query_files(
        gather_previous_query_files(str(tmp_path / "labels")),
        ignore_index=11, verbose=False)
    inputs = [f"{ds}/train/{os.path.basename(p)}" for p in sorted(merged)]
    maps = [merged[p] for p in sorted(merged)]
    over = dict(p_dataset_config=str(cfg), n_pixels_by_us=4,
                dir_checkpoints=str(tmp_path / "labels"))
    jds = jax_get_dataset(jax_default_args(**over))
    pds = get_dataset(default_args(device="cpu", **over))
    jds.set_human_inputs(inputs, maps)
    pds.set_human_inputs(inputs, maps)
    assert pds.list_labels == [] and pds.queries is None
    n_valid = 0
    for epoch, i in ((1, 0), (1, 5), (2, 3), (7, 7)):
        got = pds.train_sample(i, epoch, human_labels=True)
        ref = jds.train_sample(i, epoch, human_labels=True)
        assert sorted(got) == sorted(ref) == ["coords", "labels", "valid",
                                              "x"]
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        n_valid += int(got["valid"].sum())
    assert n_valid > 0


def stage_files(stage):
    return sorted(os.listdir(stage))


def test_train_cli_matches_jax_artifacts(tmp_path, monkeypatch):
    from pixelpick_tpu.cli import train as jax_train
    from pixelpick_tpu_torch.cli.train import main

    cfg = custom_camvid(tmp_path)
    flags = ["-pdc", str(cfg), "--width_multiplier", str(WIDTH),
             "--n_workers", "2", "--seed", "0", "--data_parallel", "1"]
    labelled_rounds(cfg, tmp_path / "port")
    labelled_rounds(cfg, tmp_path / "jax")

    al = main(flags + ["--dir_checkpoints", str(tmp_path / "port"),
                       "--device", "cpu"])
    assert al.human_labels and al.dataset.list_labels == []
    assert al.loader.human_labels and len(al.dataset) == 8

    monkeypatch.setattr(sys, "argv", ["train.py", *flags,
                                      "--dir_checkpoints",
                                      str(tmp_path / "jax")])
    jax_train.main()

    port, ref = tmp_path / "port" / "1_query", tmp_path / "jax" / "1_query"
    assert stage_files(port) == stage_files(ref)
    assert not (tmp_path / "port" / "2_query").exists()
    for log in ("log_train.txt", "log_val.txt"):
        got, want = ((d / log).read_text().split() for d in (port, ref))
        assert got[0] == want[0] and len(got) == len(want) == 2
        assert np.isfinite([float(v) for v in got[1].split(",")]).all()


def test_eval_cli_matches_jax_evaluate(tmp_path, monkeypatch):
    cfg = custom_camvid(tmp_path, n_val=12)
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW, seed=2)
    ckpt = str(tmp_path / "jax_best.ckpt")
    jax_save(ckpt, params, stats)

    hists = {}

    def recording(module, key):
        class Recording(module.RunningScore):
            def get_scores(self):
                hists[key] = np.asarray(self.confusion)
                return super().get_scores()
        monkeypatch.setattr(module, "RunningScore", Recording)

    recording(jax_eval, "jax")
    recording(port_eval, "port")
    jargs = jax_default_args(p_dataset_config=str(cfg),
                             width_multiplier=WIDTH, data_parallel=1,
                             n_workers=2)
    want, want_iu = jax_eval.evaluate(jargs, params, stats,
                                      dir_vis=str(tmp_path / "jax_vis"),
                                      visualize_interval=3)
    try:
        got, got_iu = port_eval.main([
            "-pdc", str(cfg), "--p_state_dict", ckpt, "--dir_checkpoints",
            str(tmp_path / "port"), "--device", "cpu", "--width_multiplier",
            str(WIDTH), "--n_workers", "2", "--val_batch_size", "8",
            "--visualize_interval", "3", "--pallas_dw"])
    finally:
        layers.set_depthwise_impl("xla")

    np.testing.assert_array_equal(hists["port"], hists["jax"])
    assert hists["port"].sum() == 12 * HW[0] * HW[1] - 12  # one void each
    for k in ("Mean IoU", "Pixel Acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(list(got_iu.values()), list(want_iu.values()),
                               rtol=0, atol=1e-6)
    assert sorted(os.listdir(tmp_path / "jax_vis")) == [
        "0.png", "3.png", "6.png", "9.png"]
    vis = tmp_path / "port" / "val"
    assert sorted(os.listdir(vis)) == ["0.png", "9.png", "log_val.txt"]
    rows = (vis / "log_val.txt").read_text().split()
    assert rows[0] == "epoch,miou,pixel_acc" and len(rows) == 2
    assert float(rows[1].split(",")[1]) == pytest.approx(got["Mean IoU"])


def test_query_cli_on_jax_file_matches_jax(tmp_path, monkeypatch):
    from pixelpick_tpu.active.codec import decode_queries
    from pixelpick_tpu.cli import query as jax_query
    from pixelpick_tpu_torch.cli.query import main

    cfg = custom_camvid(tmp_path)
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW, seed=4)
    ckpt = str(tmp_path / "jax_best.ckpt")
    jax_save(ckpt, params, stats)
    flags = ["-pdc", str(cfg), "--p_state_dict", ckpt, "--width_multiplier",
             str(WIDTH), "--n_pixels_by_us", "3", "--top_n_percent", "0",
             "--pool_batch_size", "4", "--n_workers", "2", "--seed", "0",
             "--data_parallel", "1"]
    picks = {}
    for side in ("port", "jax"):
        labelled_rounds(cfg, tmp_path / side)
        argv = flags + ["--dir_checkpoints", str(tmp_path / side)]
        if side == "port":
            main(argv + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["query.py", *argv])
            jax_query.main()
        with open(tmp_path / side / "2_query" / "queries.pkl", "rb") as f:
            picks[side] = decode_queries(pkl.load(f), return_as_dict=True)
    assert sorted(picks["port"]) == sorted(picks["jax"])
    assert len(picks["jax"]) == 8
    for p, mask in picks["jax"].items():
        assert mask.sum() == 3
        np.testing.assert_array_equal(picks["port"][p], mask, err_msg=p)
