"""Two active-learning rounds through the port's entry point
``pixelpick_tpu_torch.cli.main_al`` on the CPU (``--device cpu``), with
``--fused_ir --pallas_dw`` (the kernels' plain versions on the CPU), on a
tiny synthetic CamVid-layout dataset at 48x64, as tests/test_e2e_synthetic.py
drives the JAX driver: the artifact layout, the labelled-pixel log lines,
round-1 picks disjoint from the initial ones, and a best checkpoint that
loads.
"""

import contextlib
import io
import os
import pickle as pkl

import numpy as np
import pytest
import torch
import yaml

from pixelpick_tpu_torch.active import codec
from pixelpick_tpu_torch.models import layers
from tests.helpers import make_synthetic_camvid

N_TRAIN, PIXELS = 8, 5


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    from pixelpick_tpu_torch.cli.main_al import main

    tmp = tmp_path_factory.mktemp("al")
    root = make_synthetic_camvid(str(tmp / "ds"), n_train=N_TRAIN, n_test=4)
    os.rename(f"{root}/test", f"{root}/val")
    os.rename(f"{root}/testannot", f"{root}/valannot")
    cfg = dict(dataset_name="custom", dir_dataset=root, batch_size=4,
               ignore_index=11, n_classes=11, n_epochs=2,
               mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25],
               optimizer_type="Adam", lr_scheduler_type="MultiStepLR",
               optimizer_params={"lr": 5e-4, "betas": [0.9, 0.999],
                                 "weight_decay": 2e-4, "eps": 1e-7})
    (tmp / "custom.yaml").write_text(yaml.safe_dump(cfg))
    ckpt = tmp / "ckpt"
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            model = main(["-pdc", str(tmp / "custom.yaml"), "--dir_checkpoints",
                          str(ckpt), "--device", "cpu", "--fused_ir",
                          "--pallas_dw", "--width_multiplier", "0.5",
                          "--n_pixels_by_us", str(PIXELS), "--max_budget",
                          str(2 * PIXELS), "--top_n_percent", "0",
                          "-qs", "margin_sampling", "--n_workers", "2",
                          "--pool_batch_size", "4", "--seed", "1"])
    finally:
        layers.set_depthwise_impl("xla")
    return ckpt, model, out.getvalue()


def test_round_artifacts_exist(campaign):
    from pixelpick_tpu_torch.models.fused_block import FusedIRBlock

    ckpt, al, _ = campaign
    assert sum(isinstance(m, FusedIRBlock) for m in al.model.modules()) == 13
    for stage in ("0_query", "1_query"):
        for f in ("queries.pkl", "query_stats.pkl", "log_train.txt",
                  "log_val.txt", "best_miou_model.ckpt", "timing.json",
                  "1_train.png", "2_train.png", "1_val.png", "2_val.png"):
            assert (ckpt / stage / f).is_file(), f"{stage}/{f}"
        lines = (ckpt / stage / "log_train.txt").read_text().split()
        assert lines[0] == "epoch,mIoU,pixel_acc,loss" and len(lines) == 3
        assert all(np.isfinite(float(r.split(",")[3])) for r in lines[1:])
        lines = (ckpt / stage / "log_val.txt").read_text().split()
        assert lines[0] == "epoch,mIoU,pixel_acc" and len(lines) == 3
    # the final round's picks are written before the loop breaks
    assert (ckpt / "2_query" / "queries.pkl").is_file()


def test_labelled_pixels_grow(campaign):
    _, model, log = campaign
    n = N_TRAIN * PIXELS
    assert f"# labelled pixels is changed from {n} to {2 * n}" in log
    assert f"# labelled pixels is changed from {2 * n} to {3 * n}" in log
    assert model.dataset.n_pixels_total == 3 * n


def test_round1_picks_disjoint_from_initial(campaign):
    ckpt = campaign[0]
    masks = []
    for nth in (0, 1, 2):
        with open(ckpt / f"{nth}_query" / "queries.pkl", "rb") as f:
            masks.append(codec.decode_queries(pkl.load(f)))
    for q0, q1, q2 in zip(*masks):
        assert q0.sum() == q1.sum() == q2.sum() == PIXELS
        assert not (q0 & q1).any() and not ((q0 | q1) & q2).any()


def test_best_checkpoint_loads(campaign):
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.engine.checkpoint import load_checkpoint
    from pixelpick_tpu_torch.models.factory import get_model

    ckpt = campaign[0]
    args = default_args(device="cpu", width_multiplier=0.5, fused_ir=True)
    model = get_model(args)
    load_checkpoint(str(ckpt / "1_query" / "best_miou_model.ckpt"), model)
    for t in model.state_dict().values():
        assert torch.isfinite(t.float()).all()
