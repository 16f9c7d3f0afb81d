"""Mid-stage snapshots (``--stage_ckpt_interval``) and the campaign
fast-forward (``--resume_campaign``) of the port's driver
(``pixelpick_tpu_torch/active/driver.py``), the counterpart of
tests/test_stage_resume.py, on the CPU at width 0.5, 48x64.

A 4-epoch stage interrupted in epoch 3 (its epoch-2 snapshot on disk) and
rerun by a new driver over the same directory ends with the parameters and
BatchNorm statistics of a straight 4-epoch run, bit for bit, dropout on:
the snapshot carries the optimizer's moments and step count and the
dropout generator's state, and the loader's shuffle and augmentation are
functions of (seed, epoch, index). The logs hold epochs 1-4 once each, and
the snapshot is gone. A finished campaign rerun with ``--resume_campaign``
trains nothing, labels the same pixels and leaves its logs untouched.
"""

import os

import pytest
import torch

from pixelpick_tpu_torch.active.driver import ALModel
from pixelpick_tpu_torch.config import default_args
from torch_helpers import custom_camvid
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def make_args(tmp_path, sub, **over):
    return default_args(
        p_dataset_config=str(custom_camvid(tmp_path / sub)), device="cpu",
        dir_checkpoints=str(tmp_path / sub / "run"), width_multiplier=0.5,
        n_pixels_by_us=4, n_workers=2, seed=0, **over)


def rows(path):
    with open(path) as f:
        return f.read().strip().splitlines()


def test_stage_resume_reproduces_uninterrupted_run(tmp_path):
    def run(args, crash_at=None):
        al = ALModel(args)
        al.nth_query = 0
        if crash_at:
            train_epoch = al._train_epoch

            def crashing(epoch, step_fn):
                if epoch == crash_at:
                    raise KeyboardInterrupt
                return train_epoch(epoch, step_fn)

            al._train_epoch = crashing
        try:
            return al._run_stage("0_query").state_dict()
        finally:
            al.close()

    straight = run(make_args(tmp_path, "straight", n_epochs=4,
                             max_budget=4))
    args = make_args(tmp_path, "resumed", n_epochs=4, max_budget=4,
                     stage_ckpt_interval=2)
    with pytest.raises(KeyboardInterrupt):
        run(args, crash_at=3)
    stage = f"{args.dir_checkpoints}/0_query"
    snap = f"{stage}/stage_state.ckpt"
    assert os.path.isfile(snap)
    assert [r.split(",")[0] for r in rows(f"{stage}/log_train.txt")] \
        == ["epoch", "1", "2"]

    resumed = run(args)
    assert not os.path.exists(snap)
    for log in ("log_train.txt", "log_val.txt"):
        assert [r.split(",")[0] for r in rows(f"{stage}/{log}")] \
            == ["epoch", "1", "2", "3", "4"]
    assert list(resumed) == list(straight)
    for k in straight:
        assert torch.equal(resumed[k], straight[k]), k
    assert os.path.isfile(f"{stage}/best_miou_model.ckpt")


def test_resume_campaign_fast_forwards_completed_rounds(tmp_path):
    args = make_args(tmp_path, "campaign", n_epochs=1, max_budget=8,
                     top_n_percent=0.0, pool_batch_size=4)
    al = ALModel(args)
    al()
    al.close()
    n_px = al.dataset.n_pixels_total
    assert n_px == 3 * 4 * 8
    logs = [f"{args.dir_checkpoints}/{s}_query/{f}" for s in (0, 1)
            for f in ("log_train.txt", "log_val.txt", "best_miou_model.ckpt")]
    mtimes = [os.path.getmtime(p) for p in logs]

    args.resume_campaign = True
    al = ALModel(args)
    al._run_stage = None  # no stage may train
    al()
    al.close()
    assert al.dataset.n_pixels_total == n_px
    assert [os.path.getmtime(p) for p in logs] == mtimes
