"""The port's query round end to end on the CPU: ``QuerySelector`` in oracle
mode against the JAX one on a 48x64 synthetic CamVid at shared weights
(width 0.5, ``top_n_percent 0``), the standalone query CLI in human mode,
and the flag surface."""

import os
import pickle as pkl

import numpy as np
import pytest
import torch
from PIL import Image

from helpers import make_synthetic_camvid, synthetic_args
from pixelpick_tpu.active import codec as jax_codec
from pixelpick_tpu.active.selector import QuerySelector as JaxQuerySelector
from pixelpick_tpu.config import build_parser as jax_build_parser
from pixelpick_tpu.data import Loader as JaxLoader, get_dataset as jax_get_dataset
from pixelpick_tpu.models import get_model as jax_get_model
from pixelpick_tpu_torch import config
from pixelpick_tpu_torch.active.selector import QuerySelector
from pixelpick_tpu_torch.data.factory import get_dataset
from pixelpick_tpu_torch.data.loader import Loader
from pixelpick_tpu_torch.engine.checkpoint import save_checkpoint
from pixelpick_tpu_torch.models import layers
from torch_helpers import jax_deeplab_variables, port_deeplab

N_CLASSES, WIDTH, HW = 11, 0.5, (48, 64)


def test_oracle_round_matches_jax(tmp_path):
    """Same initial queries, same picks per image (as sets), same stats,
    same labelled masks after the round. Pool batch 3 over 8 images leaves a
    remainder batch, which the JAX selector pads and the port does not."""
    over = dict(top_n_percent=0.0, width_multiplier=WIDTH, pool_batch_size=3)
    jargs = synthetic_args(tmp_path / "jax", **over)
    pargs = config.default_args(
        device="cpu", dir_dataset=jargs.dir_dataset,
        dir_checkpoints=str(tmp_path / "port"),
        **{k: getattr(jargs, k) for k in (
            "n_pixels_by_us", "max_budget", "n_workers")}, **over)
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW)

    jds = jax_get_dataset(jargs, val=False, query=True)
    with JaxLoader(jds, 3, mode="query", n_workers=2) as jl:
        ref = JaxQuerySelector(jargs, jl, jax_get_model(jargs))(
            nth_query=0, params=params, batch_stats=stats)

    pds = get_dataset(pargs, val=False, query=True)
    with open(f"{jargs.dir_checkpoints}/0_query/queries.pkl", "rb") as f:
        initial = jax_codec.decode_queries(pkl.load(f))
    for a, b in zip(pds.queries, initial):  # the same seeded initial picks
        np.testing.assert_array_equal(a, b)
    with Loader(pds, 3, mode="query", n_workers=2) as pl:
        got = QuerySelector(pargs, pl, port_deeplab(params, stats, N_CLASSES,
                                                    WIDTH), "cpu")(nth_query=0)

    assert sorted(got) == sorted(ref)
    for p in ref:
        np.testing.assert_array_equal(jax_codec.decode_query(got[p]),
                                      jax_codec.decode_query(ref[p]))
        assert len(got[p]["x_coords"]) == pargs.n_pixels_by_us
    for a, b in zip(pds.queries, jds.queries):
        np.testing.assert_array_equal(a, b)
    assert pds.n_pixels_total == jds.n_pixels_total == 2 * 8 * 5

    def load_stats(d):
        with open(f"{d}/0_query/query_stats.pkl", "rb") as f:
            return pkl.load(f)

    gs, rs = load_stats(pargs.dir_checkpoints), load_stats(jargs.dir_checkpoints)
    assert gs["label_distribution"] == rs["label_distribution"]
    for k in ("avg_entropy", "avg_n_unique_labels", "avg_spatial_coverage"):
        np.testing.assert_allclose(gs[k], rs[k], rtol=1e-5)


def test_query_cli_human_mode(tmp_path):
    """The port's CLI reads human-labelled query files and a port checkpoint
    and writes the next round's queries.pkl, which the JAX package's codec
    decodes; no pick lands on an already-labelled pixel."""
    from pixelpick_tpu_torch.cli.query import main

    root = make_synthetic_camvid(str(tmp_path / "camvid"), n_train=5)
    run = tmp_path / "run"
    rng = np.random.default_rng(0)
    labelled = {}
    first = {}
    for name in sorted(os.listdir(f"{root}/train")):
        gt = np.asarray(Image.open(f"{root}/trainannot/{name}"), np.int64)
        q = np.zeros(HW, bool)
        q.flat[rng.choice(HW[0] * HW[1], 4, replace=False)] = True
        enc = jax_codec.encode_query(f"/elsewhere/train/{name}", HW, q)
        enc[f"/elsewhere/train/{name}"]["category_id"] = gt[q].tolist()
        first.update(enc)
        labelled[name] = q
    os.makedirs(run / "0_query")
    with open(run / "0_query" / "queries.pkl", "wb") as f:
        pkl.dump(first, f)
    ckpt = str(tmp_path / "model.ckpt")
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW)
    save_checkpoint(ckpt, port_deeplab(params, stats, N_CLASSES, WIDTH))

    try:
        path = main(["--dataset_name", "cv", "--dir_datasets", str(tmp_path),
                     "--dir_checkpoints", str(run), "--p_state_dict", ckpt,
                     "--width_multiplier", str(WIDTH), "--device", "cpu",
                     "--pallas_dw", "--n_pixels_by_us", "3",
                     "--pool_batch_size", "2", "--n_workers", "2"])
    finally:
        layers.set_depthwise_impl("xla")
    assert path == f"{run}/1_query/queries.pkl"
    with open(path, "rb") as f:
        picks = jax_codec.decode_queries(pkl.load(f), return_as_dict=True)
    assert sorted(os.path.basename(p) for p in picks) == sorted(labelled)
    for p, mask in picks.items():
        assert mask.shape == HW and mask.sum() == 3
        assert not (mask & labelled[os.path.basename(p)]).any()


def test_flag_surface_matches_jax():
    """Every flag of the JAX package, with the same default and choices,
    plus the port's own --device and --dist_backend."""
    def actions(parser):
        return {a.dest: a for a in parser._actions if a.dest != "help"}

    ours, ref = actions(config.build_parser()), actions(jax_build_parser())
    assert set(ours) == set(ref) | {"device", "dist_backend"}
    for dest, a in ref.items():
        assert ours[dest].option_strings == a.option_strings, dest
        assert ours[dest].default == a.default, dest
        assert ours[dest].choices == a.choices, dest
    assert ours["device"].default == "cuda"


def _parsed(flags):
    """``build_parser().parse_args(flags)``, checked to give each flag of
    ``flags`` its value, other than its default: a switch True, a flag
    with a value that value as the parser types it."""
    parser = config.build_parser()
    args = parser.parse_args(flags)
    actions = {s: a for a in parser._actions for s in a.option_strings}
    i = 0
    while i < len(flags):
        action = actions[flags[i]]
        if action.nargs == 0:  # a switch
            want, i = action.const, i + 1
        else:
            want, i = (action.type or str)(flags[i + 1]), i + 2
        got = getattr(args, action.dest)
        assert got == want and got != action.default, (flags, action.dest)
    return args


@pytest.mark.parametrize("flags", [
    ["--spatial_query_sharding"],
    ["--spatial_query_sharding", "--data_parallel", "2"],
    ["--dataset_name", "voc", "--spatial_query_sharding"],
    ["--dist_coordinator", "localhost:1", "--spatial_query_sharding"]])
def test_spatial_query_sharding_flags_accepted(flags):
    """--spatial_query_sharding is ported (alone, with data parallelism,
    on VOC's buckets, under a coordinator): the parser takes it with the
    other flags."""
    assert _parsed(flags).spatial_query_sharding


@pytest.mark.parametrize("flags", [
    ["--use_mc_dropout"], ["--micro_batch_size", "2"],
    ["--n_pixels_by_us", "0"], ["--pretrained_ckpt", "backbone.ckpt"],
    ["--stage_ckpt_interval", "1"], ["--resume_campaign"],
    ["--dataset_name", "cs"], ["--dataset_name", "cs", "--n_pixels_by_us",
                               "0"],
    ["--device_augment"], ["--network_name", "FPN"],
    ["--network_name", "FPN", "--use_dilated_resnet", "false"],
    ["--dataset_name", "voc"], ["--network_name", "FPN", "--dataset_name",
                                "cs"],
    ["--dataset_name", "voc", "--n_pixels_by_us", "0"],
    ["--dataset_name", "voc", "--network_name", "FPN", "--fused_ir",
     "--pallas_dw"],
    ["--dist_coordinator", "localhost:1"], ["--data_parallel", "2"],
    ["--dataset_name", "voc", "--device_augment"],
    ["--dataset_name", "voc", "--network_name", "FPN", "--device_augment"],
    ["--network_name", "FPN", "--dataset_name", "cs", "--data_parallel",
     "2"],
    ["--dataset_name", "voc", "--n_pixels_by_us", "0", "--device_augment"],
    ["--network_name", "FPN", "--s2d_backbone", "true"],
    ["--s2d_backbone", "true"],
    ["--s2d_backbone", "1"], ["--conv3x3_matmul"],
    ["--network_name", "FPN", "--conv3x3_matmul", "--data_parallel", "2"],
    ["--dataset_name", "voc", "--device_augment", "--s2d_backbone", "true"]])
def test_ported_round_modes_pass(flags):
    """The micro-batch step, the dense step, the MC-dropout committee, the
    pretrained overlay, stage snapshots, the campaign fast-forward, the
    Cityscapes and VOC datasets, the FPN, device augmentation (VOC's too),
    data parallelism and the rewrites ``--s2d_backbone`` and
    ``--conv3x3_matmul`` are ported: the parser takes their flags."""
    _parsed(flags)


def test_pretrained_ckpt_through_main_al(tmp_path, monkeypatch):
    """``--pretrained_ckpt`` through ``cli/main_al.py``'s argument path: a
    backbone-only JAX msgpack file (``python -m pixelpick_tpu.models.convert
    --kind mobilenet_v2`` writes that layout) is in round 0's model before
    its first update, and every other tensor is the round's own init."""
    import flax.serialization
    import yaml

    from pixelpick_tpu_torch.active import driver
    from pixelpick_tpu_torch.cli.main_al import main
    from pixelpick_tpu_torch.models.convert import state_dict_from_jax
    from pixelpick_tpu_torch.models.factory import get_model

    root = make_synthetic_camvid(str(tmp_path / "ds"), n_train=4, n_test=2)
    os.rename(f"{root}/test", f"{root}/val")
    os.rename(f"{root}/testannot", f"{root}/valannot")
    cfg = dict(dataset_name="custom", dir_dataset=root, batch_size=4,
               ignore_index=11, n_classes=N_CLASSES, n_epochs=1,
               mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25],
               optimizer_type="Adam", lr_scheduler_type="MultiStepLR",
               optimizer_params={"lr": 5e-4, "betas": [0.9, 0.999],
                                 "weight_decay": 2e-4, "eps": 1e-7})
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW, seed=5)
    payload = {"params": {"backbone": params["backbone"]},
               "batch_stats": {"backbone": stats["backbone"]}}
    ckpt = tmp_path / "mnv2.ckpt"
    ckpt.write_bytes(flax.serialization.msgpack_serialize(payload))

    seen = {}

    class Stop(Exception):
        pass

    def first_epoch(self, epoch, step_fn):
        seen.update({k: v.clone() for k, v in self.model.state_dict().items()})
        seen["args"] = self.args
        raise Stop

    monkeypatch.setattr(driver.ALModel, "_train_epoch", first_epoch)
    with pytest.raises(Stop):
        main(["-pdc", str(tmp_path / "cfg.yaml"), "--dir_checkpoints",
              str(tmp_path / "run"), "--device", "cpu", "--width_multiplier",
              str(WIDTH), "--n_pixels_by_us", "3", "--max_budget", "3",
              "--n_workers", "2", "--seed", "4", "--pretrained_ckpt",
              str(ckpt)])

    want = state_dict_from_jax(payload["params"], payload["batch_stats"])
    fresh = get_model(seen.pop("args"), "cpu",
                      seed=driver.round_seed(4, 0)).state_dict()
    assert set(seen) == set(fresh)
    assert len(want) == sum(k.startswith("backbone.") for k in fresh)
    for k, v in seen.items():
        assert torch.equal(v, want[k] if k in want else fresh[k]), k
    assert not torch.equal(want["backbone.features.0.0.weight"],
                           fresh["backbone.features.0.0.weight"])


def test_cuda_without_a_card_raises():
    from pixelpick_tpu_torch.models.factory import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is visible: cuda resolves")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
