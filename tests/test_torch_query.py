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
    plus the port's own --device."""
    def actions(parser):
        return {a.dest: a for a in parser._actions if a.dest != "help"}

    ours, ref = actions(config.build_parser()), actions(jax_build_parser())
    assert set(ours) == set(ref) | {"device"}
    for dest, a in ref.items():
        assert ours[dest].option_strings == a.option_strings, dest
        assert ours[dest].default == a.default, dest
        assert ours[dest].choices == a.choices, dest
    assert ours["device"].default == "cuda"


@pytest.mark.parametrize("flags", [
    ["--network_name", "FPN"], ["--pretrained_ckpt", "backbone.ckpt"],
    ["--s2d_backbone", "true"],
    ["--s2d_backbone", "1"], ["--conv3x3_matmul"],
    ["--spatial_query_sharding"], ["--dist_coordinator", "localhost:1"],
    ["--data_parallel", "2"], ["--dataset_name", "cs"],
    ["--dataset_name", "voc"], ["--dataset_name", "cs", "--n_pixels_by_us",
                                "0"],
    ["--stage_ckpt_interval", "1"], ["--resume_campaign"],
    ["--device_augment"]])
def test_unported_flags_raise(flags):
    args = config.build_parser().parse_args(flags)
    with pytest.raises(NotImplementedError, match="ROADMAP|Queue"):
        config.check_supported(args)


def test_pretrained_ckpt_is_refused_by_main_al(tmp_path):
    """``--pretrained_ckpt`` through ``cli/main_al.py``'s argument path
    raises, naming ROADMAP Queue 1 item 5, where the JAX checkpoint overlay
    comes; it is not quietly ignored."""
    from pixelpick_tpu_torch.cli.main_al import main

    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        main(["--device", "cpu", "--dir_checkpoints", str(tmp_path),
              "--pretrained_ckpt", str(tmp_path / "backbone.ckpt")])


@pytest.mark.parametrize("flags", [
    ["--use_mc_dropout"], ["--micro_batch_size", "2"],
    ["--n_pixels_by_us", "0"]])
def test_ported_round_modes_pass(flags):
    """The micro-batch step, the dense step and the MC-dropout committee
    are ported: their flags pass the check."""
    config.check_supported(config.build_parser().parse_args(flags))


def test_cuda_without_a_card_raises():
    from pixelpick_tpu_torch.models.factory import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is visible: cuda resolves")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
