"""``--spatial_query_sharding`` in the port: the pool sweep split into row
stripes over two gloo ranks on the CPU (``parallel/mesh.py:height_shard``,
``parallel/halo.py``), against the port's single process and against JAX's
``shard_batch_spatial`` sweep on a 2-device virtual mesh.

The maps are 64 rows (the DeepLab's stride-16 split 32 / 32) and 80 rows
(48 / 32) by 48 columns; the FPN's stride 8 splits 64 rows 32 / 32 and 72
rows 40 / 32. Three ranks split 128 rows 48 / 48 / 32, 3 / 3 / 2 rows at
1/16, where the ASPP's rates reach past the next rank's whole stripe.
``--s2d_backbone`` sweeps also run at 68 rows (48 / 20): the 1/4 map has
17 rows, stripes of 12 and 5, so blocks 2-3 run the standard way on both
ranks, as the whole map decides.
The ranks are ``tests/torch_dist_worker.py`` (one run of every scenario
under its own timeout); the test process runs the same scenario
functions at world size 1, where the flag changes nothing.

Tolerances:

- each layer on its stripes against the unsharded op's rows: within 1e-6
  of the op's largest |value| (the global mean and GroupNorm add the
  stripes' sums in another order; the convolutions run at other shapes);
- the sweeps: the picks as sets (ROADMAP Queue 3's tie rule), the stats
  per pick (entropy, label, validity) in pick order and the coverage to
  rtol 1e-5, as ``tests/test_torch_acquisition.py`` holds the port to
  JAX; the round's averaged stats to rtol 1e-5.

JAX runs its XLA depthwise there (not Pallas); the port takes JAX's
weights through ``state_dict_from_jax`` and JAX's draws injected. The
committee's dropout masks cannot match JAX's, so it is held to the port's
single process on the same generator.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from pixelpick_tpu.active import acquisition as jax_acq
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu.parallel.mesh import get_mesh, shard_batch_spatial
from pixelpick_tpu_torch import config
from pixelpick_tpu_torch.active import codec
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.models.layers import BatchNorm
from pixelpick_tpu_torch.models.s2d_block import S2DBatchNorm
from pixelpick_tpu_torch.parallel import distributed, mesh
from test_torch_acquisition import _jax_draws, _pick_sets
from test_torch_distributed import WORKER, run_ranks
from tests.helpers import make_synthetic_camvid
from torch_helpers import jax_deeplab_variables

HEIGHTS = (64, 80)
FPN_HEIGHTS = (64, 72)
WIDTH_PX = 48
LAYER_TOL = 1e-6
STATS_RTOL = 1e-5
KW = dict(strategy="margin_sampling", n_pixels=5, top_n_percent=0.05,
          reverse_order=False)
THREE_RANKS_H = 128
S2D_HEIGHTS = (64, 80, 68)
S2D_JAX_HEIGHTS = (64, 68)
# the blocks in s2d layout: 0-3 where the 1/4 map's rows are even, 0-1
# where they are odd (68 rows)
S2D_BLOCKS = {64: [0, 1, 2, 3], 80: [0, 1, 2, 3], 68: [0, 1],
              THREE_RANKS_H: [0, 1, 2, 3]}
LAYER_OPS = ["conv3x3", "conv3x3_dilated", "atrous_rate6", "atrous_rate18",
             "conv3x3_s2",
             "stem7x7_s2", "conv3x3_matmul", "depthwise_s1", "depthwise_s2",
             "block_s1_fixed_pad", "block_s2_fixed_pad", "block_pallas_dw",
             "s2d_block_s1", "s2d_block_s2",
             "max_pool", "resize_ac_16_to_4", "resize_ac_4_to_1",
             "resize_half_8_to_4", "dropout", "global_mean", "group_norm"]


def pool_batch(h: int, seed: int, n: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.integers(0, 256, (n, h, WIDTH_PX, 3), dtype=np.uint8),
            "excluded": rng.random((n, h, WIDTH_PX)) < 0.1,
            "y": rng.integers(0, worker.N_CLASSES + 1,
                              (n, h, WIDTH_PX)).astype(np.int32)}


def bucket_batch(h: int) -> dict:
    """A VOC-style bucket: two images of true sizes below the bucket's,
    the padding ignore-labelled (``data/loader.py``)."""
    batch = pool_batch(h, 21)
    batch["hw"] = np.array([[h - 13, WIDTH_PX - 8], [h, WIDTH_PX - 5]],
                           np.int32)
    for b, (th, tw) in enumerate(batch["hw"]):
        batch["y"][b, th:] = worker.N_CLASSES
        batch["y"][b, :, tw:] = worker.N_CLASSES
    return batch


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The scenarios, their single-process results and the two ranks'."""
    tmp = tmp_path_factory.mktemp("spatial")
    params, stats = jax_deeplab_variables(worker.N_CLASSES, worker.WIDTH,
                                          (64, WIDTH_PX), seed=3)
    weights = state_dict_from_jax(params, stats)
    spec, batches = {}, {}
    for h in HEIGHTS:
        batches[h] = pool_batch(h, h)
        draws = _jax_draws(jax.random.PRNGKey(11), 2, (h, WIDTH_PX), False)
        score = dict(kind="score", weights=weights, batch=batches[h], kw=KW)
        spec[f"layers_{h}"] = dict(kind="layers", hw=(h, WIDTH_PX),
                                   ops=LAYER_OPS)
        spec[f"jax_{h}"] = dict(score, uniforms={
            k: v.numpy() for k, v in draws.items()})
        spec[f"pallas_{h}"] = dict(score, pallas=True, seed=5)
        spec[f"committee_{h}"] = dict(score, mc=True, seed=5, kw=dict(
            KW, strategy="entropy", mc_n_steps=3))
        spec[f"voc_{h}"] = dict(score, batch=bucket_batch(h), seed=6)
    for h in S2D_HEIGHTS:
        batches.setdefault(h, pool_batch(h, h))
        draws = _jax_draws(jax.random.PRNGKey(11), 2, (h, WIDTH_PX), False)
        spec[f"s2d_{h}"] = dict(
            kind="score", weights=weights, batch=batches[h], kw=KW,
            s2d=True, pallas=True, uniforms={
                k: v.numpy() for k, v in draws.items()})
    spec["s2d_committee"] = dict(
        kind="score", weights=weights, batch=batches[68], s2d=True, mc=True,
        seed=5, kw=dict(KW, strategy="entropy", mc_n_steps=3))
    for h in FPN_HEIGHTS:
        spec[f"fpn_{h}"] = dict(kind="score", fpn=True, batch=pool_batch(
            h, h + 1), kw=KW, seed=7)
    # 24 rows hold one whole stride-16 unit: fewer than the two ranks
    spec["fallback"] = dict(kind="score", weights=weights,
                            batch=pool_batch(24, 24), kw=KW, seed=8)
    # the selector with the flag over synthetic CamVid pools of 5 images
    # in pool batches of 2, 2 and 1
    for name, h, extra in (("select_80", 80, {}),
                           ("select_committee_64", 64, dict(
                               use_mc_dropout=True, mc_n_steps=3))):
        root = make_synthetic_camvid(str(tmp / name), n_train=5, n_test=1,
                                     hw=(h, WIDTH_PX))
        spec[name] = dict(kind="sweep", weights=weights, args=dict(
            dataset_name="cv", dir_dataset=root, n_pixels_by_us=4,
            top_n_percent=0.05, pool_batch_size=2, n_workers=1,
            query_strategy="margin_sampling", width_multiplier=worker.WIDTH,
            spatial_query_sharding=True, **extra))
    single_spec = {k: dict(v) for k, v in spec.items()}
    for name in ("select_80", "select_committee_64"):
        single_spec[name]["args"] = dict(
            spec[name]["args"], dir_checkpoints=str(tmp / f"{name}_single"))
        spec[name]["args"] = dict(
            spec[name]["args"], dir_checkpoints=str(tmp / f"{name}_ranks"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        single = worker.run(single_spec)
    finally:
        torch.set_num_threads(n)
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    port = distributed.free_port()
    run_ranks(lambda r: [sys.executable, WORKER, str(tmp / "spec.pkl"),
                         str(r), "2", str(port), str(tmp / "out.pkl")],
              tmp / "ranks.log")
    with open(tmp / "out.pkl", "rb") as f:
        ranks = pickle.load(f)
    return dict(spec=spec, single=single, ranks=ranks, params=params,
                stats=stats, batches=batches)


@pytest.fixture(scope="module")
def setup3(tmp_path_factory, setup):
    """Every per-layer case and a ``--pallas_dw`` sweep, plain and with
    ``--s2d_backbone``, on three ranks, and in one process."""
    tmp = tmp_path_factory.mktemp("spatial3")
    h = THREE_RANKS_H
    spec = {"layers": dict(kind="layers", hw=(h, WIDTH_PX), ops=LAYER_OPS),
            "sweep": dict(kind="score", weights=setup["spec"]["jax_64"]
                          ["weights"], batch=pool_batch(h, h), kw=KW,
                          pallas=True, seed=9)}
    spec["s2d_sweep"] = dict(spec["sweep"], s2d=True)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        single = worker.run(spec)
    finally:
        torch.set_num_threads(n)
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    port = distributed.free_port()
    run_ranks(lambda r: [sys.executable, WORKER, str(tmp / "spec.pkl"),
                         str(r), "3", str(port), str(tmp / "out.pkl")],
              tmp / "ranks.log", world=3)
    with open(tmp / "out.pkl", "rb") as f:
        ranks = pickle.load(f)
    return dict(single=single, ranks=ranks)


def assert_same_sweep(got: dict, ref: dict, what: str) -> None:
    """The same pick sets, and per pick the same stats in pick order."""
    assert _pick_sets(got["idx"]) == _pick_sets(ref["idx"]), what
    order, ref_order = np.argsort(got["idx"], 1), np.argsort(ref["idx"], 1)
    for k in ("entropy", "labels", "picked_valid"):
        np.testing.assert_allclose(
            np.take_along_axis(np.asarray(got["stats"][k]), order, 1),
            np.take_along_axis(np.asarray(ref["stats"][k]), ref_order, 1),
            rtol=STATS_RTOL, atol=1e-6, err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["stats"]["coverage"],
                               ref["stats"]["coverage"], rtol=STATS_RTOL,
                               err_msg=f"{what} coverage")


@pytest.mark.parametrize("h", HEIGHTS)
@pytest.mark.parametrize("op", LAYER_OPS)
def test_layer_on_stripes_matches_whole(setup, op, h):
    """Each op that pads rows (or sums over them, or draws for them) on
    its two stripes, halo rows from the other rank, gathered: the
    unsharded op's output within 1e-6 of its largest |value|."""
    got = setup["ranks"][f"layers_{h}"][op]
    ref = setup["single"][f"layers_{h}"][op]
    assert got.shape == ref.shape, (op, got.shape, ref.shape)
    err = float((got - ref).abs().max())
    assert err <= LAYER_TOL * float(ref.abs().max()), (op, h, err)


@pytest.mark.parametrize("op", LAYER_OPS)
def test_layer_on_three_stripes_matches_whole(setup3, op):
    """The same on three ranks: a halo reaches across a whole stripe (the
    atrous rates at 1/16), or past the image through two stripes."""
    got, ref = setup3["ranks"]["layers"][op], setup3["single"]["layers"][op]
    assert got.shape == ref.shape, (op, got.shape, ref.shape)
    err = float((got - ref).abs().max())
    assert err <= LAYER_TOL * float(ref.abs().max()), (op, err)


def test_sweep_on_three_ranks_matches_single_process(setup3):
    """A ``--pallas_dw`` sweep on three ranks' stripes: the same picks and
    stats as one process."""
    got, ref = setup3["ranks"]["sweep"], setup3["single"]["sweep"]
    assert got["sharded"] and not ref["sharded"]
    assert_same_sweep(got, ref, "three ranks")


def test_s2d_sweep_on_three_ranks_matches_single_process(setup3):
    """The ``--s2d_backbone --pallas_dw`` sweep on three ranks' stripes
    (6 / 6 / 4 cell rows in blocks 2-3): the same picks and stats as one
    process, blocks 0-3 in s2d layout on every rank."""
    got, ref = setup3["ranks"]["s2d_sweep"], setup3["single"]["s2d_sweep"]
    assert got["sharded"] and not ref["sharded"]
    assert_same_sweep(got, ref, "three ranks s2d")
    assert got["s2d_blocks"] == [S2D_BLOCKS[THREE_RANKS_H]] * 3


@pytest.mark.parametrize("h", HEIGHTS)
def test_sweep_matches_single_process(setup, h):
    """The two-rank height-sharded sweep at JAX's draws against the
    port's single-process sweep: the same picks and stats."""
    got, ref = setup["ranks"][f"jax_{h}"], setup["single"][f"jax_{h}"]
    assert got["sharded"] and not ref["sharded"]
    assert_same_sweep(got, ref, f"jax_{h}")


def jax_mesh_sweep(setup, h: int, s2d_until: int = 0) -> dict:
    """JAX's ``make_score_fn`` on the ``h``-row batch sharded by height
    over a 2-device mesh (``shard_batch_spatial``), at the scenarios'
    weights and draws."""
    kw = dict(KW, mean=worker.MEAN, std=worker.STD,
              ignore_index=worker.N_CLASSES)
    jax_fn = jax_acq.make_score_fn(
        JaxDeepLab(n_classes=worker.N_CLASSES, width_mult=worker.WIDTH,
                   s2d_until=s2d_until),
        n_classes=worker.N_CLASSES, **kw)
    batch = shard_batch_spatial(setup["batches"][h], get_mesh(n_devices=2))
    assert batch["x"].sharding.spec == (None, "data")
    idx, stats = jax_fn(jax.tree.map(jnp.asarray, setup["params"]),
                        jax.tree.map(jnp.asarray, setup["stats"]), batch,
                        jax.random.PRNGKey(11))
    return {"idx": np.asarray(idx),
            "stats": {k: np.asarray(v) for k, v in stats.items()}}


@pytest.mark.parametrize("h", HEIGHTS)
def test_sweep_matches_jax_spatial_mesh(setup, h):
    """The same sweep against JAX's ``make_score_fn`` with the batch
    sharded by height over a 2-device mesh (``shard_batch_spatial``), at
    the same weights and draws."""
    assert_same_sweep(setup["ranks"][f"jax_{h}"], jax_mesh_sweep(setup, h),
                      f"jax mesh {h}")


@pytest.mark.parametrize("name", [f"s2d_{h}" for h in S2D_HEIGHTS]
                         + ["s2d_committee"])
def test_s2d_sweep_matches_single_process(setup, name):
    """``--s2d_backbone`` on two ranks' stripes (with ``--pallas_dw`` at
    JAX's draws, and the MC-dropout committee of 3 members by entropy at
    68 rows): the same picks and stats as the single-process s2d sweep.
    Every rank runs the blocks in s2d layout that one process runs, as
    the whole map decides: blocks 2-3 run the standard way at 68 rows on
    both ranks, though rank 0's stripe of the 1/4 map has 12 rows. One
    stride-2 grouped conv per forward (block 6) where blocks 1 and 3 run
    in s2d layout, two (blocks 3 and 6) where block 3 does not."""
    got, ref = setup["ranks"][name], setup["single"][name]
    assert got["sharded"] and not ref["sharded"]
    assert_same_sweep(got, ref, name)
    blocks = S2D_BLOCKS[setup["spec"][name]["batch"]["x"].shape[1]]
    assert got["s2d_blocks"] == [blocks, blocks]
    assert ref["s2d_blocks"] == [blocks]
    if setup["spec"][name].get("pallas"):
        s2 = 1 if blocks[-1] == 3 else 2
        assert got["launches"] == ref["launches"] \
            == {"kernel": 0, "kernel_dx": 0, "stride2_conv": s2}


@pytest.mark.parametrize("h", S2D_JAX_HEIGHTS)
def test_s2d_sweep_matches_jax_spatial_mesh(setup, h):
    """The two-rank s2d sweep against JAX's s2d ``make_score_fn``
    (``DeepLab(s2d_until=4)``) on the 2-device height-sharded mesh, at
    the same weights and draws."""
    assert_same_sweep(setup["ranks"][f"s2d_{h}"],
                      jax_mesh_sweep(setup, h, s2d_until=4),
                      f"jax s2d mesh {h}")


@pytest.mark.parametrize("name", ["pallas", "committee", "voc"])
@pytest.mark.parametrize("h", HEIGHTS)
def test_sweep_variants_match_single_process(setup, name, h):
    """``--pallas_dw`` (the kernel's plain version on halo-padded stripes
    here; 3 stride-2 grouped convs per forward on each rank), the
    MC-dropout committee (3 members, entropy, the whole maps' masks
    sliced) and a VOC bucket whose images are smaller than the bucket
    (``hw``): the same picks and stats as one process."""
    got = setup["ranks"][f"{name}_{h}"]
    ref = setup["single"][f"{name}_{h}"]
    assert got["sharded"]
    assert_same_sweep(got, ref, f"{name}_{h}")
    if name == "pallas":
        assert got["launches"] == ref["launches"] \
            == {"kernel": 0, "kernel_dx": 0, "stride2_conv": 3}
    if name == "voc":
        hw = setup["spec"][f"voc_{h}"]["batch"]["hw"]
        ys, xs = got["idx"] // WIDTH_PX, got["idx"] % WIDTH_PX
        assert (ys < hw[:, :1]).all() and (xs < hw[:, 1:]).all()


@pytest.mark.parametrize("h", FPN_HEIGHTS)
def test_fpn_sweep_matches_single_process(setup, h):
    """The ResNet-18 FPN (stride 8: the 7x7 stem, the -inf max pool, the
    dilated blocks, GroupNorm's sums over the ranks, the x2 resizes): the
    same picks and stats as one process."""
    got, ref = setup["ranks"][f"fpn_{h}"], setup["single"][f"fpn_{h}"]
    assert got["sharded"]
    assert_same_sweep(got, ref, f"fpn_{h}")


def test_replicated_fallback_warns(setup):
    """24 rows hold one whole stride-16 unit, fewer than the two ranks:
    the sweep runs replicated with a warning, and picks what one process
    picks."""
    got, ref = setup["ranks"]["fallback"], setup["single"]["fallback"]
    assert got["warned"] and not got["sharded"]
    assert not ref["warned"]
    assert_same_sweep(got, ref, "fallback")


@pytest.mark.parametrize("name", ["select_80", "select_committee_64"])
def test_selector_with_the_flag(setup, name):
    """``QuerySelector`` under ``--spatial_query_sharding`` over a pool of
    5 images (batches of 2, 2 and 1), plain and with the committee: each
    image's picks as one process picks them, as sets, and the round's
    stats the primary writes."""
    got, ref = setup["ranks"][name], setup["single"][name]
    assert sorted(got["picks"]) == sorted(ref["picks"])
    for g, r in zip(codec.decode_queries(got["picks"]),
                    codec.decode_queries(ref["picks"])):
        assert set(zip(*np.nonzero(g))) == set(zip(*np.nonzero(r)))
        assert r.sum() == 4
    for k in ("avg_entropy", "avg_n_unique_labels", "avg_spatial_coverage"):
        np.testing.assert_allclose(got["stats"][k], ref["stats"][k],
                                   rtol=STATS_RTOL, err_msg=k)
    assert got["stats"]["label_distribution"] \
        == ref["stats"]["label_distribution"]


def test_height_shard_rule(monkeypatch):
    """The stripes: boundaries on multiples of the total stride, as equal
    as they go with the first ranks taking the extra unit, the last
    ending at the image's height; fewer whole units than ranks replicate;
    one rank never shards. Every stripe's level is found from its rows."""
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    assert mesh.height_shard(360, 16).bounds == (0, 192, 360)
    assert mesh.height_shard(80, 16).bounds == (0, 48, 80)
    assert mesh.height_shard(72, 8).bounds == (0, 40, 72)
    # 40 rows: 3 units would leave the last stripe 8 rows; 2 whole ones
    assert mesh.height_shard(40, 16).bounds == (0, 16, 40)
    shard = mesh.height_shard(360, 16)
    assert [shard.rows_at(s) for s in (1, 2, 4, 8, 16)] == [
        (192, 360), (96, 180), (48, 90), (24, 45), (12, 23)]
    assert [shard.level(n) for n in (168, 84, 42, 21, 11)] == [1, 2, 4, 8, 16]
    with pytest.warns(UserWarning, match="replicated"):
        assert mesh.height_shard(24, 16) is None
    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    assert mesh.height_shard(360, 16).bounds == (0, 96, 192, 288, 360)
    monkeypatch.setattr(distributed, "world_size", lambda: 1)
    assert mesh.height_shard(360, 16) is None


def test_s2d_under_the_flag_refused():
    """``--s2d_backbone`` with ``--spatial_query_sharding`` is ported: the
    parser takes it on the DeepLab (with data parallelism too), and on
    the FPN, which ignores ``--s2d_backbone``. Nothing is refused any
    more."""
    parse = config.build_parser().parse_args
    for extra in ([], ["--data_parallel", "2"], ["--network_name", "FPN"]):
        args = parse(["--spatial_query_sharding", "--s2d_backbone", "true",
                      *extra])
        assert args.spatial_query_sharding and args.s2d_backbone


def test_s2d_batchnorm_train_refuses_a_height_shard():
    """The train-mode s2d BatchNorm under a height shard raises as the
    standard one does (a shard runs the eval-mode sweep only); in eval
    mode both run."""
    x = torch.ones((2, 16, 4, 6))
    shard = mesh.HeightShard((0, 16, 32), 0, 16)
    for bn, call in ((S2DBatchNorm(4), S2DBatchNorm.forward_s2d),
                     (BatchNorm(16), BatchNorm.forward)):
        with mesh.sharded_height(shard):
            with pytest.raises(RuntimeError, match="eval-mode sweep only"):
                call(bn.train(), x)
            call(bn.eval(), x)
    assert S2DBatchNorm(4).train().forward_s2d(x)[0].shape == x.shape


def _same_queries(a, b) -> bool:
    if sorted(a) != sorted(b):
        return False
    return all(set(zip(*np.nonzero(a[k]))) == set(zip(*np.nonzero(b[k])))
               for k in a)


def _decoded(path) -> dict:
    with open(path, "rb") as f:
        enc = pickle.load(f)
    return dict(zip(sorted(enc), codec.decode_queries(
        {k: enc[k] for k in sorted(enc)})))


def _overlap(picks: dict, *labelled: dict) -> bool:
    """Whether a pick falls on a labelled pixel (the files' keys matched
    by file name)."""
    done = {}
    for q in labelled:
        for k, m in q.items():
            done[os.path.basename(k)] = done.get(os.path.basename(k), 0) | m
    return any((m & done[os.path.basename(k)]).any()
               for k, m in picks.items())


def _write_labelled(src, dst) -> None:
    """``src``'s picks as the annotation tools write them (``category_id``
    filled in, here class 0), so that the query CLI excludes just those
    pixels from its pool."""
    with open(src, "rb") as f:
        enc = pickle.load(f)
    for info in enc.values():
        info["category_id"] = np.zeros(len(info["x_coords"]), np.int64)
    dst.parent.mkdir(parents=True, exist_ok=True)
    with open(dst, "wb") as f:
        pickle.dump(enc, f)


def test_entry_points_with_the_flag(tmp_path):
    """``main_al --spatial_query_sharding --data_parallel 2 --device cpu``
    (two rounds on 48x64 images: stripes of 32 and 16 rows) writes the
    round files of the run without the flag, the same picks as sets; then
    the query CLI with the flag over its labelled rounds picks what it
    picks without. With ``--s2d_backbone true`` (top-k picks, no draws):
    one round of ``main_al`` with the flag, then the query CLI with and
    without the flag over its round 0 and checkpoint, all three the same
    picks."""
    from torch_helpers import custom_camvid

    cfg = custom_camvid(tmp_path, n_train=6, n_val=2)
    common = ["--device", "cpu", "-pdc", str(cfg), "--width_multiplier",
              "0.5", "--n_pixels_by_us", "3", "--top_n_percent", "0.05",
              "-qs", "margin_sampling", "--n_workers", "1",
              "--pool_batch_size", "4", "--data_parallel", "2"]
    runs = {}
    for name, flag in (("flag", ["--spatial_query_sharding"]),
                       ("plain", [])):
        runs[name] = tmp_path / name
        run_ranks(lambda r: [
            sys.executable, "-m", "pixelpick_tpu_torch.cli.main_al",
            *common, "--max_budget", "6", "--dir_checkpoints",
            str(runs[name]), *flag], tmp_path / f"{name}.log", world=1)
    for r in (1, 2):
        assert _same_queries(
            _decoded(runs["flag"] / f"{r}_query" / "queries.pkl"),
            _decoded(runs["plain"] / f"{r}_query" / "queries.pkl")), r
    cli = {}
    for name, flag in (("flag", ["--spatial_query_sharding"]),
                       ("plain", [])):
        d = tmp_path / f"cli_{name}"
        for r in (0, 1):
            _write_labelled(runs["flag"] / f"{r}_query" / "queries.pkl",
                            d / f"{r}_query" / "queries.pkl")
        run_ranks(lambda r: [
            sys.executable, "-m", "pixelpick_tpu_torch.cli.query", *common,
            "--p_state_dict", str(runs["flag"] / "0_query" /
                                  "best_miou_model.ckpt"),
            "--dir_checkpoints", str(d), *flag], tmp_path / f"cli_{name}.log",
            world=1)
        cli[name] = _decoded(d / "2_query" / "queries.pkl")
    assert len(cli["flag"]) == 6 and _same_queries(cli["flag"], cli["plain"])
    assert not _overlap(cli["flag"], *(
        _decoded(runs["flag"] / f"{r}_query" / "queries.pkl")
        for r in (0, 1)))

    s2d = ["--s2d_backbone", "true", "--top_n_percent", "0"]
    run_ranks(lambda r: [
        sys.executable, "-m", "pixelpick_tpu_torch.cli.main_al", *common,
        *s2d, "--max_budget", "3", "--dir_checkpoints",
        str(tmp_path / "s2d"), "--spatial_query_sharding"],
        tmp_path / "s2d.log", world=1)
    picks = {"main_al": _decoded(tmp_path / "s2d" / "1_query" /
                                 "queries.pkl")}
    for name, flag in (("flag", ["--spatial_query_sharding"]),
                       ("plain", [])):
        d = tmp_path / f"s2d_cli_{name}"
        _write_labelled(tmp_path / "s2d" / "0_query" / "queries.pkl",
                        d / "0_query" / "queries.pkl")
        run_ranks(lambda r: [
            sys.executable, "-m", "pixelpick_tpu_torch.cli.query", *common,
            *s2d, "--p_state_dict", str(tmp_path / "s2d" / "0_query" /
                                        "best_miou_model.ckpt"),
            "--dir_checkpoints", str(d), *flag],
            tmp_path / f"s2d_cli_{name}.log", world=1)
        picks[name] = _decoded(d / "1_query" / "queries.pkl")
    assert len(picks["plain"]) == 6
    assert not _overlap(picks["plain"], _decoded(
        tmp_path / "s2d" / "0_query" / "queries.pkl"))
    for name in ("main_al", "flag"):
        assert _same_queries(picks[name], picks["plain"]), name
