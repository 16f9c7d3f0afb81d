"""The port's data parallelism (``pixelpick_tpu_torch/parallel/``) against
the JAX package's sharded step and against the port's own single process,
on the CPU.

Two gloo processes (``tests/torch_dist_worker.py``) run each scenario on
their rows of the global batch; the test process runs the same functions at
world size 1, and JAX's sparse step on a 2-device virtual mesh
(``tests/conftest.py`` gives 8 devices) at the same weights and batches,
its dropout off, as ``tests/test_torch_train_step.py`` runs it.

Tolerances, as ``tests/test_torch_train_step.py``: the loss 1e-5 relative;
the confusion matrices exactly; every gradient within 1e-4 of its own
largest |value| plus 1e-6 of the step's largest |gradient|; the running
statistics 1e-4 of their largest |value| (at least 1) and the parameters
after the update 1e-4 of their move plus 1e-6 of their largest |value|.
Validation histograms exactly; a fixed-weight sweep's picks as sets
(ROADMAP Queue 3's tie rule). Every multi-process run has its own timeout,
so a hang fails one test.
"""

import os
import pickle
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_worker as worker
from pixelpick_tpu.engine import trainer as jax_trainer
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu_torch import config
from pixelpick_tpu_torch.active import codec
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.parallel import distributed, mesh
from tests.helpers import make_synthetic_camvid
from torch_helpers import (
    HW, N_CLASSES, custom_camvid, jax_deeplab_variables, sparse_batches,
    well_conditioned,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
TIMEOUT = 120  # seconds, for each multi-process run
JAX_STEPS = ("bn0", "bn4", "rem")


def run_ranks(args: list, log, world: int = 2, timeout: float = TIMEOUT):
    """``args`` (a command per rank, given its rank) as ``world``
    processes; raises on a timeout or a failed rank, with their logs."""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = []
    with open(log, "w") as out:
        for r in range(world):
            procs.append(subprocess.Popen(args(r), cwd=REPO, env=env,
                                          stdout=out,
                                          stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    text = open(log).read()
    assert all(p.returncode == 0 for p in procs), text[-4000:]
    return text


def sharded_batch(batches):
    """Two train batches of 4 as one of 8."""
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The scenarios, their single-process results and the two ranks'."""
    tmp = tmp_path_factory.mktemp("dist")
    params, stats = jax_deeplab_variables(N_CLASSES, worker.WIDTH, HW,
                                          seed=2)
    params = well_conditioned(params, np.random.default_rng(102))
    weights = state_dict_from_jax(params, stats)
    batch8 = sharded_batch(sparse_batches(2, seed=7))
    # a remainder of 7 padded to 8 as the driver pads it: rank 0 holds 4
    # rows of picks, rank 1 three with fewer valid and the pad row none
    rem = {k: v[:7].copy() for k, v in batch8.items()}
    rem["valid"][4:, 3:] = False
    rem, n_real = mesh.pad_batch_to_devices(rem, pad_label=11, multiple=2)
    assert n_real == 7 and not rem["valid"][7].any()
    micro = sharded_batch(sparse_batches(3, seed=8))  # a megabatch of 12
    micro["valid"][8:] = False  # the last micro-batch of 4: all pad
    # 12 rows in groups of 4 over two ranks: the middle group spans them
    rng = np.random.default_rng(10)
    bn = {k: rng.standard_normal(shape).astype(np.float32)
          for k, shape in (("x", (12, 6, 5, 7)), ("w", (12, 6, 5, 7)),
                           ("scale", (6,)), ("bias", (6,)))}
    bn["x"] += 1.0
    rng = np.random.default_rng(9)
    val = {"x": rng.integers(0, 256, (5, *HW, 3), dtype=np.uint8),
           "y": rng.integers(0, N_CLASSES + 1, (5, *HW)).astype(np.int32)}
    # a pool of 9: batches of 4, 4 and 1
    root = make_synthetic_camvid(str(tmp / "cv"), n_train=9, n_test=1)
    sweep_args = dict(dataset_name="cv", dir_dataset=root,
                      dir_checkpoints=str(tmp / "sweep"), n_pixels_by_us=3,
                      top_n_percent=0.05, pool_batch_size=4,
                      query_strategy="margin_sampling", n_workers=1,
                      width_multiplier=worker.WIDTH)
    step = dict(kind="step", weights=weights, dropout=False)
    spec = {
        "bn0": dict(step, bn_groups=0, batch=batch8),
        "bn4": dict(step, bn_groups=4, batch=batch8),
        "rem": dict(step, bn_groups=0, batch=rem),
        "bn_span": dict(kind="bn", groups=4, **bn),
        "drop": dict(step, bn_groups=0, batch=batch8, dropout=True),
        "s2d": dict(step, bn_groups=0, batch=batch8, s2d=True),
        "micro": dict(kind="micro", weights=weights, bn_groups=0,
                      dropout=True, micro=4, batch=micro),
        "eval": dict(kind="eval", weights=weights, batch=val, rows=6),
        "sweep": dict(kind="sweep", weights=weights, args=sweep_args),
        "pipe": dict(kind="pipe", args=sweep_args, micro=0,
                     indices=[3, 1, 6, 0, 7, 2, 8, 5]),
        "pipe_micro": dict(kind="pipe", args=sweep_args, micro=4,
                           indices=[4, 2, 0, 8, 6, 1, 3]),
    }
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
                         str(r), "2", str(port), str(tmp / "out.pkl")],
              tmp / "ranks.log")
    with open(tmp / "out.pkl", "rb") as f:
        ranks = pickle.load(f)
    return dict(spec=spec, single=single, ranks=ranks, params=params,
                stats=stats)


def jax_sharded_step(params, stats, batch, bn_groups, monkeypatch):
    """JAX's sparse loss and gradients with the batch sharded over a
    2-device mesh, the weights replicated; dropout off."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    model = JaxDeepLab(n_classes=N_CLASSES, width_mult=worker.WIDTH,
                       bn_groups=bn_groups)
    loss_fn = jax_trainer._sparse_loss_fn(
        model, n_classes=N_CLASSES, mean=worker.MEAN, std=worker.STD,
        normalize=True, gather_impl="matmul")
    devs = Mesh(np.array(jax.devices()[:2]), ("data",))
    rep = NamedSharding(devs, P())
    (loss, (new_stats, hist)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        jax.device_put(jax.tree.map(jnp.asarray, params), rep),
        jax.device_put(jax.tree.map(jnp.asarray, stats), rep),
        {k: jax.device_put(jnp.asarray(v), NamedSharding(devs, P("data")))
         for k, v in batch.items()}, jax.random.PRNGKey(0))
    return float(loss), np.asarray(hist), state_dict_from_jax(
        jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new_stats))


def assert_grads_close(got: dict, ref: dict, what: str) -> None:
    gmax = max(float(ref[n].abs().max()) for n in got)
    for n, g in got.items():
        err = float((g.float() - ref[n].float()).abs().max())
        tol = 1e-4 * float(ref[n].abs().max()) + 1e-6 * gmax
        assert err <= tol, f"{what} grad {n}: {err} > {tol}"


def assert_state_close(got: dict, ref: dict, start: dict, what: str) -> None:
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(r), k
            continue
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-4 * max(float(r.abs().max()), 1.0)
        else:
            tol = 1e-4 * float((r - start[k]).abs().max()) \
                + 1e-6 * float(r.abs().max())
        err = float((got[k].float() - r.float()).abs().max())
        assert err <= tol, f"{what} {k}: {err} > {tol}"


@pytest.mark.parametrize("name", ["bn0", "bn4", "rem", "drop", "s2d"])
def test_sharded_step_matches_single_process(setup, name):
    """Two ranks against one process on the same global batch: bn 0 (the
    BatchNorm spans the ranks), bn 4 (groups within a rank), a remainder
    of 7 padded to 8 with unequal valid counts per rank, dropout on (the
    global batch's masks), and ``--s2d_backbone`` (the phase-grouped
    BatchNorms of the s2d blocks, their padded counts and border terms,
    over a group that spans the ranks)."""
    got, ref = setup["ranks"][name], setup["single"][name]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]), name
    np.testing.assert_array_equal(got["hist"], ref["hist"])
    assert_grads_close(got["grads"], ref["grads"], name)
    assert_state_close(got["state"], ref["state"],
                       setup["spec"][name]["weights"], name)


@pytest.mark.parametrize("name", JAX_STEPS)
def test_sharded_step_matches_jax_mesh(setup, name, monkeypatch):
    """Two ranks against JAX's step on a 2-device mesh: the loss, every
    gradient, the running statistics and the confusion matrix."""
    sc = setup["spec"][name]
    loss_j, hist_j, grads_j = jax_sharded_step(
        setup["params"], setup["stats"], sc["batch"], sc["bn_groups"],
        monkeypatch)
    got = setup["ranks"][name]
    assert abs(got["loss"] - loss_j) <= 1e-5 * abs(loss_j), name
    np.testing.assert_array_equal(got["hist"], hist_j)
    assert_grads_close(got["grads"], {n: grads_j[n] for n in got["grads"]},
                       name)
    for k, r in grads_j.items():  # the running statistics after the step
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-4 * max(float(r.abs().max()), 1.0)
            err = float((got["state"][k] - r).abs().max())
            assert err <= tol, f"{name} {k}: {err} > {tol}"


def test_ghost_bn_group_spanning_ranks(setup):
    """Groups of 4 over 12 rows on two ranks of 6: groups 0 and 2 lie
    within a rank, group 1 spans both (its sums all-reduced, and so are
    their gradient terms). y, the three groups' moments and the gradients
    of x, the scale and the bias as one process computes them, within 1e-5
    of each one's largest |value| (inputs of unit variance: no
    cancellation)."""
    got, ref = setup["ranks"]["bn_span"], setup["single"]["bn_span"]
    assert got["mu"].shape == ref["mu"].shape == (3, 6)
    for k in ("y", "mu", "var", "dx", "dscale", "dbias"):
        err = float((got[k] - ref[k]).abs().max())
        assert err <= 1e-5 * float(ref[k].abs().max()), (k, err)


def test_microbatch_step_with_an_all_pad_micro_batch(setup):
    """A megabatch of 12 at micro 4 whose last micro-batch is all pad:
    every rank skips it (no update, NaN loss), and the two updates match
    the single process's."""
    got, ref = setup["ranks"]["micro"], setup["single"]["micro"]
    assert got["updates"] == ref["updates"] == 2
    assert np.isnan(got["losses"][2]) and np.isnan(ref["losses"][2])
    np.testing.assert_allclose(got["losses"][:2], ref["losses"][:2],
                               rtol=1e-5)
    np.testing.assert_array_equal(got["hist"], ref["hist"])
    assert_state_close(got["state"], ref["state"],
                       setup["spec"]["micro"]["weights"], "micro")


def test_validation_histogram_equal(setup):
    """A val batch of 5 padded to 6 with ignore-labelled rows over two
    ranks: the same confusion matrix as one process on the 5."""
    got, ref = setup["ranks"]["eval"], setup["single"]["eval"]
    assert ref["hist"].sum() > 0
    np.testing.assert_array_equal(got["hist"], ref["hist"])


def test_fixed_weight_sweep_picks_equal(setup):
    """The selector over 9 images in pool batches of 4, 4 and 1 (the last
    scored whole on each rank), top_n_percent's draws the global batch's:
    the same picks per image as one process, as sets."""
    ref_d = setup["single"]["sweep"]["picks"]
    got_d = setup["ranks"]["sweep"]["picks"]
    assert sorted(got_d) == sorted(ref_d) and len(ref_d) == 9
    got = codec.decode_queries(got_d)
    ref = codec.decode_queries(ref_d)
    for g, r in zip(got, ref):
        assert set(zip(*np.nonzero(g))) == set(zip(*np.nonzero(r)))
        assert r.sum() == 3


@pytest.mark.parametrize("name", ["pipe", "pipe_micro"])
def test_device_pipeline_rows(setup, name):
    """``--device_augment`` under two ranks: each draws for the whole batch
    and augments its rows (a batch of 8 split 4/4; a remainder of 7 padded
    to 8 at micro-batch 4, each micro-batch split 2/2). Gathered, they are
    one process's batch: the picks, row flags and overflow exactly, x
    within 1e-4 on the normalised scale."""
    got, ref = setup["ranks"][name], setup["single"][name]
    assert got["n_real"] == ref["n_real"]
    assert (got["shard"] is None) == (name == "pipe_micro")
    for k in ("coords", "labels", "valid", "rows_real"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["overflow"] == ref["overflow"] == 0
    assert got["valid"].sum() > 5
    np.testing.assert_allclose(got["x"], ref["x"], atol=1e-4, rtol=0)
    if name == "pipe_micro":  # rank 1's rows of each micro-batch
        assert list(got["rows"]) == [0, 1, 4, 5]


def test_campaign_writes_each_artifact_once(tmp_path):
    """``main_al --data_parallel 2 --device cpu``: the launcher starts two
    ranks; two rounds of one epoch leave every artifact once, each log
    with one row per epoch."""
    cfg = custom_camvid(tmp_path, n_train=8, n_val=3)
    run = tmp_path / "run"
    argv = [sys.executable, "-m", "pixelpick_tpu_torch.cli.main_al",
            "--device", "cpu", "-pdc", str(cfg), "--dir_checkpoints",
            str(run), "--width_multiplier", "0.5", "--n_pixels_by_us", "3",
            "--max_budget", "6", "--top_n_percent", "0", "-qs",
            "margin_sampling", "--n_workers", "1", "--pool_batch_size", "4",
            "--data_parallel", "2"]
    log = run_ranks(lambda r: argv, tmp_path / "campaign.log", world=1)
    files = sorted(str(p.relative_to(run)) for p in run.rglob("*")
                   if p.is_file())
    stage = ["1_train.png", "1_val.png", "best_miou_model.ckpt",
             "log_train.txt", "log_val.txt", "queries.pkl",
             "query_stats.pkl", "timing.json"]
    assert files == sorted(["args.txt", "2_query/queries.pkl",
                            *(f"{r}_query/{f}" for r in (0, 1)
                              for f in stage)]), files
    for r in (0, 1):
        for f in ("log_train.txt", "log_val.txt"):
            rows = (run / f"{r}_query" / f).read_text().split()
            assert len(rows) == 2, (f, rows)  # the header and epoch 1
    # both ranks ran the rounds: each prints its epochs
    assert log.count("Epoch 1 | mIoU") == 4, log[-3000:]


def test_failed_rank_fails_the_launcher(tmp_path):
    """A rank that fails makes ``--data_parallel`` exit non-zero."""
    out = subprocess.run(
        [sys.executable, "-m", "pixelpick_tpu_torch.cli.main_al", "--device",
         "cpu", "--data_parallel", "2", "--dataset_name", "cv",
         "--dir_dataset", str(tmp_path / "missing"), "--dir_checkpoints",
         str(tmp_path / "run")], cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode != 0
    assert "FileNotFoundError" in out.stderr, out.stderr[-3000:]


def test_refusals(monkeypatch):
    """--fused_ir with more than one rank (the JAX package's rule) and a
    --data_parallel other than the world size under a coordinator."""
    from pixelpick_tpu_torch.models import factory

    args = config.default_args(device="cpu", fused_ir=True,
                               width_multiplier=0.5)
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="single-device"):
        factory.get_model(args, "cpu")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="must use all 2 processes"):
        distributed.initialize_from_args(config.build_parser().parse_args(
            ["--device", "cpu", "--dist_coordinator", "localhost:1",
             "--dist_num_processes", "2", "--data_parallel", "3"]))
