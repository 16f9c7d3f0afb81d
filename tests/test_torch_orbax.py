"""Orbax best-model checkpoints between the JAX package and the port
(``pixelpick_tpu_torch/engine/orbax.py``, ``engine/checkpoint.py``).

- JAX ``save_checkpoint(backend="orbax")`` of the variables of a small
  DeepLab (width 0.5) and a small FPN (ResNet-18, width 0.25), orbax's
  default layout (OCDBT, zstd): the port's ``load_checkpoint`` gives the ``state_dict`` that
  ``state_dict_from_jax`` gives of the same trees, and the one the JAX
  msgpack file of them gives, bit for bit, and the same logits, exactly.
- Of three JAX saves the newest step loads; a legacy bare root and a
  ``use_ocdbt=False`` step load too; an uncommitted tmp step is ignored.
- The port's ``--ckpt_backend orbax`` writer: JAX's ``load_checkpoint``
  reads its directories, arrays bit-equal, and three saves leave the step
  directories JAX's three saves leave.
- ``main_al --ckpt_backend orbax --stage_ckpt_interval 1`` on a small
  synthetic CamVid: each stage's best model is such a directory and
  nothing else, which JAX's ``load_checkpoint`` and the port's reader
  read to the same arrays.
- The committed fixture (``tests/torch_fixtures/jax_orbax/``, written by
  ``scripts/torch_make_orbax_fixture.py``): every leaf's sha256 matches
  ``hashes.json`` through the port's decoding and through tensorstore's.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from pixelpick_tpu.engine import checkpoint as jax_checkpoint
from pixelpick_tpu_torch.engine import checkpoint, orbax
from pixelpick_tpu_torch.models.convert import (
    jax_tree_from_state_dict, state_dict_from_jax,
)
from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.models.factory import init_model
from pixelpick_tpu_torch.models.fpn import FPNSeg
from torch_helpers import randomise_bn
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

HW = (48, 64)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_fixtures", "jax_orbax")
MODELS = {
    "deeplab": lambda: DeepLab(11, width_mult=0.5),
    "fpn": lambda: FPNSeg(5, 18, 0.25),
}


def _variables(build, seed):
    """A JAX tree of every leaf of the model (the weight bridge's layout,
    which tests/test_torch_model.py and test_torch_fpn.py hold to JAX's
    ``init``), with random BatchNorm and GroupNorm parameters and
    statistics."""
    params, stats, _ = jax_tree_from_state_dict(
        init_model(build(), seed).state_dict())
    rng = np.random.default_rng(seed)
    return randomise_bn(params, rng), randomise_bn(stats, rng)


def _same_state(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", list(MODELS))
def test_jax_orbax_best_model_loads_bit_equal(tmp_path, kind):
    build = MODELS[kind]
    params, stats = _variables(build, seed=4)
    path = str(tmp_path / "best_miou_model.ckpt")
    jax_checkpoint.save_checkpoint(path, params, stats, backend="orbax")
    jax_checkpoint.wait_for_checkpoints()
    step = os.path.join(path + ".orbax", "step_00000000")
    assert os.path.isfile(os.path.join(step, "manifest.ocdbt"))
    via_msgpack = str(tmp_path / "msgpack.ckpt")
    jax_checkpoint.save_checkpoint(via_msgpack, params, stats)

    from_orbax = checkpoint.load_checkpoint(path, build()).eval()
    from_msgpack = checkpoint.load_checkpoint(via_msgpack, build()).eval()
    in_memory = build().eval()
    in_memory.load_state_dict(state_dict_from_jax(params, stats))
    _same_state(from_orbax.state_dict(), in_memory.state_dict())
    _same_state(from_msgpack.state_dict(), in_memory.state_dict())

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, *HW, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(from_orbax(x, upsample=False)["pred"],
                           in_memory(x, upsample=False)["pred"])


def _tree(seed):
    rng = np.random.default_rng(seed)
    return ({"layer": {"kernel": rng.standard_normal((3, 3, 4, 8))
                       .astype(np.float32)},
             "head": {"bias": rng.standard_normal(8).astype(np.float32)}},
            {"bn": {"mean": rng.standard_normal(8).astype(np.float32),
                    "var": rng.uniform(0.5, 2, 8).astype(np.float32)}})


def _equal_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_newest_step_legacy_root_and_plain_layout(tmp_path):
    import orbax.checkpoint as ocp

    path = str(tmp_path / "best.ckpt")
    for seed in (1, 2, 3):
        jax_checkpoint.save_checkpoint(path, *_tree(seed), backend="orbax")
    jax_checkpoint.wait_for_checkpoints()
    root = path + ".orbax"
    # an uncommitted save beside them is never read
    os.makedirs(os.path.join(root, "step_00000009.orbax-checkpoint-tmp-1"))
    assert orbax.committed_steps(root) == [1, 2]
    got = orbax.read_latest(root)
    _equal_trees(got, dict(zip(("params", "batch_stats"), _tree(3))))
    with pytest.raises(orbax.OrbaxError, match="tmp"):
        orbax.read_step(os.path.join(root,
                                     "step_00000009.orbax-checkpoint-tmp-1"))

    for name, handler, sub in (
            ("legacy", ocp.StandardCheckpointHandler(), ""),
            ("plain", ocp.StandardCheckpointHandler(use_ocdbt=False),
             "step_00000004")):
        p = str(tmp_path / f"{name}.ckpt")
        tree = dict(zip(("params", "batch_stats"), _tree(7)))
        with ocp.Checkpointer(handler) as ckptr:
            ckptr.save(os.path.join(p + ".orbax", sub) if sub
                       else p + ".orbax", args=ocp.args.StandardSave(tree))
        with open(os.path.join(p + ".orbax", sub, "_METADATA")) as f:
            assert json.load(f)["use_ocdbt"] == (name == "legacy")
        _equal_trees(orbax.read_latest(p + ".orbax"), tree)


def test_port_writer_is_read_by_jax(tmp_path):
    models = [init_model(DeepLab(11, width_mult=0.5), s) for s in (5, 6, 7)]
    port_path = str(tmp_path / "port" / "best_miou_model.ckpt")
    jax_path = str(tmp_path / "jax" / "best_miou_model.ckpt")
    for m in models:
        params, stats, _ = jax_tree_from_state_dict(m.state_dict())
        checkpoint.save_checkpoint(port_path, m, backend="orbax")
        jax_checkpoint.save_checkpoint(jax_path, params, stats,
                                       backend="orbax")
    checkpoint.wait_for_checkpoints()
    jax_checkpoint.wait_for_checkpoints()
    assert sorted(os.listdir(port_path + ".orbax")) \
        == sorted(os.listdir(jax_path + ".orbax")) \
        == ["step_00000001", "step_00000002"]
    step = os.path.join(port_path + ".orbax", "step_00000002")
    with open(os.path.join(step, "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is False

    params, stats, _ = jax_tree_from_state_dict(models[-1].state_dict())
    template = jax_tree_from_state_dict(models[0].state_dict())[:2]
    got_p, got_s = jax_checkpoint.load_checkpoint(port_path, *template)
    _equal_trees({"params": got_p, "batch_stats": got_s},
                 {"params": params, "batch_stats": stats})
    # and the port reads its own directory back into the same weights
    back = checkpoint.load_checkpoint(port_path, DeepLab(11,
                                                         width_mult=0.5))
    _same_state(back.state_dict(), models[-1].state_dict())


def test_fixture_hashes_match_port_and_tensorstore():
    import tensorstore as ts

    with open(os.path.join(FIXTURE, "hashes.json")) as f:
        want = json.load(f)
    root = os.path.join(FIXTURE, "best_miou_model.ckpt.orbax")
    step = orbax.latest_step_dir(root)
    tree = orbax.read_latest(root)
    for name, h in want.items():
        node = tree
        for k in name.split("/"):
            node = node[k]
        ref = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{step}",
            "path": name.replace("/", ".") + "/"}}).result().read().result()
        for a in (node, np.asarray(ref)):
            assert a.dtype.str == h["dtype"] and list(a.shape) == h["shape"]
            assert hashlib.sha256(np.ascontiguousarray(a).tobytes()) \
                .hexdigest() == h["sha256"], name


def test_main_al_round_writes_orbax(tmp_path, few_torch_threads):
    from pixelpick_tpu_torch.active.driver import ALModel
    from pixelpick_tpu_torch.config import default_args
    from torch_helpers import custom_camvid

    args = default_args(
        p_dataset_config=str(custom_camvid(tmp_path)), device="cpu",
        dir_checkpoints=str(tmp_path / "run"), width_multiplier=0.5,
        n_pixels_by_us=4, max_budget=4, n_workers=2, seed=0, n_epochs=2,
        ckpt_backend="orbax", stage_ckpt_interval=1, pool_batch_size=4)
    al = ALModel(args)
    al()
    al.close()
    stage = tmp_path / "run" / "0_query"
    root = str(stage / "best_miou_model.ckpt.orbax")
    steps = orbax.committed_steps(root)
    assert 1 <= len(steps) <= 2 and steps[-1] == len(steps) - 1
    assert sorted(os.listdir(root)) == [f"step_{s:08d}" for s in steps]
    assert not (stage / "best_miou_model.ckpt").exists()
    assert not (stage / "stage_state.ckpt").exists()
    assert (tmp_path / "run" / "1_query" / "queries.pkl").is_file()
    ours = orbax.read_latest(root)
    template = jax_tree_from_state_dict(
        DeepLab(11, width_mult=0.5).state_dict())[:2]
    got_p, got_s = jax_checkpoint.load_checkpoint(
        str(stage / "best_miou_model.ckpt"), *template)
    _equal_trees({"params": got_p, "batch_stats": got_s}, ours)
