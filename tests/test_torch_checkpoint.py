"""The port's checkpoint files (``pixelpick_tpu_torch/engine/checkpoint.py``
and its msgpack reader ``engine/flax_msgpack.py``) against the JAX
package's.

- The reader decodes what ``flax.serialization.msgpack_serialize`` writes
  to the same tree: every leaf's type, dtype, shape and bytes equal to
  ``flax.serialization.msgpack_restore``'s (exactly; no tolerance). Trees
  are drawn by hypothesis, plus one that reaches every length class (maps
  over 15 and 65,535 entries, strings over 31 bytes, arrays over 64 KiB).
- A file of ``pixelpick_tpu.engine.checkpoint.save_checkpoint`` loads in
  the port to the ``state_dict`` that ``state_dict_from_jax`` gives from
  the tree in memory, and the same logits, bit for bit on the CPU (width
  0.5, 48x64).
- A JAX orbax directory and a JAX ``stage_state.ckpt`` load (the two
  tests that held them refused now hold them loaded; tests/test_torch_
  orbax.py and test_torch_stage_resume.py test both against JAX in
  depth); the snapshot is still not taken for a best-model file.
- The port's stage snapshot gives back the model, the optimizer and the
  dropout generator exactly.
"""

import os

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from pixelpick_tpu.engine import checkpoint as jax_checkpoint
from pixelpick_tpu.engine.trainer import create_train_state
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.engine import checkpoint
from pixelpick_tpu_torch.engine.flax_msgpack import msgpack_restore
from pixelpick_tpu_torch.engine.optim import make_optimizer
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.models.factory import init_model
from torch_helpers import jax_deeplab_variables

N_CLASSES, WIDTH, HW = 11, 0.5, (48, 64)


def assert_same_tree(got, ref, path=()):
    """Equal structure, Python types, numpy dtypes, shapes and bytes."""
    assert type(got) is type(ref), (path, type(got), type(ref))
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            assert_same_tree(got[k], ref[k], path + (k,))
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert got.tobytes() == ref.tobytes(), path
    else:
        assert got == ref or (got != got and ref != ref), (path, got, ref)


def roundtrip(tree):
    data = flax.serialization.msgpack_serialize(tree)
    assert_same_tree(msgpack_restore(data),
                     flax.serialization.msgpack_restore(data))


DTYPES = ["float32", "float64", "float16", "int8", "int32", "int64",
          "uint8", "uint32", "bool"]


@st.composite
def arrays(draw):
    dtype = np.dtype(draw(st.sampled_from(DTYPES)))
    shape = tuple(draw(st.lists(st.integers(0, 5), max_size=3)))
    raw = draw(st.binary(min_size=dtype.itemsize * int(np.prod(shape)),
                         max_size=dtype.itemsize * int(np.prod(shape))))
    a = np.frombuffer(raw, dtype=np.uint8).view(dtype).reshape(shape)
    return a.astype(bool) if dtype == bool else a.copy()


leaves = st.one_of(
    arrays(),
    arrays().map(lambda a: a.reshape(-1)[0] if a.size else np.float32(0)),
    st.integers(-2 ** 63, 2 ** 64 - 1), st.floats(allow_nan=False),
    st.booleans(), st.none(), st.text(max_size=40))
trees = st.recursive(
    leaves, lambda inner: st.dictionaries(st.text(max_size=8), inner,
                                          max_size=20), max_leaves=30)


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text(max_size=8), trees, max_size=8))
def test_reader_matches_flax_on_drawn_trees(tree):
    roundtrip(tree)


def test_reader_matches_flax_at_every_length_class():
    rng = np.random.default_rng(0)
    tree = {
        "params": {"conv": {"kernel": rng.standard_normal(
            (3, 3, 64, 128)).astype(np.float32)},    # 288 KiB: bin32
            "bn": {"scale": np.ones(300, np.float32)}},  # 1.2 KiB: bin16
        "counts": rng.integers(-9, 9, (7,)).astype(np.int32),
        "mask": rng.random((4, 5)) < 0.5,
        "step": np.int32(7), "lr": np.float32(5e-4), "epoch": 3,
        "best_miou": 0.25, "empty": {},
        "wide": {f"k{i}": np.float32(i) for i in range(20)},       # map16
        "huge": {str(i): i for i in range(70_000)},                # map32
        "name_" + "x" * 40: "y" * 300,                  # str8, str16
        "long": "z" * 70_000,                           # str32
    }
    roundtrip(tree)


def test_reader_refuses_what_it_does_not_decode():
    bf16 = flax.serialization.msgpack_serialize(
        {"w": jnp.zeros(3, jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        msgpack_restore(bf16)
    with pytest.raises(ValueError, match="complex"):
        msgpack_restore(flax.serialization.msgpack_serialize({"c": 1 + 2j}))
    chunked = flax.serialization.msgpack_serialize(
        {"__msgpack_chunked_array__": True, "shape": {"0": 1}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack_restore(chunked)
    with pytest.raises(ValueError, match="0xc1"):
        msgpack_restore(b"\x81\xa1a\xc1")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(b"\x81\xa1a\xcd\x01")


@pytest.fixture(scope="module")
def jax_tree():
    return jax_deeplab_variables(N_CLASSES, WIDTH, HW, seed=3)


def port_model():
    return init_model(DeepLab(N_CLASSES, width_mult=WIDTH), 0).eval()


def test_jax_written_checkpoint_loads_bit_equal(tmp_path, jax_tree):
    params, stats = jax_tree
    path = str(tmp_path / "best_miou_model.ckpt")
    jax_checkpoint.save_checkpoint(path, params, stats)  # the msgpack default

    from_file = checkpoint.load_checkpoint(path, port_model())
    in_memory = port_model()
    in_memory.load_state_dict(state_dict_from_jax(params, stats))
    a, b = from_file.state_dict(), in_memory.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, *HW, 3)).astype(np.float32))
    with torch.no_grad():
        la = from_file(x, upsample=False)["pred"]
        lb = in_memory(x, upsample=False)["pred"]
    assert torch.equal(la, lb)

    # and the port's own files still load as before
    own = str(tmp_path / "own.ckpt")
    checkpoint.save_checkpoint(own, from_file)
    again = checkpoint.load_checkpoint(own, port_model()).state_dict()
    for k in a:
        assert torch.equal(again[k], a[k]), k


def test_orbax_directory_is_refused(tmp_path, jax_tree):
    """A JAX orbax directory was refused before the port could read one; it
    now loads, to the weights the msgpack file of the same trees gives."""
    params, stats = jax_tree
    path = str(tmp_path / "best_miou_model.ckpt")
    jax_checkpoint.save_checkpoint(path, params, stats, backend="orbax")
    jax_checkpoint.wait_for_checkpoints()
    assert os.path.isdir(path + ".orbax") and not os.path.exists(path)
    got = checkpoint.load_checkpoint(path, port_model()).state_dict()
    want = state_dict_from_jax(params, stats)
    assert list(got) == list(port_model().state_dict())
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_jax_stage_snapshot_is_refused(tmp_path, jax_tree):
    """A JAX ``stage_state.ckpt`` was refused before; it now loads into the
    model and the optimizer (tests/test_torch_stage_resume.py holds the
    moments and the next update to JAX's). It is still not taken for a
    best-model file."""
    from pixelpick_tpu.engine.optim import make_optimizer as jax_optimizer

    params, stats = jax_tree
    args = default_args(device="cpu")
    state = create_train_state(params, stats,
                               jax_optimizer(args, params, 10))
    path = str(tmp_path / "stage_state.ckpt")
    jax_checkpoint.save_stage_state(path, state, 2, 0.5)
    model = port_model()
    opt = make_optimizer(args, model, 10)
    gen = torch.Generator().manual_seed(0)
    assert checkpoint.load_stage_state(path, model, opt, gen, seed=1) \
        == (2, 0.5)
    want = state_dict_from_jax(params, stats)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert opt.step_count == 0
    for st in opt.state:
        assert all(not t.any() for ts in st.values() for t in ts)
    with pytest.raises(ValueError, match="seed"):
        checkpoint.load_stage_state(path, model, opt, gen)
    # nor is it taken for a best-model file
    with pytest.raises(ValueError, match="params"):
        checkpoint.load_checkpoint(path, model)


def _trained(seed):
    """A small model, its Adam and a generator, a few updates in."""
    model = init_model(DeepLab(N_CLASSES, width_mult=WIDTH), seed)
    gen = torch.Generator().manual_seed(seed)
    model.set_dropout_generator(gen)
    opt = make_optimizer(default_args(device="cpu"), model, 10)
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    model.train()
    for _ in range(2):
        opt.zero_grad()
        model(x, upsample=False)["pred"].square().mean().backward()
        opt.step()
    return model, opt, gen


def test_stage_snapshot_roundtrip(tmp_path):
    model, opt, gen = _trained(1)
    path = str(tmp_path / "0_query" / "stage_state.ckpt")
    checkpoint.save_stage_state(path, model, opt, gen, 2, 0.375)
    assert not os.path.exists(path + ".tmp")

    model2, opt2, gen2 = _trained(2)  # other weights, moments, stream
    epoch, best = checkpoint.load_stage_state(path, model2, opt2, gen2)
    assert (epoch, best) == (2, 0.375)
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k
    assert opt2.step_count == opt.step_count == 2
    for sa, sb in zip(opt.state, opt2.state):
        assert list(sa) == list(sb) == ["mu", "nu"]
        for k in sa:
            for a, b in zip(sa[k], sb[k]):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert torch.equal(gen.get_state(), gen2.get_state())
    assert torch.equal(torch.rand(5, generator=gen),
                       torch.rand(5, generator=gen2))
