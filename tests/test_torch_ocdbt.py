"""The port's read-only OCDBT store (``pixelpick_tpu_torch/engine/ocdbt.py``)
against tensorstore's ``KvStore`` on the same directories.

Stores written by tensorstore here: compression off and zstd on, one key
and 3000 keys (small nodes, so that the B+tree has interior levels), values
inline and indirect, several commits (a version-tree arity of 2, so that
older generations move into version-tree nodes), and the per-process and
root databases of a default orbax save. ``list()`` and ``read()`` must
equal tensorstore's, key by key and byte for byte. A flipped byte in a
node raises a CRC32C error naming the file.
"""

import os

import numpy as np
import pytest
import tensorstore as ts

from pixelpick_tpu_torch.engine.ocdbt import OcdbtError, OcdbtStore, crc32c


def _open(path, **config):
    spec = {"driver": "ocdbt", "base": f"file://{path}"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _fill(path, n_keys, seed, **config):
    rng = np.random.default_rng(seed)
    kv = _open(path, **config)
    txn = ts.Transaction()
    for i in range(n_keys):
        key = b"params.block_%04d/%d.0" % (rng.integers(0, 10 ** 4), i % 3)
        size = int(rng.choice([0, 3, 90, 200, 5000]))
        kv.with_transaction(txn).write(key, rng.bytes(size)).result()
    txn.commit_async().result()
    for i in range(5):  # more generations
        kv.write(b"extra/%d" % i, rng.bytes(150 * i)).result()


def _assert_same(path):
    kv = _open(path)
    keys = sorted(kv.list().result())
    store = OcdbtStore(path)
    assert store.list() == keys
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    return store


CASES = {
    "plain_1": dict(n_keys=1, compression=None),
    "zstd_1": dict(n_keys=1, compression={"id": "zstd", "level": 3}),
    "plain_3000": dict(n_keys=3000, compression=None,
                       max_decoded_node_bytes=4096),
    "zstd_3000": dict(n_keys=3000, compression={"id": "zstd", "level": 1},
                      max_decoded_node_bytes=4096),
    "versions": dict(n_keys=40, compression={"id": "zstd", "level": 1},
                     version_tree_arity_log2=1),
}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("ocdbt")
    out = {}
    for i, (name, case) in enumerate(CASES.items()):
        case = dict(case)
        path = str(root / name)
        _fill(path, case.pop("n_keys"), seed=i, **case)
        out[name] = path
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_list_and_read_match_tensorstore(stores, name):
    store = _assert_same(stores[name])
    comp = CASES[name]["compression"]
    assert store.config["compression"] == (comp and {"id": "zstd",
                                                     "level": comp["level"]})
    assert sorted(store.generations) == list(
        range(1, store.generation + 1)), store.generations
    if name == "versions":
        assert store.config["version_tree_arity_log2"] == 1
        assert len(store.generations) >= 6
    if name.endswith("3000"):
        assert store.height >= 1


def test_orbax_databases_match_tensorstore(tmp_path):
    import orbax.checkpoint as ocp

    rng = np.random.default_rng(5)
    tree = {"params": {f"conv{i}": {"kernel": rng.standard_normal(
        (3, 3, 8, 4 * i + 4)).astype(np.float32)} for i in range(30)},
        "batch_stats": {"bn": {"mean": np.zeros(16, np.float32)}}}
    step = str(tmp_path / "step_00000000")
    with ocp.Checkpointer(ocp.StandardCheckpointHandler()) as ckptr:
        ckptr.save(step, args=ocp.args.StandardSave(tree))
    subdirs = [d for d in os.listdir(step) if d.startswith("ocdbt.process_")]
    assert subdirs
    root = _assert_same(step)  # the root resolves into ocdbt.process_0/
    assert len(root.list()) == 2 * 31
    for d in subdirs:
        _assert_same(os.path.join(step, d))


def test_corrupt_node_raises(stores, tmp_path):
    import shutil

    path = str(tmp_path / "copy")
    shutil.copytree(stores["zstd_3000"], path)
    # flip a byte inside the newest version's root node (values carry no
    # CRC; older generations' nodes are not read)
    (rel, _), offset, length = OcdbtStore(path)._root_ref
    victim = os.path.join(path, rel)
    data = bytearray(open(victim, "rb").read())
    assert data[offset:offset + 4] == b"\x0c\xdb\x20\xde"
    data[offset + length // 2] ^= 0x40
    with open(victim, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(OcdbtError, match="CRC32C") as err:
        store = OcdbtStore(path)
        store.list()
    assert os.path.basename(victim) in str(err.value)

    manifest = os.path.join(path, "manifest.ocdbt")
    m = bytearray(open(manifest, "rb").read())
    m[-1] ^= 1
    open(manifest, "wb").write(bytes(m))
    with pytest.raises(OcdbtError, match="manifest.ocdbt.*CRC32C"):
        OcdbtStore(path)


def test_crc32c_matches_reference():
    import google_crc32c

    for data in (b"", b"a", os.urandom(1000)):
        assert crc32c(data) == google_crc32c.value(data)
