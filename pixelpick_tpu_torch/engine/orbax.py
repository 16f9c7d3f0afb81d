"""Orbax step directories in and out, without orbax or tensorstore.

The JAX package's ``--ckpt_backend orbax`` saves each best model as
``<path>.orbax/step_{N:08d}/`` through orbax's ``StandardCheckpointHandler``
(``pixelpick_tpu/engine/checkpoint.py:68-101``): a ``{"params",
"batch_stats"}`` tree of arrays.

Reading (``read_step``, ``read_latest``):

- ``_METADATA`` (JSON) lists the tree's leaves (``tree_metadata``: each
  leaf's key path) and the layout: ``use_ocdbt``, ``use_zarr3`` (refused).
- Each leaf is a zarr v2 array named by its keys joined with dots
  (``params.backbone.stem.kernel``): ``<name>/.zarray`` (``dtype``,
  ``shape``, ``chunks``, ``order``, ``fill_value``, ``compressor`` zstd
  or null, ``dimension_separator``) and one key per chunk
  (``<name>/0.0.0.0``), C or F order, the edge chunks full-sized. A missing
  chunk is all fill value (orbax may skip one equal to it).
- With OCDBT (orbax's default) the keys live in the OCDBT database at the
  step directory (``engine/ocdbt.py``); without, as plain files.
- ``read_latest(root)`` picks the step as JAX does: the newest committed
  ``step_N``, or ``root`` itself when it holds no step (the legacy layout).
  A ``*.orbax-checkpoint-tmp*`` directory is never read.

Writing (``write_step``, ``save_async``): the plain layout
(``"use_ocdbt": false``), each leaf one zarr v2 chunk with compressor null,
and ``_METADATA`` and ``_CHECKPOINT_METADATA`` in orbax 0.11's JSON. A step
is written into a tmp directory and renamed into place. ``save_async``
numbers the steps on from the committed ones on disk, writes on a
background thread (one save in flight; the tree is copied to host memory
before it returns), and prunes the older steps at the next save, once the
newer one is durable, as JAX's ``save_checkpoint`` does.
``wait_for_checkpoints()`` blocks until the last save is on disk.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from pixelpick_tpu_torch.engine.ocdbt import OcdbtStore
from pixelpick_tpu_torch.engine.zstd import decompress_many

STEP_RE = re.compile(r"^step_(\d+)$")
TMP_MARK = ".orbax-checkpoint-tmp"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")


class OrbaxError(ValueError):
    pass


def committed_steps(root: str) -> List[int]:
    """Committed step numbers under an orbax root, ascending."""
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for m in map(STEP_RE.match,
                                                os.listdir(root))
                  if m and os.path.isdir(os.path.join(root, m.group(0))))


def latest_step_dir(root: str) -> str:
    steps = committed_steps(root)
    return os.path.join(root, f"step_{steps[-1]:08d}") if steps else root


# ------------------------------------------------------------------ read

def _leaf_paths(meta: dict) -> List[Tuple[str, ...]]:
    paths = []
    for name, entry in meta["tree_metadata"].items():
        keys = entry.get("key_metadata")
        if not keys:
            raise OrbaxError(f"leaf {name}: no key_metadata")
        vtype = entry.get("value_metadata", {}).get("value_type")
        if vtype not in ("np.ndarray", "jax.Array"):
            raise OrbaxError(f"leaf {name}: value type {vtype!r}; the port "
                             f"reads array leaves only")
        paths.append(tuple(str(k["key"]) for k in keys))
    return paths


def _fill(zarray: dict):
    fill = zarray.get("fill_value")
    if fill is None:
        return 0
    if isinstance(fill, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[fill]
    return fill


def _chunk_keys(zarray: dict) -> List[Tuple[Tuple[int, ...], str]]:
    shape, chunks = zarray["shape"], zarray["chunks"]
    sep = zarray.get("dimension_separator", ".")
    grid = [-(-s // c) if c else 0 for s, c in zip(shape, chunks)]
    if not shape:
        return [((), "0")]
    out = []
    for idx in np.ndindex(*grid):
        out.append((idx, sep.join(str(i) for i in idx)))
    return out


def _assemble(name: str, zarray: dict, chunks: Dict[Tuple[int, ...],
                                                    bytes]) -> np.ndarray:
    dtype = np.dtype(zarray["dtype"])
    shape, cshape = tuple(zarray["shape"]), tuple(zarray["chunks"])
    order = zarray.get("order", "C")
    out = np.full(shape, _fill(zarray), dtype)
    n_chunk = int(np.prod(cshape)) if cshape else 1
    for idx, data in chunks.items():
        if len(data) != n_chunk * dtype.itemsize:
            raise OrbaxError(f"{name}: chunk {idx} holds {len(data)} bytes, "
                             f"want {n_chunk * dtype.itemsize}")
        a = np.frombuffer(data, dtype).reshape(cshape, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, cshape, shape))
        out[sl] = a[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def read_step(step_dir: str) -> dict:
    """The nested dict of numpy arrays that JAX's ``StandardRestore``
    gives for the step directory ``step_dir``."""
    if TMP_MARK in os.path.basename(os.path.normpath(step_dir)):
        raise OrbaxError(f"{step_dir} is an uncommitted orbax tmp directory")
    with open(os.path.join(step_dir, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxError(f"{step_dir}: a zarr3 checkpoint; the port reads "
                         f"zarr v2 ones (orbax's default)")
    if meta.get("use_ocdbt", True):
        store = OcdbtStore(step_dir)
        keys = set(store.list())

        def get(key: str) -> Optional[bytes]:
            k = key.encode()
            return store.read(k) if k in keys else None
    else:
        def get(key: str) -> Optional[bytes]:
            p = os.path.join(step_dir, key)
            if not os.path.isfile(p):
                return None
            with open(p, "rb") as f:
                return f.read()

    leaves, pending = [], []
    for path in _leaf_paths(meta):
        name = ".".join(path)
        raw = get(f"{name}/.zarray")
        if raw is None:
            raise OrbaxError(f"{step_dir}: no {name}/.zarray")
        zarray = json.loads(raw)
        if zarray.get("zarr_format") != 2:
            raise OrbaxError(f"{name}: zarr_format "
                             f"{zarray.get('zarr_format')}")
        if zarray.get("filters"):
            raise OrbaxError(f"{name}: zarr filters {zarray['filters']}")
        comp = zarray.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise OrbaxError(f"{name}: compressor {comp}; the port reads "
                             f"zstd or none")
        chunks = {}
        for idx, key in _chunk_keys(zarray):
            data = get(f"{name}/{key}")
            if data is not None:
                chunks[idx] = data
                if comp is not None:
                    pending.append((chunks, idx, data))
        leaves.append((path, name, zarray, chunks))
    for (chunks, idx, _), data in zip(
            pending, decompress_many([p[2] for p in pending])):
        chunks[idx] = data
    tree: dict = {}
    for path, name, zarray, chunks in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _assemble(name, zarray, chunks)
    return tree


def read_latest(root: str) -> dict:
    """``read_step`` of the step JAX's ``load_checkpoint`` restores."""
    return read_step(latest_step_dir(root))


# ----------------------------------------------------------------- write

def _flatten(tree: dict, prefix=()) -> List[Tuple[Tuple[str, ...],
                                                  np.ndarray]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flatten(v, prefix + (k,))
        else:
            out.append((prefix + (k,), np.ascontiguousarray(v)))
    return out


def _zarray(a: np.ndarray) -> dict:
    return {"chunks": list(a.shape), "compressor": None,
            "dimension_separator": ".", "dtype": a.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(a.shape), "zarr_format": 2}


def write_step(step_dir: str, tree: dict) -> None:
    """Write ``tree`` (nested dicts of numpy arrays) as a committed orbax
    step: into a tmp directory beside ``step_dir``, then renamed."""
    init = time.time_ns()
    tmp = f"{step_dir}{TMP_MARK}-{init}"
    os.makedirs(tmp)
    meta = {}
    for path, a in _flatten(tree):
        name = ".".join(path)
        if any("." in k or "/" in k for k in path):
            raise OrbaxError(f"key {path}: '.' and '/' split orbax names")
        if not a.ndim or not a.size:
            raise OrbaxError(f"leaf {name}: shape {a.shape}; orbax saves "
                             f"arrays of one element or more")
        os.makedirs(os.path.join(tmp, name))
        with open(os.path.join(tmp, name, ".zarray"), "w") as f:
            json.dump(_zarray(a), f, separators=(",", ":"))
        with open(os.path.join(tmp, name, ".".join("0" for _ in a.shape)),
                  "wb") as f:
            f.write(a.tobytes())
        meta[str(path)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in path],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {},
                   "init_timestamp_nsecs": init,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    os.replace(tmp, step_dir)


class _Saver:
    """One background save at a time, numbered and pruned as JAX's
    ``save_checkpoint(backend="orbax")``."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.next_step: Dict[str, int] = {}

    def wait(self) -> None:
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise OrbaxError(f"a background orbax save failed: {err}") \
                from err

    def save(self, root: str, tree: dict) -> str:
        self.wait()  # the previous save is durable from here on
        root = os.path.abspath(root)
        if root not in self.next_step:
            steps = committed_steps(root)
            self.next_step[root] = steps[-1] + 1 if steps else 0
        for s in committed_steps(root)[:-1]:
            shutil.rmtree(os.path.join(root, f"step_{s:08d}"),
                          ignore_errors=True)
        step = self.next_step[root]
        self.next_step[root] = step + 1
        step_dir = os.path.join(root, f"step_{step:08d}")
        os.makedirs(root, exist_ok=True)

        def run():
            try:
                write_step(step_dir, tree)
            except Exception as e:  # re-raised by wait()
                self.error = e

        self.thread = threading.Thread(target=run, name="orbax-save",
                                       daemon=False)
        self.thread.start()
        return step_dir


_SAVER = _Saver()
atexit.register(_SAVER.wait)


def save_async(root: str, tree: dict) -> str:
    """Start writing ``tree`` as the next step under ``root``; returns the
    step directory it will commit."""
    return _SAVER.save(root, tree)


def wait_for_checkpoints() -> None:
    """Block until the last ``save_async`` is on disk (raises if it
    failed)."""
    _SAVER.wait()
