"""Write tests/torch_fixtures/jax_orbax/: a JAX orbax best-model checkpoint
(orbax's default layout: OCDBT, zstd) and ``hashes.json``, each leaf's
dtype, shape and the sha256 of its C-order bytes.

The port's orbax reader is held to it on the CPU (tests/test_torch_orbax.py,
against tensorstore too) and on the card (``chip_smoke.py`` phase 22), where
neither orbax nor tensorstore is installed. The leaves: seeded normals of
several shapes, one written in 4 chunks, constants, and ``arange``-like
patterns that zstd codes as sequences. Needs JAX and orbax::

    JAX_PLATFORMS=cpu python scripts/torch_make_orbax_fixture.py
"""

import hashlib
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "torch_fixtures", "jax_orbax")
CKPT = "best_miou_model.ckpt"


def fixture_tree():
    rng = np.random.default_rng(13)
    return {
        "params": {
            "stem": {"kernel": rng.standard_normal((3, 3, 3, 16))
                     .astype(np.float32)},
            "block": {"kernel": rng.standard_normal((1, 1, 64, 96))
                      .astype(np.float32) * 0.05,
                      "bias": np.full(96, 0.25, np.float32)},
            "ramp": {"kernel": (np.arange(24 * 256, dtype=np.float32)
                                .reshape(24, 256) * 0.5)},
            "tiled": {"kernel": np.tile(rng.standard_normal(64).astype(
                np.float32), 64).reshape(64, 64)},
            "chunked": {"kernel": rng.standard_normal((64, 48))
                        .astype(np.float32)},
        },
        "batch_stats": {
            "bn": {"mean": np.zeros(96, np.float32),
                   "var": np.ones(96, np.float32)},
            "steps": {"mean": np.repeat(np.arange(16, dtype=np.float32),
                                        40)},
        },
    }


def leaf_hashes(tree, prefix=()):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaf_hashes(v, prefix + (k,)))
        else:
            a = np.ascontiguousarray(v)
            out["/".join(prefix + (k,))] = {
                "dtype": a.dtype.str, "shape": list(a.shape),
                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import orbax.checkpoint as ocp

    tree = fixture_tree()
    save_args = jax.tree.map(lambda _: ocp.SaveArgs(), tree)
    # chunks of at most 3 KiB: a leaf on a chunk grid
    save_args["params"]["chunked"]["kernel"] = ocp.SaveArgs(
        chunk_byte_size=3 * 1024)
    shutil.rmtree(OUT, ignore_errors=True)
    step = os.path.join(OUT, f"{CKPT}.orbax", "step_00000000")
    with ocp.Checkpointer(ocp.StandardCheckpointHandler()) as ckptr:
        ckptr.save(step, args=ocp.args.StandardSave(tree,
                                                    save_args=save_args))
    with open(os.path.join(OUT, "hashes.json"), "w") as f:
        json.dump(leaf_hashes(tree), f, indent=1, sort_keys=True)
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, ns in os.walk(OUT) for n in ns)
    print(f"wrote {OUT} ({size} bytes)")
    if size > 200 * 1024:
        sys.exit(f"the fixture is {size} bytes, over 200 KiB")


if __name__ == "__main__":
    main()
