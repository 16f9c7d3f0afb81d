"""The PyTorch package, and chip_smoke.py, import nothing of JAX and nothing
of the JAX package, and none of the libraries the JAX package reads and
writes checkpoints with (orbax, tensorstore, zstandard, msgpack): the card's
machine has none of them. Checked in a fresh interpreter, because this test
process has jax loaded already (tests/conftest.py)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import pixelpick_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    pixelpick_tpu_torch.__path__, "pixelpick_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "tensorstore", "zstandard",
                                    "msgpack", "pixelpick_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20, out.stdout
    assert bad.strip() == "[]", bad
