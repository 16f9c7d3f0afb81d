#!/usr/bin/env python3
"""How far apart the train-step gradients of the standard and the s2d
(``--s2d_backbone``) DeepLab lie, in JAX and in the port, on the CPU.

    python3 scripts/torch_s2d_grad_noise.py [--seeds 0 13]

Runs one sparse train step of the width-0.5 DeepLab at 48x64, batch 4, at
the well-conditioned weights of ``tests/test_torch_train_step.py``, for
each batch seed, through JAX's standard and s2d builds and the port's, and
prints, for each pair of builds, the worst leaf's gradient difference over
the tolerance ``rel * |leaf|max + floor * |gradient|max`` at floors 1e-6
and 1e-5. JAX's two builds compute the same function in other summation
orders, so their distance is the rounding noise a comparison of whole
networks must allow (``tests/test_torch_s2d.py``,
``tests/test_torch_conv3x3.py``). Needs the JAX package beside the port,
as the tests do.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import flax.linen  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pixelpick_tpu.engine import trainer as jax_trainer  # noqa: E402
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab  # noqa: E402
from pixelpick_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from test_torch_s2d import (  # noqa: E402
    HW, MEAN, N_CLASSES, STD, WIDTH, _step_grads, jax_variables,
    port_deeplab, sparse_batches, well_conditioned,
)


def jax_grads(params, stats, batch, s2d_until):
    loss_fn = jax_trainer._sparse_loss_fn(
        JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH,
                   s2d_until=s2d_until),
        n_classes=N_CLASSES, mean=MEAN, std=STD, normalize=True,
        gather_impl="matmul")
    _, grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    return state_dict_from_jax(jax.tree.map(np.asarray, grads), {})


def worst(got, ref, rel, floor):
    gmax = max(float(r.abs().max()) for r in ref.values())
    return max((float((got[n] - r).abs().max())
                / (rel * float(r.abs().max()) + floor * gmax), n)
               for n, r in ref.items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 13])
    opts = ap.parse_args(argv)
    # dropout off, as the tests run the step
    flax.linen.Dropout.__call__ = lambda self, x, *a, **k: x
    params, stats = jax_variables()
    params = well_conditioned(params, np.random.default_rng(102))
    for seed in opts.seeds:
        batch = sparse_batches(1, seed=seed)[0]
        g = {}
        for s2d in (0, 4):
            g[("jax", s2d)] = jax_grads(params, stats, batch, s2d)
            model = port_deeplab(params, stats, s2d_until=s2d).train()
            g[("port", s2d)] = _step_grads(model, batch)[1]
        for a, b in ((("jax", 4), ("jax", 0)), (("port", 4), ("jax", 4)),
                     (("port", 0), ("jax", 0)), (("port", 4), ("port", 0))):
            cells = [f"floor {f:g}: {worst(g[a], g[b], 1e-4, f)[0]:.3f}"
                     for f in (1e-6, 1e-5)]
            print(f"batch seed {seed}, {a} against {b}: worst leaf at "
                  f"{', '.join(cells)} of the tolerance "
                  f"({worst(g[a], g[b], 1e-4, 1e-6)[1]})")


if __name__ == "__main__":
    main()
