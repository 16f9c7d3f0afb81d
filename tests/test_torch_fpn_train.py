"""One sparse and one dense train step of the port's ResNet-50 FPN
(engine/trainer.py: the sparse loss's full-resolution branch, which reads
the logits at the labelled pixels with no interpolation; the dense step)
against the JAX package's, under the VOC SGD table (engine/optim.py: wd
1e-4, the ``encoder.`` group at lr 1e-3, the decoder at 1e-2), on the CPU.

The FPN at width 0.25, 32x32, batch 2, at well-conditioned weights
(BatchNorm and GroupNorm scales in [0.3, 0.6] and biases in [2.5, 3.5],
conv kernels of zero mean over their inputs, so every ReLU input stays away
from 0). Tolerances: the loss within 1e-5 relative; the confusion matrix
exactly; each leaf's update and each running statistic's change within
2e-4 of the leaf's largest |value| plus 2e-6 of the largest over all
leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pixelpick_tpu.config import default_args as jax_default_args
from pixelpick_tpu.engine import trainer as jax_trainer
from pixelpick_tpu.engine.optim import make_optimizer as jax_make_optimizer
from pixelpick_tpu.models.fpn import FPNSeg as JaxFPNSeg
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.engine import optim, trainer
from pixelpick_tpu_torch.models import convert
from torch_helpers import jax_fpn_variables, port_fpn, well_conditioned
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

N_CLASSES, WIDTH = 5, 0.25
pytestmark = pytest.mark.usefixtures("few_torch_threads")

TRAIN_HW, TRAIN_BS, K = (32, 32), 2, 12


def _batch(dense: bool):
    rng = np.random.default_rng(7)
    x = np.clip(np.kron(rng.uniform(0, 255, (TRAIN_BS, 4, 4, 3)),
                        np.ones((1, 8, 8, 1)))
                + rng.normal(0, 20, (TRAIN_BS, *TRAIN_HW, 3)), 0, 255)
    batch = {"x": x.astype(np.uint8)}
    if dense:
        y = rng.integers(0, N_CLASSES, (TRAIN_BS, *TRAIN_HW))
        y[rng.random(y.shape) < 0.1] = 255
        batch["y"] = y.astype(np.int32)
    else:
        batch["coords"] = rng.integers(0, 32, (TRAIN_BS, K, 2)) \
            .astype(np.int32)
        batch["labels"] = rng.integers(0, N_CLASSES, (TRAIN_BS, K)) \
            .astype(np.int32)
        batch["valid"] = rng.random((TRAIN_BS, K)) < 0.8
    return batch


MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.mark.parametrize("dense", [False, True])
def test_fpn_train_step_matches_jax(dense):
    params, stats = jax_fpn_variables(N_CLASSES, 50, WIDTH)
    params = well_conditioned(params, np.random.default_rng(11))
    batch = _batch(dense)
    kw = dict(network_name="FPN", n_layers=50, width_multiplier=WIDTH,
              n_classes=N_CLASSES)
    jargs = jax_default_args("voc", **kw)
    tx = jax_make_optimizer(jargs, params, 10)
    jmodel = JaxFPNSeg(n_classes=N_CLASSES, n_layers=50,
                       width_multiplier=WIDTH)
    common = dict(n_classes=N_CLASSES, mean=MEAN, std=STD, donate=False)
    step = jax_trainer.make_dense_train_step(jmodel, tx, ignore_index=255,
                                             **common) if dense \
        else jax_trainer.make_train_step(jmodel, tx, **common)
    state = jax_trainer.create_train_state(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        tx)
    state, loss_j, hist_j = step(state, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0))
    new_j = convert.state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                                        jax.tree.map(np.asarray,
                                                     state.batch_stats))

    model = port_fpn(params, stats, N_CLASSES, 50, WIDTH)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    args = default_args("voc", device="cpu", **kw)
    opt = optim.make_optimizer(args, model, 10)
    tkw = dict(n_classes=N_CLASSES, mean=MEAN, std=STD)
    tstep = trainer.make_dense_train_step(model, opt, ignore_index=255,
                                          **tkw) if dense \
        else trainer.make_train_step(model, opt, **tkw)
    loss, hist = tstep(trainer.batch_to_device(batch, "cpu"))
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(hist_j))
    new = model.state_dict()
    deltas = {k: (new[k].float() - start[k].float(),
                  new_j[k] - start[k].float())
              for k in new if k in new_j and new[k].is_floating_point()}
    assert len(deltas) == sum(v.is_floating_point() for v in new_j.values())
    dmax = max(float(d_j.abs().max()) for _, d_j in deltas.values())
    for k, (d, d_j) in deltas.items():
        err = float((d - d_j).abs().max())
        tol = 2e-4 * float(d_j.abs().max()) + 2e-6 * dmax
        assert err <= tol, f"{k}: {err} > {tol}"
