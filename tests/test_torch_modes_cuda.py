"""The round modes on a CUDA card, with the hand-written kernels
(``--fused_ir --pallas_dw``). Skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_modes_cuda.py

A megabatch of 3 micro-batches through ``make_microbatch_train_step``
against 3 sequential ``make_train_step`` calls on the same rows, at width
0.5 and 96x128, from chip_smoke.py's well-conditioned weights with dropout
off and SGD (chip_smoke.py phase 8 runs the same check at full width).
Tolerances are chip_smoke.py phase 6's leaf limits: each parameter within
2e-3 of its own largest move plus 1e-5 of the largest move of any
parameter, each running statistic within 2e-3 of its largest |value|, the
forward counts, the update count and the confusion matrices equal, the
losses within 1e-5 relative.
"""

import numpy as np
import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [12, 11])
def test_megabatch_equals_sequential_kernel_steps(rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from pixelpick_tpu_torch.config import default_args
    from pixelpick_tpu_torch.models import layers
    from pixelpick_tpu_torch.models.factory import get_model
    from pixelpick_tpu_torch.parallel.mesh import pad_batch_to_devices

    args = default_args(device="cuda", width_multiplier=0.5, fused_ir=True,
                        pallas_dw=True)
    try:
        model = get_model(args, "cuda", seed=11)
        cs.well_conditioned_(model, seed=12)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        del model
        batch = cs.train_batch(np.random.default_rng(3), rows, hw=(96, 128))
        # 11 rows: the last micro-batch holds 3 real rows and 1 pad row
        batch, n_real = pad_batch_to_devices(batch, pad_label=11,
                                             target_rows=12)
        assert n_real == rows
        out = cs.megabatch_vs_sequential(args, start, batch, 4)
    finally:
        layers.set_depthwise_impl("xla")
    assert out["updates"] == out["ref_updates"] == 3
    assert out["launches"]["fused_fwd"] == out["launches"]["fused_bwd"] \
        == 3 * 13
    assert out["launches"]["depthwise_kernel"] == 3
    assert out["launches"]["depthwise_kernel_dx"] == 3
    assert out["hist_equal"]
    assert out["loss_rel_err"] <= cs.STEP_LOSS_TOL
    assert out["worst"] <= 1, out
