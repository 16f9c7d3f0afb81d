"""Full active-learning loop with the ground-truth oracle — reference
``main_al.py``; counterpart of ``pixelpick_tpu/cli/main_al.py``.

The canonical CamVid run (``scripts/pixelpick-dl-cv.sh``) on the card, with
the hand-written kernels:

    python -m pixelpick_tpu_torch.cli.main_al --dataset_name cv \\
        --n_pixels_by_us 10 -qs margin_sampling --fused_ir --pallas_dw

``--device cpu`` runs it on the CPU with the kernels' plain versions.
``--data_parallel N`` runs N local ranks, one per card (N CPU processes
under ``--device cpu``); ``torchrun --nproc_per_node N -m
pixelpick_tpu_torch.cli.main_al --dist_coordinator auto ...`` does the same
through torchrun (``parallel/distributed.py``).
"""

from __future__ import annotations

from pixelpick_tpu_torch.active.driver import ALModel
from pixelpick_tpu_torch.parallel import distributed


def _run(args) -> ALModel:
    model = ALModel(args)
    try:
        model()
    finally:
        model.close()
    return model


def main(argv=None):
    """The driver after its rounds; None in a launcher that started the
    ranks of ``--data_parallel``."""
    return distributed.run_entry("pixelpick_tpu_torch.cli.main_al", argv,
                                 _run)


if __name__ == "__main__":
    main()
