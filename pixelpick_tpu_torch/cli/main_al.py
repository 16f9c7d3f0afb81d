"""Full active-learning loop with the ground-truth oracle — reference
``main_al.py``; counterpart of ``pixelpick_tpu/cli/main_al.py``.

The canonical CamVid run (``scripts/pixelpick-dl-cv.sh``) on the card, with
the hand-written kernels:

    python -m pixelpick_tpu_torch.cli.main_al --dataset_name cv \\
        --n_pixels_by_us 10 -qs margin_sampling --fused_ir --pallas_dw

``--device cpu`` runs it on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

from pixelpick_tpu_torch.active.driver import ALModel
from pixelpick_tpu_torch.config import Arguments


def main(argv=None) -> ALModel:
    args = Arguments().parse_args(argv)
    model = ALModel(args)
    try:
        model()
    finally:
        model.close()
    return model


if __name__ == "__main__":
    main()
