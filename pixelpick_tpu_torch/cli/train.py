"""Single-stage training, on human labels where there are any — reference
``train.py:179-254``; counterpart of ``pixelpick_tpu/cli/train.py``.

It gathers every ``*/queries.pkl`` under ``--dir_checkpoints``, merges them
into one label map per image (``active/codec.py``), points the dataset at
those images under ``{dir_dataset}/train/`` and trains one stage,
``{len(files) - 1}_query``, on the merged human labels (no ground truth is
read). Without any query file it trains ``0_query`` on the seeded initial
picks, or ``fully_sup`` under ``--n_pixels_by_us 0``. Validation runs every
``--eval_interval`` epochs with a best-mIoU checkpoint; with
``--stage_ckpt_interval N`` an interrupted stage resumes on a rerun.

    python -m pixelpick_tpu_torch.cli.train -pdc CONFIG.yaml \\
        --dir_checkpoints RUN_DIR [--device cuda|cpu] [--fused_ir] \\
        [--pallas_dw] [--stage_ckpt_interval 1] [--data_parallel N]

``--data_parallel N`` trains on N local ranks, one per card
(``parallel/distributed.py``).
"""

from __future__ import annotations

import os

from pixelpick_tpu_torch.active.codec import (
    gather_previous_query_files, merge_previous_query_files,
)
from pixelpick_tpu_torch.active.driver import ALModel
from pixelpick_tpu_torch.parallel import distributed


def main(argv=None):
    """The driver after its stage; None in a launcher that started the
    ranks of ``--data_parallel`` (``parallel/distributed.py``)."""
    return distributed.run_entry("pixelpick_tpu_torch.cli.train", argv,
                                 _train)


def _train(args) -> ALModel:
    human = False
    inputs = maps = None
    prev_files = gather_previous_query_files(args.dir_checkpoints)
    if prev_files:
        merged = merge_previous_query_files(prev_files,
                                            ignore_index=args.ignore_index)
        inputs, maps = [], []
        for p_img, m in sorted(merged.items()):
            p = f"{args.dir_dataset}/train/{os.path.basename(p_img)}"
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"labelled image {p_img} not found as {p}")
            inputs.append(p)
            maps.append(m)
        human = True
        args.nth_query = len(prev_files) - 1

    model = ALModel(args, human_labels=human, human_inputs=inputs,
                    human_maps=maps)
    try:
        if human:
            model.nth_query = args.nth_query
            model._run_stage(f"{args.nth_query}_query")
        else:
            model.nth_query = 0
            model._run_stage("0_query" if args.n_pixels_by_us > 0
                             else "fully_sup")
    finally:
        model.close()
    return model


if __name__ == "__main__":
    main()
