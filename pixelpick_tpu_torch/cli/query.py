"""Standalone query selection from a trained checkpoint — reference
``query.py:354-437`` ``__main__``, counterpart of
``pixelpick_tpu/cli/query.py``: merge all previous rounds' query files,
restrict the pool dataset to the annotated images, score it in human-labels
mode, and dump ``{nth}_query/queries.pkl`` for the annotation tools.

    python -m pixelpick_tpu_torch.cli.query --p_state_dict MODEL.ckpt \\
        --dir_checkpoints RUN_DIR [--device cuda|cpu] [--pallas_dw] ...

The checkpoint is the reference's torch format ``{"model": state_dict}``
or a JAX package msgpack file (``engine/checkpoint.py:load_checkpoint``).
A variable-size pool (VOC) is swept in shape buckets
(``data/loader.py``), mixed shapes in one sweep, as the JAX CLI does.
"""

from __future__ import annotations

import os
import pickle as pkl

from pixelpick_tpu_torch.active.codec import (
    gather_previous_query_files, merge_previous_query_files,
)
from pixelpick_tpu_torch.active.selector import QuerySelector
from pixelpick_tpu_torch.config import Arguments
from pixelpick_tpu_torch.data.factory import get_dataset
from pixelpick_tpu_torch.data.loader import Loader
from pixelpick_tpu_torch.engine.checkpoint import load_checkpoint
from pixelpick_tpu_torch.models.factory import get_model, resolve_device


def main(argv=None) -> str:
    """Run one standalone query round; returns the path it wrote."""
    args = Arguments().parse_args(argv)
    if not args.p_state_dict:
        raise SystemExit("--p_state_dict is required for standalone querying")
    device = resolve_device(args.device)
    model = load_checkpoint(args.p_state_dict, get_model(args, device))
    print(f"pretrained model loaded from {args.p_state_dict}")
    dataset = get_dataset(args, val=False, query=True,
                          generate_init_queries=False)

    prev_files = gather_previous_query_files(args.dir_checkpoints)
    merged = merge_previous_query_files(prev_files, ignore_index=args.ignore_index)

    # restrict the pool to annotated images, paths rewritten to the dataset
    # dir (reference query.py:388-410)
    list_inputs, list_merged = [], []
    for p_img, m in sorted(merged.items()):
        p = f"{args.dir_dataset}/train/{os.path.basename(p_img)}"
        if not os.path.exists(p):
            raise FileNotFoundError(f"annotated image {p_img} not found as {p}")
        list_inputs.append(p)
        list_merged.append(m)
    dataset.list_inputs = list_inputs
    dataset.update_labelled_queries(list_merged)

    nth_query = len(prev_files)
    bucket = args.stride_total \
        if getattr(dataset, "variable_size", False) else None
    with Loader(dataset, args.pool_batch_size, mode="query",
                n_workers=args.n_workers, human_labels=True,
                bucket_stride=bucket, pad_label=args.ignore_index) as loader:
        dict_queries = QuerySelector(args, loader, model, device)(
            nth_query=nth_query, human_labels=True)

    d = f"{args.dir_checkpoints}/{nth_query}_query"
    os.makedirs(d, exist_ok=True)
    path = f"{d}/queries.pkl"
    with open(path, "wb") as f:
        pkl.dump(dict_queries, f)
    print(f"Queries are saved at {path}")
    return path


if __name__ == "__main__":
    main()
