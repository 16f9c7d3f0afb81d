"""Standalone validation — reference ``eval.py:14-134``; counterpart of
``pixelpick_tpu/cli/eval.py``: build the val set, load a checkpoint, run one
evaluation pass, print the scores and the per-class IoU, and write
``{dir_checkpoints}/val/log_val.txt`` and a 6-panel PNG every
``--visualize_interval`` images.

    python -m pixelpick_tpu_torch.cli.eval -pdc CONFIG.yaml \\
        --p_state_dict MODEL.ckpt --dir_checkpoints RUN_DIR \\
        [--device cuda|cpu] [--pallas_dw] [--val_batch_size 8]

``--p_state_dict`` takes the port's (the reference's) torch files and the
JAX package's msgpack files (``engine/checkpoint.py``). The PNGs come from
the eval step's own maps, which it computes for one image per batch: an
interval below the batch size writes at most one PNG per batch, named by
the image's index in the val set (``eval.py:94-136``).

Variable-size val sets (VOC) run through the shape-bucketed loader
(``data/loader.py``); its pad labels carry the ignore index, which the
confusion matrix drops, and its fill rows (index -1) never advance the
PNG cadence. A VOC loader built without buckets is reflect-padded to a
stride multiple per batch and its logits cropped back
(``active/driver.py:pad_to_stride``; ``eval.py:55-127``).

``--data_parallel N`` evaluates on N local ranks (``parallel/
distributed.py``): the batch rounds up to a multiple of N, a remainder
pads to the full batch with ignore-labelled rows and each rank takes its
rows; the confusion matrix is summed over the ranks, and the primary
writes the PNGs and the log (JAX ``cli/eval.py:58-81, 156``).
"""

from __future__ import annotations

import os

from pixelpick_tpu_torch.active.driver import pad_to_stride
from pixelpick_tpu_torch.data.factory import get_dataset
from pixelpick_tpu_torch.data.loader import Loader
from pixelpick_tpu_torch.engine.checkpoint import load_checkpoint
from pixelpick_tpu_torch.engine.trainer import batch_to_device, make_eval_step
from pixelpick_tpu_torch.models.factory import get_model, resolve_device
from pixelpick_tpu_torch.parallel import distributed, mesh
from pixelpick_tpu_torch.parallel.mesh import pad_batch_to_devices
from pixelpick_tpu_torch.utils.logging import write_log
from pixelpick_tpu_torch.utils.metrics import RunningScore
from pixelpick_tpu_torch.utils.visualiser import Visualiser, render_vis_panels


def evaluate(args, model, loader=None, debug: bool = False,
             dir_vis: str = None, visualize_interval: int = 100):
    """One pass of the eval step over the val set; returns
    ``(scores, cls_iu)``."""
    own_loader = loader is None
    world = distributed.world_size()
    if own_loader:
        dataset = get_dataset(args, val=True)
        loader = Loader(dataset,
                        -(-getattr(args, "val_batch_size", 1) // world)
                        * world,
                        mode="val", n_workers=args.n_workers,
                        bucket_stride=args.stride_total
                        if getattr(dataset, "variable_size", False) else None,
                        pad_label=args.ignore_index)
    device = next(model.parameters()).device
    eval_fn = make_eval_step(model, n_classes=args.n_classes, mean=args.mean,
                             std=args.std)
    if dir_vis:
        os.makedirs(dir_vis, exist_ok=True)
        if visualize_interval < loader.batch_size:
            print(f"WARNING: visualize_interval={visualize_interval} < "
                  f"batch_size={loader.batch_size}: at most one PNG per "
                  f"batch will be written (see PARITY.md, batched-eval "
                  f"PNG cadence)")
    vis = Visualiser(args.dataset_name)
    score = RunningScore(args.n_classes)
    n_img = 0
    try:
        for batch in loader:
            # a bucket's fill rows (index -1) come after its real images
            n_real = int((batch["index"] >= 0).sum()) if "index" in batch \
                else batch["x"].shape[0]
            # the first image of the batch on the cadence, if any
            off = (-n_img) % visualize_interval
            hit = dir_vis is not None and off < n_real
            feed = {k: v for k, v in batch.items() if k not in ("index", "hw")}
            valid_hw = None
            if getattr(loader, "bucket_stride", None) is None \
                    and args.dataset_name == "voc":
                feed, valid_hw = pad_to_stride(feed, args.stride_total)
            if world > 1:  # a remainder pads to the full batch and shards
                feed, _ = pad_batch_to_devices(
                    feed, pad_label=args.ignore_index,
                    target_rows=loader.batch_size)
            shard = mesh.row_shard(feed["x"].shape[0])
            lo, hi = (0, feed["x"].shape[0]) if shard is None \
                else shard[:2]
            own = lo <= off < hi  # this rank holds the cadence's image
            hist, _, maps = eval_fn(
                batch_to_device(mesh.shard_batch(feed, shard), device),
                vis_index=off - lo if hit and own else 0, valid_hw=valid_hw,
                shard=shard)
            score.merge(hist)
            if hit and shard is not None:  # its maps, to the primary
                maps = next(m for m in distributed.all_gather_object(
                    {k: v.cpu() for k, v in maps.items()} if own else None)
                    if m is not None)
            if hit and distributed.is_primary():
                render_vis_panels(vis, batch["x"][off], batch["y"][off], maps,
                                  f"{dir_vis}/{n_img + off}.png")
            n_img += n_real
            if debug:
                break
    finally:
        if own_loader:
            loader.close()
    return score.get_scores()


def main(argv=None):
    """Returns ``(scores, cls_iu)``; None in a launcher that started the
    ranks of ``--data_parallel``."""
    return distributed.run_entry("pixelpick_tpu_torch.cli.eval", argv,
                                 _main)


def _main(args):
    model = get_model(args, resolve_device(args.device))
    if args.p_state_dict:
        load_checkpoint(args.p_state_dict, model)
        print(f"checkpoint loaded from {args.p_state_dict}")
    dir_vis = f"{args.dir_checkpoints}/val"
    scores, cls_iu = evaluate(
        args, model, debug=args.debug, dir_vis=dir_vis,
        visualize_interval=getattr(args, "visualize_interval", 100))
    if distributed.is_primary():
        write_log(f"{dir_vis}/log_val.txt",
                  list_entities=[0, scores["Mean IoU"], scores["Pixel Acc"]],
                  header=["epoch", "miou", "pixel_acc"])
    print(scores)
    print("per-class IoU:", cls_iu)
    return scores, cls_iu


if __name__ == "__main__":
    main()
