"""One rank of the port's data-parallel tests (tests/test_torch_distributed.py,
tests/test_torch_spatial.py).

    python tests/torch_dist_worker.py SPEC RANK WORLD PORT OUT

joins a gloo world of WORLD CPU processes on localhost:PORT, runs every
scenario of the pickled SPEC and, on rank 0, pickles the results to OUT.
The same scenario functions run in the test process at world size 1, as the
single-process reference. Imports torch and the port only (no JAX).
"""

import os
import pickle
import sys
from types import SimpleNamespace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pixelpick_tpu_torch.config import default_args  # noqa: E402
from pixelpick_tpu_torch.engine import optim, trainer  # noqa: E402
from pixelpick_tpu_torch.models import layers  # noqa: E402
from pixelpick_tpu_torch.models.deeplab import DeepLab  # noqa: E402
from pixelpick_tpu_torch.parallel import distributed, mesh  # noqa: E402

N_CLASSES, WIDTH = 11, 0.5
MEAN, STD = (0.41, 0.43, 0.44), (0.28, 0.29, 0.29)


def build_model(weights, bn_groups: int, dropout: bool, s2d: bool = False):
    """The width-0.5 DeepLab at ``weights`` (with ``s2d``, its first 4
    blocks in s2d layout, as ``--s2d_backbone`` builds it); with
    ``dropout`` its dropouts draw from a generator seeded 7, else they are
    off (p = 0)."""
    model = DeepLab(N_CLASSES, width_mult=WIDTH, bn_groups=bn_groups,
                    s2d_until=4 if s2d else 0)
    model.load_state_dict(weights)
    for m in model.modules():
        if isinstance(m, layers.Dropout) and not dropout:
            m.p = 0.0
    model.set_dropout_generator(torch.Generator().manual_seed(7))
    return model.to(memory_format=torch.channels_last)


def sgd(model):
    """The train-step tests' SGD (coupled weight decay 5e-4, momentum
    0.9), MultiStep schedule."""
    args = default_args(device="cpu")
    args.optimizer_type, args.lr_scheduler_type = "SGD", "MultiStepLR"
    args.optimizer_params = {"lr": 5e-4}
    return optim.make_optimizer(args, model, 5)


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_step(sc) -> dict:
    """One sparse step on the global host batch, this rank's rows; the
    loss, confusion matrix, every gradient (after the reduction) and the
    state after the update."""
    model = build_model(sc["weights"], sc["bn_groups"], sc["dropout"],
                        sc.get("s2d", False))
    step = trainer.make_train_step(model, sgd(model), n_classes=N_CLASSES,
                                   mean=MEAN, std=STD)
    batch = sc["batch"]
    shard = mesh.row_shard(batch["x"].shape[0])
    loss, hist = step(trainer.batch_to_device(mesh.shard_batch(batch, shard),
                                              "cpu"), shard)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in model.named_parameters()}
    return {"loss": float(loss), "hist": hist.numpy(), "grads": grads,
            "state": _state(model)}


def run_bn(sc) -> dict:
    """The train-mode ghost BatchNorm alone on this rank's rows of
    ``sc["x"]`` (B, C, H, W), groups of ``sc["groups"]``: y, the moments,
    and the gradients of sum(y * sc["w"]) for x (every row, gathered)
    and for the scale and bias (summed over the ranks)."""
    x = torch.from_numpy(sc["x"])
    shard = mesh.row_shard(x.shape[0])
    lo, hi = (0, x.shape[0]) if shard is None else shard[:2]
    xl = x[lo:hi].clone().requires_grad_()
    scale = torch.nn.Parameter(torch.from_numpy(sc["scale"]))
    bias = torch.nn.Parameter(torch.from_numpy(sc["bias"]))
    with mesh.sharded(shard):
        y, mu, var = layers.ghost_bn_train(xl, scale, bias, sc["groups"],
                                           1e-5, torch.float32)
    (y * torch.from_numpy(sc["w"])[lo:hi]).sum().backward()
    if shard is not None:
        mesh.all_reduce_grads([scale, bias])
    rows = distributed.all_gather_object((y.detach(), xl.grad))
    return {"y": torch.cat([r[0] for r in rows]),
            "dx": torch.cat([r[1] for r in rows]), "mu": mu.detach(),
            "var": var.detach(), "dscale": scale.grad, "dbias": bias.grad}


def run_micro(sc) -> dict:
    """The micro-batch step over a host megabatch (each micro-batch
    sharded on its own): the losses, the confusion matrix, the update
    count and the state after it."""
    model = build_model(sc["weights"], sc["bn_groups"], sc["dropout"])
    opt = sgd(model)
    step = trainer.make_microbatch_train_step(
        model, opt, micro_bs=sc["micro"], n_classes=N_CLASSES, mean=MEAN,
        std=STD)
    losses, hist = step(sc["batch"])
    return {"losses": losses.numpy(), "hist": hist.numpy(),
            "updates": opt.step_count, "state": _state(model)}


def run_eval(sc) -> dict:
    """The validation step as the driver runs it: under data parallelism
    the remainder pads to the full batch with ignore-labelled rows."""
    model = build_model(sc["weights"], 0, False).eval()
    eval_fn = trainer.make_eval_step(model, n_classes=N_CLASSES, mean=MEAN,
                                     std=STD)
    feed = sc["batch"]
    if distributed.world_size() > 1:
        feed, _ = mesh.pad_batch_to_devices(feed, pad_label=N_CLASSES,
                                            target_rows=sc["rows"])
    shard = mesh.row_shard(feed["x"].shape[0])
    hist, _, _ = eval_fn(trainer.batch_to_device(
        mesh.shard_batch(feed, shard), "cpu"), shard=shard)
    return {"hist": hist.numpy()}


def run_sweep(sc) -> dict:
    """A pool sweep of the query selector at fixed weights over a
    synthetic CamVid: the encoded picks."""
    from pixelpick_tpu_torch.active.selector import QuerySelector
    from pixelpick_tpu_torch.data.factory import get_dataset
    from pixelpick_tpu_torch.data.loader import Loader

    args = default_args(device="cpu", **sc["args"])
    ds = get_dataset(args, val=False, query=False)
    dq = get_dataset(args, val=False, query=True, generate_init_queries=False)
    dq.queries, dq.n_pixels_total = ds.queries, ds.n_pixels_total
    model = build_port({"weights": sc["weights"], "mc": args.use_mc_dropout,
                        "pallas": args.pallas_dw}) \
        if args.spatial_query_sharding else \
        build_model(sc["weights"], 0, True).eval()
    with Loader(dq, args.pool_batch_size, mode="query",
                n_workers=1) as loader:
        picks = QuerySelector(args, loader, model, "cpu")(0)
    return {"picks": picks,
            "stats": _sweep_stats(args) if distributed.is_primary() else None}


def _sweep_stats(args) -> dict:
    """The round's stats the primary wrote."""
    with open(f"{args.dir_checkpoints}/0_query/query_stats.pkl", "rb") as f:
        return pickle.load(f)


def _init_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter and BatchNorm statistic drawn from ``seed``: the
    same module on every rank and in the test process."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("running_var"):
                t.uniform_(0.5, 2.0, generator=g)
            elif t.is_floating_point():
                t.normal_(0.0, 0.3, generator=g)
    return module.eval()


def layer_op(name: str, size):
    """(input's stride level, its channels, NHWC?, the op, whether its
    output is whole rather than a stripe) of a per-layer case of
    tests/test_torch_spatial.py. ``size(s)`` is this process's (rows,
    columns) of the map at stride s. The modules are seeded, so every
    process builds the same."""
    from pixelpick_tpu_torch.models.aspp import _GlobalMean
    from pixelpick_tpu_torch.models.fpn import GroupNorm
    from pixelpick_tpu_torch.models.mobilenet_v2 import InvertedResidual
    from pixelpick_tpu_torch.models.resnet import max_pool_3x3_s2
    from pixelpick_tpu_torch.models.s2d_block import InvertedResidualS2D
    from pixelpick_tpu_torch.ops.depthwise import depthwise_conv3x3
    from pixelpick_tpu_torch.ops.resize import resize_bilinear
    from pixelpick_tpu_torch.ops.s2d import from_s2d, to_s2d

    conv = layers.Conv2d
    w = torch.randn((3, 3, 8), generator=torch.Generator().manual_seed(3))

    def dw_block(stride, dilation, cout, impl):
        layers.set_depthwise_impl(impl)
        try:
            return _init_(InvertedResidual(8, cout, stride, dilation, 6), 5)
        finally:
            layers.set_depthwise_impl("xla")

    def s2d_block(stride, cout):
        """An s2d block on a level-2 map: the s2d input made, the s2d
        output (stride 1) unmade. Its rim value rho must be nonzero in a
        channel, or the border map's rows could be any."""
        block = _init_(InvertedResidualS2D(8, cout, stride, 1, 6), 5)
        bn = block.conv[1]
        rho = layers.relu6(bn.bias - bn.running_mean * bn.weight
                           * torch.rsqrt(bn.running_var + bn.eps))
        assert (rho > 0).any(), "rho is 0 in every channel"

        def op(x):
            y = block.forward_s2d(to_s2d(x))
            return from_s2d(y) if stride == 1 else y
        return op

    def dropout(x):
        d = layers.Dropout(0.5)
        d.generator = torch.Generator().manual_seed(6)
        return d(x, active=True)

    ops = {
        "conv3x3": (1, 8, False, _init_(conv(8, 8, 3, padding=1), 1)),
        "conv3x3_dilated": (1, 8, False,
                            _init_(conv(8, 8, 3, padding=2, dilation=2), 1)),
        # the ASPP's rate at 1/16: stripes of 2-3 rows, a reach of 6
        "atrous_rate6": (16, 8, False,
                         _init_(conv(8, 8, 3, padding=6, dilation=6), 1)),
        "atrous_rate18": (16, 8, False,
                          _init_(conv(8, 8, 3, padding=18, dilation=18), 1)),
        "conv3x3_s2": (1, 8, False, _init_(conv(8, 8, 3, 2, padding=1), 1)),
        "stem7x7_s2": (1, 3, False, _init_(conv(3, 8, 7, 2, padding=3), 1)),
        "conv3x3_matmul": (1, 8, False,
                           _init_(layers.Conv3x3MatMul(8, 8, 2), 1)),
        "depthwise_s1": (1, 8, True, lambda x: depthwise_conv3x3(
            x, w, 1, 2, padding=2)),
        "depthwise_s2": (1, 8, True, lambda x: depthwise_conv3x3(
            x, w, 2, 1, padding=1)),
        "block_s1_fixed_pad": (2, 8, False, dw_block(1, 2, 8, "xla")),
        "block_s2_fixed_pad": (2, 8, False, dw_block(2, 1, 16, "xla")),
        "block_pallas_dw": (4, 8, False, dw_block(1, 1, 8, "pallas")),
        "s2d_block_s1": (2, 8, False, s2d_block(1, 8)),
        "s2d_block_s2": (2, 8, False, s2d_block(2, 16)),
        "max_pool": (2, 8, False, max_pool_3x3_s2),
        "resize_ac_16_to_4": (16, 8, True,
                              lambda x: resize_bilinear(x, size(4), True)),
        "resize_ac_4_to_1": (4, 8, True,
                             lambda x: resize_bilinear(x, size(1), True)),
        "resize_half_8_to_4": (8, 8, True, lambda x: resize_bilinear(
            x, (2 * x.shape[1], 2 * x.shape[2]), False)),
        "dropout": (4, 8, False, dropout),
        "global_mean": (16, 8, False, _GlobalMean()),
        "group_norm": (1, 16, False, _init_(GroupNorm(4, 16), 2)),
    }
    return (*ops[name], name == "global_mean")


def run_layers(sc) -> dict:
    """Each per-layer op of ``sc["ops"]`` on this rank's stripe of its
    input, a map of ``sc["hw"]`` at stride s (the whole map in one
    process), under the DeepLab's stride 16: the output stripes gathered
    in rank order."""
    out = {}
    h, w = sc["hw"]
    shard = mesh.height_shard(h, 16)

    def size(s):
        lo, hi = (0, -(-h // s)) if shard is None else shard.rows_at(s)
        return hi - lo, -(-w // s)

    for name in sc["ops"]:
        s, c, nhwc, op, whole = layer_op(name, size)
        g = torch.Generator().manual_seed(11)
        x = torch.randn((2, c, -(-h // s), -(-w // s)), generator=g)
        x = x.contiguous(memory_format=torch.channels_last)
        if nhwc:
            x = x.permute(0, 2, 3, 1).contiguous()
        axis = 1 if nhwc else 2
        if shard is not None:
            lo, hi = shard.rows_at(s)
            x = x.narrow(axis, lo, hi - lo)
        with torch.no_grad(), mesh.sharded_height(shard):
            y = op(x)
        if shard is not None and not whole:
            y = torch.cat(distributed.all_gather_object(y), axis)
        out[name] = y
    return out


def build_port(sc):
    """The scenario's model: the width-0.5 DeepLab at ``sc["weights"]``
    (``--pallas_dw`` with ``sc["pallas"]``, the MC-dropout sites with
    ``sc["mc"]``, blocks 0-3 in s2d layout with ``sc["s2d"]``), or the
    seeded ResNet-18 FPN."""
    from pixelpick_tpu_torch.models.factory import init_model
    from pixelpick_tpu_torch.models.fpn import FPNSeg

    if sc.get("fpn"):
        model = FPNSeg(N_CLASSES, n_layers=18, width_multiplier=WIDTH)
        init_model(model, 4)
        return model.to(memory_format=torch.channels_last).eval()
    layers.set_depthwise_impl("pallas" if sc.get("pallas") else "xla")
    try:
        model = DeepLab(N_CLASSES, width_mult=WIDTH,
                        mc_dropout=sc.get("mc", False),
                        s2d_until=4 if sc.get("s2d") else 0)
    finally:
        layers.set_depthwise_impl("xla")
    model.load_state_dict(sc["weights"])
    return model.to(memory_format=torch.channels_last).eval()


def run_score(sc) -> dict:
    """``make_score_fn`` on the host batch ``sc["batch"]`` with
    ``--spatial_query_sharding``'s split (the rank's row stripes; the whole
    images in one process), the draws injected (``sc["uniforms"]``) or
    from a generator seeded ``sc["seed"]`` that the dropouts share: the
    picks, the stats, whether the split warned and fell back, the
    depthwise launches counted and, on every rank, the blocks that ran in
    s2d layout."""
    import warnings

    import numpy as np

    from pixelpick_tpu_torch.active.acquisition import make_score_fn
    from pixelpick_tpu_torch.ops import depthwise

    model = build_port(sc)
    g = torch.Generator().manual_seed(sc.get("seed", 0))
    model.set_dropout_generator(g)
    score = make_score_fn(model, mean=MEAN, std=STD, ignore_index=N_CLASSES,
                          **sc["kw"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shard = mesh.height_shard(sc["batch"]["x"].shape[1],
                                  model.total_stride)
    local = mesh.shard_rows(sc["batch"], shard)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in local.items()}
    uniforms = None if sc.get("uniforms") is None else {
        k: torch.from_numpy(v) for k, v in sc["uniforms"].items()}
    ran_s2d = set()
    for i, block in enumerate(model.backbone.features[1:]
                              if sc.get("s2d") else ()):
        if hasattr(block, "forward_s2d"):
            block.forward_s2d = _recorded(block.forward_s2d, ran_s2d, i)
    depthwise.reset_launch_counts()
    with mesh.sharded_height(shard):
        idx, stats = score(batch, g, uniforms)
    return {"idx": idx.numpy(), "stats": {k: v.numpy()
                                          for k, v in stats.items()},
            "warned": any("replicated" in str(w.message) for w in caught),
            "sharded": shard is not None,
            "launches": dict(depthwise.launch_counts),
            "s2d_blocks": distributed.all_gather_object(sorted(ran_s2d))}


def _recorded(fn, ran: set, i: int):
    """``fn`` (a block's ``forward_s2d``), adding the block's index to
    ``ran`` at each call."""
    def call(*a, **kw):
        ran.add(i)
        return fn(*a, **kw)
    return call


def run_pipe(sc) -> dict:
    """A device-pipeline batch of ``sc["indices"]`` over a synthetic
    CamVid (crop 32x48), the micro-batch size ``sc["micro"]`` (0: one
    update), its draws from a generator seeded 3: every rank's rows
    gathered into the global batch, with the row flags and overflow."""
    import numpy as np

    from pixelpick_tpu_torch.data.device_pipeline import DevicePipeline
    from pixelpick_tpu_torch.data.factory import get_dataset

    args = default_args(device="cpu", **sc["args"])
    ds = get_dataset(args, val=False, query=False)
    ds.crop_size = (32, 48)
    pipe = DevicePipeline(ds, args, "cpu")
    pipe.set_queries(ds.queries)
    pipe.pad_multiple, pipe.micro_bs = sc["micro"] or 1, sc["micro"]
    pipe.pad_to_devices = True
    batch = pipe.sample_batch(sc["indices"], torch.Generator().manual_seed(3))
    b = batch["global_rows"]
    pos, _ = mesh.megabatch_rows(b, sc["micro"] or b)
    keys = ("x", "coords", "labels", "valid")
    local = {k: batch[k].numpy() for k in keys}
    local["rows_real"] = batch["rows_real"].get()
    out = {}
    for k, v in local.items():
        out[k] = mesh.gather_rows(v, pos, b)
    out["shard"] = batch["shard"]
    out["overflow"] = int(batch["overflow"])
    out["n_real"] = batch["n_real"]
    out["rows"] = np.arange(b) if pos is None else pos
    return out


SCENARIOS = {"step": run_step, "bn": run_bn, "micro": run_micro,
             "eval": run_eval, "sweep": run_sweep, "pipe": run_pipe,
             "layers": run_layers, "score": run_score}


def run(spec: dict) -> dict:
    return {name: SCENARIOS[sc["kind"]](sc) for name, sc in spec.items()}


def main(spec_path, rank, world, port, out):
    torch.set_num_threads(2)
    distributed.initialize_from_args(SimpleNamespace(
        dist_coordinator=f"localhost:{port}", dist_num_processes=int(world),
        dist_process_id=int(rank), device="cpu", dist_backend="gloo",
        data_parallel=0))
    try:
        with open(spec_path, "rb") as f:
            result = run(pickle.load(f))
        if distributed.is_primary():
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
