"""One rank of ``tests/test_torch_rank_tracing.py``.

    python tests/torch_rank_tracing_worker.py SPEC RANK WORLD PORT OUT

joins a gloo world of WORLD CPU processes on localhost:PORT and scores the
pickled SPEC's pool batch once with the tracer off and once on, under the
height shard of ``--spatial_query_sharding`` (``parallel/mesh.py``), with
``torch.distributed``'s ``all_gather`` and ``all_reduce`` wrapped so that
the bytes each rank hands them are counted apart from the port's counters.
Then it sends a small object over ``all_gather_object``, gathers every
rank's records (``utils/profiling.py:gather_records``) and writes
a ``trace()`` of one collective; it pickles what it saw to ``OUT.<rank>``.
Imports torch and the port only (no JAX).
"""

import os
import pickle
import sys
from types import SimpleNamespace

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pixelpick_tpu_torch.active.acquisition import make_score_fn  # noqa: E402
from pixelpick_tpu_torch.models.deeplab import DeepLab  # noqa: E402
from pixelpick_tpu_torch.parallel import distributed, mesh  # noqa: E402
from pixelpick_tpu_torch.utils import profiling  # noqa: E402

HANDED = {"all_gather": [], "all_reduce": []}  # bytes of each call


def _wrap(name: str) -> None:
    real = getattr(dist, name)

    def counted(*args, **kw):
        t = args[1] if name == "all_gather" else args[0]
        HANDED[name].append(t.numel() * t.element_size())
        return real(*args, **kw)

    setattr(dist, name, counted)


def score_once(spec, score) -> tuple:
    """One pool batch scored on this rank's stripes, on the seeded draws."""
    batch = spec["batch"]
    shard = mesh.height_shard(batch["x"].shape[1], 16)
    local = mesh.shard_rows(batch, shard)
    gen = torch.Generator().manual_seed(spec["draw_seed"])
    with mesh.sharded_height(shard):
        idx, stats = score({k: torch.from_numpy(local[k])
                            for k in ("x", "excluded", "y")}, gen)
    return idx, stats["entropy"]


def main(spec_path, rank, world, port, out):
    torch.set_num_threads(2)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    distributed.initialize_from_args(SimpleNamespace(
        dist_coordinator=f"localhost:{port}", dist_num_processes=int(world),
        dist_process_id=int(rank), device="cpu", dist_backend="gloo",
        data_parallel=0))
    try:
        model = DeepLab(spec["n_classes"], width_mult=spec["width"])
        model.load_state_dict(spec["weights"])
        model = model.to(memory_format=torch.channels_last).eval()
        score = make_score_fn(model, strategy="margin_sampling",
                              mean=spec["mean"], std=spec["std"],
                              n_pixels=spec["n_pixels"],
                              top_n_percent=spec["top_n_percent"],
                              reverse_order=False,
                              ignore_index=spec["n_classes"])
        _wrap("all_gather")
        _wrap("all_reduce")
        off = score_once(spec, score)
        seen = {"off_records": profiling.spans(),
                "off_counters": profiling.counters(),
                "off_handed": {k: list(v) for k, v in HANDED.items()}}
        for v in HANDED.values():
            v.clear()
        profiling.enable()
        picks = score_once(spec, score)
        seen.update(picks=picks, off_picks=off, records=profiling.spans(),
                    counters=profiling.counters(),
                    handed={k: list(v) for k, v in HANDED.items()})
        obj = {"rank": int(rank), "tag": "x" * (10 + 5 * int(rank))}
        before = profiling.counters()
        seen["objects"] = distributed.all_gather_object(obj)
        after = profiling.counters()
        seen["object_bytes"] = (after["collective_bytes"]
                                - before["collective_bytes"],
                                len(pickle.dumps(obj)))
        seen["object_spans"] = [x.name for x in profiling.spans()
                                if x.name == "ranks.gather_object"]
        seen["gathered"] = profiling.gather_records()
        with profiling.trace(spec["trace_dir"]):
            distributed.all_gather_tensor(torch.ones(3))
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(seen, f)
    finally:
        profiling.disable()
        distributed.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
