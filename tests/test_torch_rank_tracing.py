"""The port's tracer across ranks (``utils/profiling.py``,
``parallel/distributed.py``): the spans and counters of the collectives,
each record tagged with its rank, every rank's records gathered to every
rank (rank 0 reads them),
one ``trace()`` file per rank, and the height-sharded sweep held to the
benchmark's plain reference (``portbench/reference``) by the measures of
``portbench/pb/check.py:sweep_numbers``.

Two gloo ranks on the CPU (``tests/torch_rank_tracing_worker.py``) score
one pool batch of 2 images of 128x256 on row stripes of 64 rows, with a
seeded DeepLabv3+ on MobileNetV2 at width 0.25, 19 classes, its weights and
running statistics the benchmark's (``portbench/pb/weights.py``,
``reference/steps.py:calibrated_running_stats``).

Tolerances of the comparison with the reference (``PICK_TOL``,
``ENTROPY_TOL``): both sides compute in f32 on the CPU, and the stripes
change only the order of the ASPP mean's f64 sums and the shapes of the
convolutions, so the margins and entropies agree to about 1e-6 (the
benchmark reads 6.3e-6 and 2.35e-5 at full width on the card, PERF.md
§6); 1e-4 leaves room for that, while a pick one pixel off reads 0.1 and
more (the harness's ``altered`` fault) and the reference in TF32 about 0.2
at full size.
"""

import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pixelpick_tpu_torch.parallel import distributed
from pixelpick_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "portbench"))

from pb import check, weights as weights_mod  # noqa: E402
from reference import steps as ref_steps  # noqa: E402

WORKER = os.path.join(REPO, "tests", "torch_rank_tracing_worker.py")
TIMEOUT = 120  # seconds, for the two ranks
WORLD, HW, BATCH = 2, (128, 256), 2
PORT_SEED, NTH_QUERY = 5, 1
PICK_TOL = ENTROPY_TOL = 1e-4
CFG = dict(network="deeplab", width_multiplier=0.25, output_stride=16,
           n_classes=19, ignore_index=19, n_pixels_by_us=10,
           top_n_percent=0.05, mc_dropout_p=0.2,
           mean=[0.28689554, 0.32513303, 0.28389177],
           std=[0.18696375, 0.19017339, 0.18720214])


def pool_batch(seed: int = 3) -> dict:
    """Images of a colour per 16x16 tile of class, a little noise, void
    and labelled pixels among them."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, CFG["n_classes"] + 1,
                         (BATCH, HW[0] // 16, HW[1] // 16))
    y = tiles.repeat(16, 1).repeat(16, 2).astype(np.int32)
    palette = rng.integers(0, 256, (CFG["n_classes"] + 1, 3))
    x = np.clip(palette[y] + rng.integers(-6, 7, (*y.shape, 3)), 0, 255)
    return {"x": x.astype(np.uint8), "y": y,
            "excluded": rng.random(y.shape) < 0.002}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The batch, the weights and what each of the two ranks saw."""
    tmp = tmp_path_factory.mktemp("ranks")
    batch = pool_batch()
    weights = weights_mod.make(CFG, 11, "cpu")
    weights.update(ref_steps.calibrated_running_stats(
        weights, torch.from_numpy(batch["x"]), CFG))
    spec = dict(batch=batch, weights=weights, n_classes=CFG["n_classes"],
                width=CFG["width_multiplier"], mean=CFG["mean"],
                std=CFG["std"], n_pixels=CFG["n_pixels_by_us"],
                top_n_percent=CFG["top_n_percent"],
                draw_seed=(PORT_SEED * check.PICK_SELECTOR_SEED + NTH_QUERY)
                & 0x7FFFFFFF, trace_dir=str(tmp / "trace"))
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    port = distributed.free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    with open(tmp / "ranks.log", "w") as log:
        procs = [subprocess.Popen(
            [sys.executable, WORKER, str(tmp / "spec.pkl"), str(r),
             str(WORLD), str(port), str(tmp / "seen")], cwd=REPO, env=env,
            stdout=log, stderr=subprocess.STDOUT) for r in range(WORLD)]
        try:
            for p in procs:
                p.wait(timeout=TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    assert all(p.returncode == 0 for p in procs), \
        (tmp / "ranks.log").read_text()[-4000:]
    seen = []
    for r in range(WORLD):
        with open(tmp / f"seen.{r}", "rb") as f:
            seen.append(pickle.load(f))
    return SimpleNamespace(batch=batch, weights=weights, seen=seen,
                           trace_dir=tmp / "trace")


def test_the_collectives_count_what_each_rank_hands_them(ranks):
    """One sharded pool batch: a span per collective, and the counters
    equal to the calls and bytes each rank gave ``all_gather`` and
    ``all_reduce``."""
    for r, s in enumerate(ranks.seen):
        handed = s["handed"]
        assert handed["all_gather"] and handed["all_reduce"]
        names = [x.name for x in s["records"]]
        assert names.count("ranks.all_gather") == len(handed["all_gather"])
        assert names.count("ranks.all_reduce") == len(handed["all_reduce"])
        assert s["counters"] == {
            "collective_calls": sum(map(len, handed.values())),
            "collective_bytes": sum(map(sum, handed.values()))}
        assert {x.rank for x in s["records"]} == {r}
        assert {x.parent for x in s["records"]} == {None}


def test_the_tracer_off_records_no_collective(ranks):
    for s in ranks.seen:
        assert s["off_records"] == [] and s["off_counters"] == {}
        assert s["off_handed"] == s["handed"]  # the same collectives ran
        for a, b in zip(s["off_picks"], s["picks"]):
            assert torch.equal(a, b)


def test_an_object_gather_counts_its_pickle(ranks):
    for s in ranks.seen:
        assert [o["rank"] for o in s["objects"]] == list(range(WORLD))
        sent, pickled = s["object_bytes"]
        assert sent == pickled
        assert s["object_spans"] == ["ranks.gather_object"]


def test_every_ranks_records_are_gathered_to_rank_0(ranks):
    gathered = ranks.seen[0]["gathered"]
    assert len(gathered) == WORLD
    assert ranks.seen[1]["gathered"][0][0] == gathered[0][0]
    for r, (records, counts) in enumerate(gathered):
        # the sweep's records, then the object gather's
        own = ranks.seen[r]["records"]
        assert records[:len(own)] == own
        assert [x.name for x in records[len(own):]] == \
            ranks.seen[r]["object_spans"]
        assert {x.rank for x in records} == {r}
        assert sum(n for c, n, _ in counts if c == "collective_bytes") \
            == ranks.seen[r]["object_bytes"][0] + sum(
                map(sum, ranks.seen[r]["handed"].values()))


def test_trace_writes_one_file_per_rank(ranks):
    assert sorted(os.listdir(ranks.trace_dir)) == [
        f"trace.rank{r}.json" for r in range(WORLD)]


def test_one_process_keeps_its_own_records():
    profiling.clear()
    profiling.enable()
    try:
        with profiling.span("a"):
            pass
        assert distributed.all_gather_tensor(torch.ones(2))[0].sum() == 2
        (records, counts), = profiling.gather_records()
        assert [(x.name, x.rank) for x in records] == [("a", 0)]
        assert counts == []  # one rank runs no collective
    finally:
        profiling.disable()
        profiling.clear()


def test_sharded_picks_are_held_to_the_plain_reference(ranks):
    """Every rank's picks are the whole images' and the same; the first
    rank's are held to the reference's margins and entropies."""
    idx, ent = ranks.seen[0]["picks"]
    assert torch.equal(idx, ranks.seen[1]["picks"][0])
    b = ranks.batch
    phase = SimpleNamespace(
        cfg=CFG, device=torch.device("cpu"), weights=ranks.weights,
        port_seed=PORT_SEED, nth_query=NTH_QUERY, kept=[(idx, ent)],
        masks=list(b["excluded"]),
        data=SimpleNamespace(images={"train": list(b["x"])},
                             labels={"train": list(b["y"])}))
    got = check.sweep_numbers(phase)
    assert got["pick_gap"] <= PICK_TOL, got
    assert got["entropy_gap"] <= ENTROPY_TOL, got
    # the measures see a pick moved by one pixel
    moved = idx.clone()
    moved[:, 0] = (moved[:, 0] + 1) % (HW[0] * HW[1])
    phase.kept = [(moved, ent)]
    bad = check.sweep_numbers(phase)
    assert max(bad["pick_gap"], bad["entropy_gap"]) > 100 * PICK_TOL, bad
