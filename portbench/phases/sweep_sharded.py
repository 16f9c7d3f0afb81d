"""Phase ``sweep_sharded``: the ``sweep`` phase's whole margin-sampling
sweeps of the pool (``phases/sweep.py``), every pool image split by row
stripes over the ranks of one host (``--spatial_query_sharding``), one
process per rank; the traffic's ``ranks`` and ``backend`` name the world.

- Rank 0 is ``run.py``'s process, on the first card. It builds the kernels,
  writes the dataset, makes the seeded weights and the labelled pixels of
  the rounds before, leaves them in the run's directory, and starts ranks
  1.. as processes of their own (``pb/ranks.py``), one card each by the
  port's rule (``rank % cards``).
- Every rank builds the same phase over the same files and seed and joins
  the port's world with its coordinator flags on a free localhost port, as
  ``parallel/distributed.py:launch_data_parallel`` starts its ranks
  (``config.py:finalize_args`` calls ``initialize_from_args``); then it
  decodes the pool and sweeps it once, warm.
- Rank 0 says a word over a gloo group of the harness's before each sweep
  of the window and of the profiled stretch (``sweep``), and after them
  (``end``); the other ranks sweep when told. So every rank runs the same
  sweeps, and the window, its images and the compared picks (those of
  rank 0's last sweep, whole images after the gather) are rank 0's.
- At ``end`` every rank's peak device memory since its set-up goes to rank
  0, which prints them, and in a traced run every rank's span records and
  counts (``utils/profiling.py:gather_records``, where the port has it;
  ``rank_records``, else None). Rank 0 prints there how long each sweep
  of the window took, which shows whether a slow run was slow throughout.
- A rank that exits before ``end``, or a run that goes ``STALL_S`` without
  progress before it, ends the run at once: rank 0 kills the
  other ranks and exits ``FAILED_EXIT`` with no result line. A rank whose
  parent is gone exits. No rank waits on the port's own timeout.

With one rank the phase is the ``sweep`` phase in one process.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from pb import check, data, program, weights as weights_mod
from pb.phase import (
    CALIBRATION_IMAGES, MODEL_FLAGS, PORT_SEED_RANGE, LoaderProxy,
    Phase as Base, port_overrides,
)
from reference import augment as ref_aug, steps as ref_steps

MASK_SALT = 0x1AB3  # the sweep phase's: the same labelled pixels
NTH_QUERY = 1  # a sweep of the round after the first
STALL_S = 60.0  # the longest the ranks may go without progress
WORD_TIMEOUT = timedelta(seconds=100)
FAILED_EXIT = 7
SHARED = "shared.pt"  # rank 0's weights and labelled pixels
RANKS_PY = Path(__file__).resolve().parent.parent / "pb" / "ranks.py"


class Phase(Base):
    DRIVES = MODEL_FLAGS | {"spatial_query_sharding"}

    def __init__(self, cell, seed, seconds, trace, device, workdir,
                 fault=None, rank: int = 0, coordinator: str = ""):
        # a profiled stretch on rank 0 alone; the port's tracer on every
        # rank of a traced run
        super().__init__(cell, seed, seconds, trace and rank == 0, device,
                         workdir, fault)
        self.traced = bool(trace)
        self.rank, self.world = rank, int(self.traffic["ranks"])
        self.coordinator = coordinator
        self.procs: list = []
        self.words = None
        self.finished = False
        self.warm_batches = None  # the pool batches of set-up's sweep
        self.rank_records = None
        self.sweep_s: list = []  # rank 0's, over the window
        self.stamp = time.monotonic()
        self.watching = threading.Event()

    # ----------------------------- set-up -----------------------------

    def setup(self) -> None:
        from pixelpick_tpu_torch.active.driver import ALModel
        from pixelpick_tpu_torch.active.selector import QuerySelector
        from pixelpick_tpu_torch.config import default_args
        from pixelpick_tpu_torch.models.factory import get_model

        cfg, cuda = self.cfg, self.device.type == "cuda"
        over = port_overrides(cfg, self.traffic, self.DRIVES)
        self.port_seed = self.seed % PORT_SEED_RANGE
        root = self.workdir / "data"
        if self.rank == 0:
            self.prepare(root)
        else:
            self.data = data.Dataset(root)
            if self.traced:
                program.enable()
        over.update(dir_dataset=str(root), device=self.device.type,
                    dir_checkpoints=str(self.workdir / "run"),
                    seed=self.port_seed, debug=False)
        if self.world > 1:
            over.update(dist_coordinator=self.coordinator,
                        dist_num_processes=self.world,
                        dist_process_id=self.rank, data_parallel=self.world,
                        dist_backend=self.traffic["backend"] if cuda
                        else "gloo")
        self.args = default_args(cfg["dataset"], **over)  # joins the world
        if self.world > 1:
            self.words = torch.distributed.new_group(backend="gloo",
                                                     timeout=WORD_TIMEOUT)
        self.tick()
        shared = torch.load(self.workdir / SHARED, map_location="cpu")
        self.weights = {k: v.to(self.device)
                        for k, v in shared["weights"].items()}
        self.masks = [m.numpy() for m in shared["masks"]]
        self.al = ALModel(self.args)
        self.model = get_model(self.args, self.device, seed=self.port_seed)
        self.model.load_state_dict(self.weights)
        if torch.backends.cudnn.allow_tf32 != cfg["tf32"] \
                or torch.backends.cuda.matmul.allow_tf32 != cfg["tf32"]:
            raise ValueError("TF32 is not as the configuration states")
        self.al.model = self.model
        self.al.nth_query = 0
        self.al.dataset.queries = self.al.dataset_query.queries = \
            list(self.masks)
        self.fill_cache(self.al.dataset_query)
        self.tick()
        self.proxy = LoaderProxy(self.al.loader_query, self.spans)
        self.selector = QuerySelector(self.args, self.proxy, self.model,
                                      self.device)
        self.selector._score_fn = self.timed(self.selector._score_fn)
        self.images, self.batch_shapes, self.kept = 0, [], []
        self.nth_query = NTH_QUERY
        self.one_sweep()  # every batch shape of the pool, warm
        self.warm_batches = len(self.batch_shapes)
        if self.rank > 0 and cuda:  # rank 0's: run.py resets it
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def prepare(self, root: Path) -> None:
        """Rank 0's part: the kernels built, the dataset, weights and
        labelled pixels written for every rank, the other ranks started."""
        from pixelpick_tpu_torch.ops import build

        cfg = self.cfg
        if self.device.type == "cuda":
            build.build_all(["depthwise", "fused_ir"])
        self.data = data.write(cfg, self.seed, root,
                               {"train": cfg["n_train"], "val": 1},
                               self.device)
        weights = weights_mod.make(cfg, self.seed, self.device)
        x = torch.from_numpy(np.stack(
            self.data.images["train"][:CALIBRATION_IMAGES])).to(self.device)
        weights.update(ref_steps.calibrated_running_stats(weights, x, cfg))
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed ^ MASK_SALT) & ((1 << 63) - 1))
        labels = [ref_aug.base_resized_label(y, cfg)
                  for y in self.data.labels["train"]]
        masks = data.labelled_masks(labels, cfg["labelled_per_image"],
                                    cfg["ignore_index"], gen)
        torch.save({"weights": {k: v.cpu() for k, v in weights.items()},
                    "masks": [torch.from_numpy(m) for m in masks]},
                   self.workdir / SHARED)
        if self.world > 1:
            self.start_ranks()

    def start_ranks(self) -> None:
        from pixelpick_tpu_torch.parallel.distributed import free_port

        self.coordinator = f"localhost:{free_port()}"
        cmd = [sys.executable, str(RANKS_PY), "--workload", self.cell.name,
               "--seed", str(self.seed), "--seconds", str(self.seconds),
               "--trace", str(int(self.traced)), "--coordinator",
               self.coordinator, "--workdir", str(self.workdir),
               "--device", self.device.type, "--fault", self.fault or ""]
        # their output goes to standard error: the last line of standard
        # output is the result's
        self.procs = [subprocess.Popen([*cmd, "--rank", str(r)], stdout=2)
                      for r in range(1, self.world)]
        self.tick()
        threading.Thread(target=self.watch, daemon=True).start()

    # ----------------------------- liveness -----------------------------

    def tick(self) -> None:
        self.stamp = time.monotonic()

    def watch(self) -> None:
        """Rank 0's watchdog over the other ranks, until ``free_program``
        has seen them out."""
        while not self.watching.wait(0.5):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and (rc != 0 or not self.finished):
                    self.abort(f"rank {r} exited with {rc} before the end")
            if not self.finished and time.monotonic() - self.stamp > STALL_S:
                self.abort(f"no progress for {STALL_S:.0f} s")

    def abort(self, why: str) -> None:
        print(f"portbench: {why}; the run is stopped. No result.",
              file=sys.stderr, flush=True)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(self.workdir, ignore_errors=True)
        os._exit(FAILED_EXIT)

    # ----------------------------- the loop -----------------------------

    def timed(self, score):
        """The selector's scoring function, timed (span ``score``), its
        picks, entropies and whole batch shapes kept, and a fault planted
        where the run asks for one."""
        from pixelpick_tpu_torch.parallel import mesh

        def timed_score(batch, generator=None, uniforms=None):
            with self.spans.span("score"):
                idx, stats = score(batch, generator, uniforms)
            self.tick()
            shard = mesh.current_height_shard()
            b, h, w = batch["x"].shape[:3]
            h = shard.bounds[-1] if shard is not None else h
            if self.fault == "altered":  # a planted fault, for the check
                idx = idx.clone()
                idx[:, 0] = (idx[:, 0] + 1) % (h * w)
            self.kept.append((idx, stats["entropy"]))
            self.batch_shapes.append((b, h, w))
            self.images += b
            if self.rank == 1 and self.fault in ("rank_lost", "rank_hung") \
                    and self.warm_batches is not None \
                    and len(self.batch_shapes) == self.warm_batches + 2:
                # planted faults, mid-window: the rank killed, or stuck
                if self.fault == "rank_lost":
                    os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(10 ** 6)
            return idx, stats

        return timed_score

    def say(self, word: str) -> None:
        """Rank 0's word to the other ranks."""
        self.tick()
        if self.world > 1:
            torch.distributed.broadcast_object_list([word], src=0,
                                                    group=self.words)

    def hear(self) -> str:
        box = [None]
        torch.distributed.broadcast_object_list(box, src=0, group=self.words)
        return box[0]

    def serve(self) -> None:
        """The other ranks' loop: sweep when told, until ``end``."""
        while self.hear() == "sweep":
            self.one_sweep()
        self.finish()

    def one_sweep(self) -> None:
        self.kept = []
        self.selector(self.nth_query)
        # the next sweep is of the same round: the picks just labelled go
        self.al.dataset.queries = self.al.dataset_query.queries = \
            list(self.masks)

    def run_window(self) -> None:
        images0, shapes0 = self.images, len(self.batch_shapes)
        t0 = self.open_window()
        sweeps = 0
        while time.perf_counter() < t0 + self.seconds:
            t = time.perf_counter()
            self.say("sweep")
            self.one_sweep()
            self.sweep_s.append(time.perf_counter() - t)
            sweeps += 1
        self.window = {"seconds": time.perf_counter() - t0,
                       "images": self.images - images0, "sweeps": sweeps,
                       "batches": len(self.batch_shapes) - shapes0}

    def progress(self) -> int:
        return len(self.batch_shapes)

    def traced_work(self) -> None:
        """One more whole sweep on every rank, whose picks are not
        compared."""
        kept = self.kept
        self.say("sweep")
        self.one_sweep()
        self.kept = kept

    def run_stretch(self) -> None:
        super().run_stretch()
        self.finish()

    def finish(self) -> None:
        """``end``: every rank's peak device memory and, traced, its span
        records and counts to rank 0."""
        if self.finished:
            return
        if self.rank == 0:
            self.say("end")
        self.finished = True
        peak = torch.cuda.max_memory_allocated() \
            if self.device.type == "cuda" else 0
        if self.world > 1:
            peaks = [None] * self.world if self.rank == 0 else None
            torch.distributed.gather_object(peak, peaks, dst=0,
                                            group=self.words)
        else:
            peaks = [peak]
        from pixelpick_tpu_torch.utils import profiling

        gather = getattr(profiling, "gather_records", None)
        records = gather() if gather is not None and self.traced else None
        if self.rank == 0:
            self.rank_records = records
            print(f"portbench: peak device memory by rank {peaks} bytes",
                  file=sys.stderr, flush=True)
            print("portbench: the window's sweeps took "
                  f"{[round(t, 4) for t in self.sweep_s]} s",
                  file=sys.stderr, flush=True)

    def free_program(self) -> None:
        from pixelpick_tpu_torch.parallel import distributed

        self.finish()
        super().free_program()
        distributed.shutdown()
        for r, p in enumerate(self.procs, 1):
            try:
                rc = p.wait(timeout=STALL_S)
            except subprocess.TimeoutExpired:
                self.abort(f"rank {r} did not exit")
            if rc != 0:
                self.abort(f"rank {r} exited with {rc}")
        self.watching.set()

    def numbers(self, prec: str = "f32"):
        return check.sweep_numbers(self, prec)
