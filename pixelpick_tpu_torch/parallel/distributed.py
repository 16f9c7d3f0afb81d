"""Multi-process wiring over ``torch.distributed``: one process per card.

Counterpart of ``pixelpick_tpu/parallel/distributed.py:33-84``. The JAX
package wires one process per host into one runtime and lets its mesh shard
each batch; here every rank is a process of its own, holds the whole model
and the whole global batch on the host (the same dataset and seeds on every
rank), and computes its rows of each batch (``parallel/mesh.py``).

- ``--dist_coordinator host:port --dist_num_processes N --dist_process_id
  I`` joins rank I of N at ``tcp://host:port``; ``--dist_coordinator auto``
  reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``), the counterpart of JAX's cluster
  auto-detection. A rank's card is ``cuda:LOCAL_RANK``, or ``I % (cards
  visible)`` without torchrun.
- The backend is NCCL for ``--device cuda`` and gloo for ``--device cpu``;
  the port's own ``--dist_backend`` overrides it (NCCL refuses two ranks on
  one card, gloo does not).
- A gloo group beside the world group carries host-side data: picks,
  objects and barriers.
- With the tracer on (``utils/profiling.py``), each collective here is a
  span (``ranks.all_gather``, ``ranks.all_reduce``, ``ranks.gather_object``)
  and adds 1 to ``collective_calls`` and the bytes this rank hands to it
  (a tensor's, or an object's pickle) to ``collective_bytes``; the spans
  carry the rank. Under NCCL a span holds the enqueue, not the transfer.
- ``--data_parallel N`` without a coordinator starts N local ranks on a
  free localhost port (``launch_data_parallel``); 0 means every visible
  card, so one card runs the single-process path as before.

JAX's ``LockstepJit`` has no counterpart: it aligns processes around each
program's first compile, and nothing here is compiled per shape.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
from datetime import timedelta
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from pixelpick_tpu_torch.utils import profiling

# the gloo group for host-side data; the world group itself under gloo
_HOST_GROUP = None
TIMEOUT = timedelta(minutes=30)


def initialize_from_args(args) -> bool:
    """Join this process to the ranks ``args`` names, if any; returns True
    if it did. Sets the rank's card as the current CUDA device."""
    coord = getattr(args, "dist_coordinator", "") or ""
    if not coord:
        return False
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is initialised already")
    if coord == "auto":
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    else:
        rank, world = args.dist_process_id, args.dist_num_processes
        local = None
        init = f"tcp://{coord}"
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dp = int(getattr(args, "data_parallel", 0) or 0)
    if dp not in (0, world):
        # pixelpick_tpu/parallel/mesh.py:get_mesh: a sub-mesh would leave
        # processes without rows
        raise ValueError(
            f"--data_parallel={dp} under multi-process must use all {world} "
            "processes (one rank per card); drop the flag or set it to 0")
    backend = getattr(args, "dist_backend", "auto")
    if backend == "auto":
        backend = "nccl" if args.device == "cuda" else "gloo"
    if args.device == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("device 'cuda' was asked for but no CUDA "
                               "device is visible; pass --device cpu")
        torch.cuda.set_device(local if local is not None else rank % n)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    global _HOST_GROUP
    _HOST_GROUP = dist.group.WORLD if backend == "gloo" \
        else dist.new_group(backend="gloo", timeout=TIMEOUT)
    profiling.set_rank(rank)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
    profiling.set_rank(0)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that writes shared-filesystem artifacts."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (host-side, over gloo); a no-op for one."""
    if world_size() > 1:
        dist.barrier(group=_HOST_GROUP)


def _counted(nbytes: int) -> None:
    profiling.count("collective_calls")
    profiling.count("collective_bytes", nbytes)


def _pickled_bytes(obj) -> int:
    """The bytes of ``obj``'s pickle, as the object collectives send it;
    pickled only with the tracer on."""
    return len(pickle.dumps(obj)) if profiling.enabled() else 0


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (host-side, over gloo)."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    with profiling.span("ranks.gather_object"):
        _counted(_pickled_bytes(obj))
        dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out


def _eval_only(t: torch.Tensor) -> None:
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError("the height shard's collectives are eval-only: "
                           "no gradient flows through them")


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the world group's backend takes it: under gloo a CUDA
    tensor is staged through host memory (two ranks sharing one card run
    gloo, and gloo's collectives on CUDA tensors are partial)."""
    if t.is_cuda and dist.get_backend() == "gloo":
        t = t.cpu()
    return t.contiguous()


def all_gather_tensor(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (the same shape and dtype on every rank), in rank
    order, on ``t``'s device; over the world group (NCCL on cards, gloo on
    the CPU). Eval only; a failed collective raises."""
    if world_size() == 1:
        return [t]
    _eval_only(t)
    with profiling.span("ranks.all_gather"):
        src = _staged(t)
        _counted(src.numel() * src.element_size())
        out = [torch.empty_like(src) for _ in range(world_size())]
        dist.all_gather(out, src)
        return [o.to(t.device) for o in out]


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, a new tensor on ``t``'s device;
    over the world group. Eval only (no gradient flows through it)."""
    if world_size() == 1:
        return t
    _eval_only(t)
    with profiling.span("ranks.all_reduce"):
        src = _staged(t)
        if src.data_ptr() == t.data_ptr():
            src = src.clone()
        _counted(src.numel() * src.element_size())
        dist.all_reduce(src)
        return src.to(t.device)


def check_replicated(model: torch.nn.Module) -> None:
    """Raise unless every rank holds the same weights and buffers: each is
    built from the same seed, which stands in for broadcasting rank 0's
    (JAX ``mesh.py:shard_pytree``). Compares per-tensor f64 sums and
    maxima, exactly."""
    if world_size() == 1:
        return
    with torch.no_grad():
        sig = torch.stack([torch.stack([t.double().sum(), t.double().abs()
                                        .max()]) if t.numel() else
                           torch.zeros(2, dtype=torch.float64)
                           for t in model.state_dict().values()]).cpu()
    sigs = all_gather_object(sig)
    if not all(torch.equal(s, sigs[0]) for s in sigs):
        raise RuntimeError("the ranks' initial weights differ")


# ------------------------------ launcher ------------------------------

def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_world(args) -> int:
    """How many local ranks ``--data_parallel`` asks for: 0 is every
    visible card (one process on the CPU), and a count above the visible
    cards is clamped to them (``mesh.py:get_mesh``); on the CPU, the count
    asked for."""
    n = int(getattr(args, "data_parallel", 0) or 0)
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        return min(n, cards) if n else cards
    return max(n, 1)


def launch_data_parallel(module: str, argv: List[str]) -> bool:
    """Run ``python -m module argv`` as the local ranks of ``--data_parallel
    N`` when N > 1 and no ``--dist_coordinator`` is given; returns False
    (run here, one process) otherwise. Each rank gets its coordinator flags
    on a free localhost port. When one rank fails the others are stopped
    and ``SystemExit`` carries its exit code."""
    from pixelpick_tpu_torch.config import build_parser

    args, _ = build_parser().parse_known_args(argv)
    if args.dist_coordinator:
        return False
    n = local_world(args)
    if n <= 1:
        return False
    coord = f"localhost:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--dist_coordinator", coord,
         "--dist_num_processes", str(n), "--dist_process_id", str(i),
         "--data_parallel", str(n)]) for i in range(n)]
    failed = 0
    try:
        while any(p.poll() is None for p in procs) and not failed:
            failed = next((p.returncode for p in procs
                           if p.returncode not in (None, 0)), 0)
            time.sleep(0.1)
        failed = failed or next((p.returncode for p in procs
                                 if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if failed:
        raise SystemExit(failed)
    return True


def run_entry(module: str, argv: Optional[List[str]], body: Callable):
    """An entry point's process: ``body(args)`` on the parsed arguments of
    ``argv`` (default ``sys.argv[1:]``), leaving the process group at the
    end; or, under ``--data_parallel N > 1``, start the N ranks of
    ``python -m module`` and return None."""
    from pixelpick_tpu_torch.config import Arguments

    argv = sys.argv[1:] if argv is None else list(argv)
    if launch_data_parallel(module, argv):
        return None
    try:
        return body(Arguments().parse_args(argv))
    finally:
        shutdown()
