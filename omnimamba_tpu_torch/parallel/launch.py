"""Start the ranks of one program in processes of their own, on this host.

``run_ranks(fn, world_size, args)`` starts ``world_size`` processes by
``spawn`` (a fresh interpreter each: nothing of the caller's state but
``sys.path`` and the pickled ``fn`` and ``args``), joins them into one
``torch.distributed`` process group and returns ``[fn(rank, world_size,
*args) for rank in ...]``, each computed in its own rank. It is the launcher
of the tests and of ``chip_smoke.py``; a training run is started by
``torchrun`` (``scripts/train.py``).

- The ranks meet through a ``FileStore`` in a new temporary directory, so no
  TCP port is taken and runs side by side (test workers) cannot collide.
- Every wait has a deadline: a rank that raises, dies or outlives
  ``timeout`` ends the whole run with an error that names it, and every
  process started is stopped before ``run_ranks`` returns or raises.
- A rank sets ``torch.set_num_threads(1)``: several ranks share the host's
  cores. ``fn`` and its module are imported in the rank, so they must be
  defined at the top level of a module whose imports the rank can afford.
- A result goes back pickled by value (tensors too, on the CPU).
- ``backend="nccl"`` gives rank r the card ``cuda:r`` and raises where there
  are fewer cards than ranks; ``"gloo"`` leaves the device to ``fn`` (gloo
  also takes CUDA tensors, so ranks can share one card).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Sequence


def _rank_main(fn: Callable, rank: int, world_size: int, store_path: str, backend: str,
               timeout: float, args: Sequence, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            if rank >= torch.cuda.device_count():
                raise RuntimeError(f"rank {rank} of an nccl group needs cuda:{rank}; this host has "
                                   f"{torch.cuda.device_count()} card(s)")
            torch.cuda.set_device(rank)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - sent to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        return
    # pickled here, by value: the queue's own pickler would send a tensor as a handle to
    # shared memory, which dies with this process
    results.put((rank, True, pickle.dumps(out)))


def _failures(rank: int, trace: str, results, world_size: int) -> str:
    """The first failure and whatever the other ranks report within two
    seconds of it: the rank that raised first is not always the one whose
    error arrives first (its peers see their connection drop)."""
    failed = {rank: trace}
    end = time.monotonic() + 2.0
    while time.monotonic() < end:
        try:
            r, ok, value = results.get(timeout=0.2)
        except queue.Empty:
            continue
        if not ok:
            failed[r] = value
    return "\n".join(f"rank {r} of {world_size} raised:\n{t}" for r, t in sorted(failed.items()))


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), *, backend: str = "gloo",
              timeout: float = 600.0) -> List[Any]:
    """``fn(rank, world_size, *args)`` in each of ``world_size`` new processes
    joined into one process group over ``backend``; returns the results in
    rank order. Raises ``RuntimeError`` with the rank's traceback when a rank
    raises or dies, ``TimeoutError`` when the ranks are not all done within
    ``timeout`` seconds."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    root = tempfile.mkdtemp(prefix="omt_ranks_")
    procs = [ctx.Process(target=_rank_main, name=f"omt-rank-{rank}",
                         args=(fn, rank, world_size, os.path.join(root, "store"), backend,
                               timeout, tuple(args), results))
             for rank in range(world_size)]
    deadline = time.monotonic() + timeout
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} of "
                                   f"{world_size} not done within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:  # a rank that ended without a result: killed, or died in native code
                    time.sleep(1.0)  # a result it queued just before it ended may still be in flight
                    if results.empty():
                        raise RuntimeError(f"rank {dead[0]} of {world_size} ended with exit code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                continue
            if not ok:
                raise RuntimeError(_failures(rank, value, results, world_size))
            out[rank] = pickle.loads(value)  # bytes a rank of this run wrote
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        results.close()
        shutil.rmtree(root, ignore_errors=True)
