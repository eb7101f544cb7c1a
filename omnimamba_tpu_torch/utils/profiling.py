"""Tracing and timing: the port's counterpart of
``omnimamba_tpu/utils/profiling.py``.

- ``trace(log_dir)``: a ``torch.profiler`` context (the CPU, and the card's
  kernels where there is one) that writes a Chrome / Perfetto trace of
  everything inside to ``log_dir``;
- ``Timer`` / ``device_time``: the time of a block or a call, ending in a
  device synchronize and taken with CUDA events on the card (the host's
  clock for CPU work);
- ``bench_compiled``: seconds a call of a loop of calls queued back to back,
  CUDA events around the loop. Nothing is compiled: the name is the JAX
  function's.

``hard_sync`` has no counterpart: ``torch.cuda.synchronize`` returns when the
card is done.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch


def _device_of(tree) -> torch.device:
    """The device of the first tensor in ``tree`` (nested lists, tuples and
    dicts); the CPU where there is none."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            d = _device_of(t)
            if d.type != "cpu":
                return d
    return torch.device("cpu")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; the trace goes to ``log_dir`` as a
    ``*.pt.trace.json`` (TensorBoard's profile plugin or Perfetto read it)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class _Clock:
    """CUDA events on ``device`` when it is a card, the host's clock
    otherwise; ``stop()`` synchronizes and returns seconds since ``start()``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._b.record()
            self._b.synchronize()
            return self._a.elapsed_time(self._b) / 1e3
        return time.perf_counter() - self._t0


class Timer:
    """Phase timer: ``elapsed`` (seconds) of the block, from CUDA events on
    the current card when there is one (ending in a synchronize), else from
    the host's clock. ``log_fn`` gets "name: ms" at the end."""

    def __init__(self, name: str = "", log_fn: Optional[Callable] = None, device=None):
        self.name = name
        self.log_fn = log_fn
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self._clock = _Clock(torch.device(device))
        self.elapsed = 0.0

    def __enter__(self):
        if self._clock.cuda:
            torch.cuda.synchronize()  # the block's time only, not the work queued before it
        self._clock.start()
        return self

    def __exit__(self, *exc):
        self.elapsed = self._clock.stop()
        if self.log_fn:
            self.log_fn(f"{self.name}: {self.elapsed * 1e3:.1f} ms")
        return False


def device_time(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Best of ``iters`` timed calls of ``fn(*args)`` in seconds, each alone
    (synchronized before and after), after ``warmup`` calls; CUDA events
    where the arguments lie on a card."""
    clock = _Clock(_device_of(args))
    for _ in range(warmup):
        fn(*args)
    best = float("inf")
    for _ in range(iters):
        if clock.cuda:
            torch.cuda.synchronize()
        clock.start()
        fn(*args)
        best = min(best, clock.stop())
    return best


def bench_compiled(fn: Callable, *args, loops: int = 50) -> float:
    """Seconds a call: ``loops`` calls of ``fn(*args)`` queued back to back
    after one warm-up call, CUDA events around the loop where the arguments
    lie on a card, so a short kernel's launch cost is spread over the
    loop."""
    clock = _Clock(_device_of(args))
    fn(*args)
    if clock.cuda:
        torch.cuda.synchronize()
    clock.start()
    for _ in range(loops):
        fn(*args)
    return clock.stop() / loops
