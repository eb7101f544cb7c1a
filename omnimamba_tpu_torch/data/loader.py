"""Host-side loading: shuffled batches with background prefetch, and the
loader that pairs the two task flows. Counterpart of
``omnimamba_tpu/data/loader.py``.

``DataLoader`` shuffles with ``np.random.default_rng(seed + epoch)``, drops
the last partial batch by default and collates ``prefetch`` batches ahead in
daemon threads. ``CombinedLoader`` is lightning's ``max_size_cycle``: an
epoch is as long as the longest loader, the shorter ones start again when
they run out.

A prefetching iterator that ends early (a ``break``, ``close()``, or its
last reference dropped) tells its threads to stop and does not wait for
them: a thread still collating finishes that batch and exits, and being a
daemon it never holds the process open.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List

import numpy as np


class _Slot:
    """One batch in flight: its indices, then its value or error."""

    def __init__(self, indices: np.ndarray):
        self.indices = indices
        self.done = threading.Event()
        self.value = None
        self.error = None


class DataLoader:
    """Epochs of ``batch_size`` items of ``dataset`` through ``collate_fn``."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_threads: int = 8,
        prefetch: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

    def _fetch(self, indices: np.ndarray):
        return self.collate_fn([self.dataset[int(i)] for i in indices])

    def __iter__(self) -> Iterator:
        batches = self._batch_indices()
        self.epoch += 1
        n_threads = min(self.num_threads, self.prefetch, len(batches))
        if n_threads <= 0:
            for b in batches:
                yield self._fetch(b)
            return
        tasks: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        def work():
            while True:
                slot = tasks.get()
                if slot is None:
                    return
                if not stop.is_set():
                    try:
                        slot.value = self._fetch(slot.indices)
                    except BaseException as e:  # noqa: BLE001 - raised again by the consumer
                        slot.error = e
                slot.done.set()

        for _ in range(n_threads):
            threading.Thread(target=work, daemon=True, name="omt-loader").start()
        pending = [_Slot(b) for b in batches]
        ahead = min(self.prefetch, len(pending))
        for slot in pending[:ahead]:
            tasks.put(slot)
        try:
            for i, slot in enumerate(pending):
                if i + ahead < len(pending):
                    tasks.put(pending[i + ahead])
                slot.done.wait()
                if slot.error is not None:
                    raise slot.error
                value, slot.value = slot.value, None
                yield value
        finally:
            stop.set()
            for _ in range(n_threads):
                tasks.put(None)


class CombinedLoader:
    """``max_size_cycle`` over named loaders: batches {name: batch}, as many
    as the longest loader has; a shorter loader starts a new epoch when it
    runs out."""

    def __init__(self, iterables: Dict[str, DataLoader]):
        self.iterables = {k: v for k, v in iterables.items() if v is not None}
        if not self.iterables:
            raise ValueError("CombinedLoader needs at least one loader")

    def __len__(self) -> int:
        return max(len(v) for v in self.iterables.values())

    def __iter__(self):
        iters = {k: iter(v) for k, v in self.iterables.items()}
        try:
            for _ in range(len(self)):
                batch = {}
                for k, v in self.iterables.items():
                    try:
                        batch[k] = next(iters[k])
                    except StopIteration:
                        iters[k] = iter(v)
                        batch[k] = next(iters[k])
                yield batch
        finally:
            for it in iters.values():
                close = getattr(it, "close", None)
                if close is not None:
                    close()
