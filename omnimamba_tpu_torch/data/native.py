"""The native COCO reader: the port's counterpart of
``omnimamba_tpu/data/native.py``.

``csrc/omnidata.cpp`` (the port's copy of the C++ reader) mmaps the
pretokenized JSONL, indexes its lines with a threaded scan and fills int32
token batches and caption bytes straight into numpy buffers. It is built with
``g++`` at first use into ``omnimamba_tpu_torch/build/``
(``ops/kernel_build.build_host_library``) and loaded with ``ctypes``. A
failed build raises with the compiler's output: there is no quiet fall-back
to the Python dataset (use ``data/coco.MSCOCOFeatureDataset`` by choice).

``NativeCocoDataset`` gives the items of ``MSCOCOFeatureDataset`` in
training mode, a batch at a time: the row's 256 image ids and the 73-id
caption block of one of its captions, chosen by ``splitmix64(seed ^ row)``
in C++ (the Python dataset draws with ``random.Random``). The caption is the
row's raw JSON bytes: a caption with escapes reaches the tokenizer escaped,
as in the JAX reader.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from omnimamba_tpu_torch.data.coco import CaptionBlock
from omnimamba_tpu_torch.data.loader import own_rows
from omnimamba_tpu_torch.ops import kernel_build


def _load_lib() -> ctypes.CDLL:
    lib = kernel_build.load_host_library("omnidata")
    lib.od_open.argtypes = [ctypes.c_char_p]
    lib.od_open.restype = ctypes.c_void_p
    lib.od_num_rows.argtypes = [ctypes.c_void_p]
    lib.od_num_rows.restype = ctypes.c_int64
    lib.od_fill_t2i_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64,
    ]
    lib.od_fill_t2i_batch.restype = ctypes.c_int
    lib.od_close.argtypes = [ctypes.c_void_p]
    lib.od_close.restype = None
    return lib


class NativeCocoReader:
    """mmap-backed random-access reader over the pretokenized JSONL."""

    CAP_STRIDE = 1024  # bytes a caption may take (longer ones are cut)

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._h = self._lib.od_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)

    def __len__(self) -> int:
        return int(self._lib.od_num_rows(self._h))

    def read_batch(self, indices: np.ndarray, num_tokens: int = 256,
                   seed: int = 0) -> Tuple[np.ndarray, List[str]]:
        """(tokens (n, num_tokens) int32, one caption a row)."""
        idx = np.ascontiguousarray(indices, np.int64)
        n = len(idx)
        tokens = np.empty((n, num_tokens), np.int32)
        caps = np.zeros(n * self.CAP_STRIDE, np.uint8)
        lens = np.empty(n, np.int32)
        rc = self._lib.od_fill_t2i_batch(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, num_tokens,
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            caps.ctypes.data_as(ctypes.c_char_p), self.CAP_STRIDE,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), seed & 0xFFFFFFFFFFFFFFFF)
        if rc != 0:
            raise ValueError(f"parse error at batch row {-rc - 1}")
        captions = [caps[i * self.CAP_STRIDE: i * self.CAP_STRIDE + lens[i]].tobytes()
                    .decode("utf-8", errors="replace") for i in range(n)]
        return tokens, captions

    def close(self):
        if self._h:
            self._lib.od_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - the interpreter may be shutting down
            pass


class NativeCocoDataset:
    """``MSCOCOFeatureDataset``'s training items a batch at a time, through
    the native reader and the host tokenizer of the chosen caption."""

    def __init__(self, path: str, uni_prompting, seed: int = 0, num_tokens: int = 256):
        self.reader = NativeCocoReader(path)
        self.caption_block = CaptionBlock(uni_prompting)
        self.seed = seed
        self.num_tokens = num_tokens

    def __len__(self) -> int:
        return len(self.reader)

    def read_batch(self, indices: np.ndarray, epoch: int = 0):
        """{"inputs": (n, num_tokens) int64, "caption_ids": (n, 73) int64}."""
        tokens, captions = self.reader.read_batch(
            indices, num_tokens=self.num_tokens, seed=self.seed + epoch * 0x9E3779B9)
        blocks = np.stack([self.caption_block(c) for c in captions])
        return {"inputs": tokens.astype(np.int64), "caption_ids": blocks}


class NativeCocoLoader:
    """Epoch iterator over a ``NativeCocoDataset``: each epoch a new order
    (``default_rng(seed + epoch).permutation``), full batches only, each
    filled by one C++ call. Takes the place of ``data/loader.DataLoader`` in
    the t2i flow; ``shard`` as there (this rank's rows of each batch)."""

    def __init__(self, dataset: NativeCocoDataset, batch_size: int, seed: int = 0,
                 shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shard = shard
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        n = len(self)
        idx = np.random.default_rng(self.seed + self.epoch).permutation(len(self.dataset))
        epoch = self.epoch
        self.epoch += 1
        for b in range(n):
            rows = own_rows(idx[b * self.batch_size:(b + 1) * self.batch_size], self.shard)
            yield self.dataset.read_batch(rows, epoch=epoch)
