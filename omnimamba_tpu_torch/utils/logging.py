"""Overwatch: a logger that speaks on rank 0 only. Counterpart of
``omnimamba_tpu/utils/logging.py``.

The rank and the world size come from ``torch.distributed`` once a process
group is initialised, else from the ``RANK`` / ``WORLD_SIZE`` variables a
launcher sets (0 and 1 without them). Rank 0 logs INFO and above, every other
rank ERROR only. The ``ctx_level`` argument prefixes a message with its
nesting marker, as the reference's overwatch does.
"""

from __future__ import annotations

import logging
import os
import sys

RICH_FORMAT = "| >> %(message)s"
DATEFMT = "%m/%d [%H:%M:%S]"
CTX_PREFIXES = {0: "[*] ", 1: "[=>] ", 2: "[->] ", 3: "[>] "}


class _ContextAdapter(logging.LoggerAdapter):
    def process(self, msg, kwargs):
        ctx_level = kwargs.pop("ctx_level", 0)
        return f"{CTX_PREFIXES.get(ctx_level, '')}{msg}", kwargs


def _distributed():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class Overwatch:
    """Rank-0 gated logger with the reference's ``ctx_level`` API."""

    def __init__(self, name: str):
        self.logger = _ContextAdapter(logging.getLogger(name), extra={})
        self.logger.logger.setLevel(logging.INFO if self.rank() == 0 else logging.ERROR)

    @staticmethod
    def rank() -> int:
        dist = _distributed()
        return dist.get_rank() if dist else int(os.environ.get("RANK", 0))

    @staticmethod
    def world_size() -> int:
        dist = _distributed()
        return dist.get_world_size() if dist else int(os.environ.get("WORLD_SIZE", 1))

    def is_rank_zero(self) -> bool:
        return self.rank() == 0

    def info(self, msg: str, ctx_level: int = 0):
        self.logger.info(msg, ctx_level=ctx_level)

    def warning(self, msg: str, ctx_level: int = 0):
        self.logger.warning(msg, ctx_level=ctx_level)

    def error(self, msg: str, ctx_level: int = 0):
        self.logger.error(msg, ctx_level=ctx_level)

    def debug(self, msg: str, ctx_level: int = 0):
        self.logger.debug(msg, ctx_level=ctx_level)


_INITIALIZED = False


def initialize_overwatch(name: str) -> Overwatch:
    """An ``Overwatch`` for ``name``; the first call sets up the root handler
    (rich's where the package is installed, else a plain stream to stdout)."""
    global _INITIALIZED
    if not _INITIALIZED:
        try:
            from rich.logging import RichHandler

            logging.basicConfig(level=logging.INFO, format=RICH_FORMAT, datefmt=DATEFMT,
                                handlers=[RichHandler(markup=True, rich_tracebacks=True)])
        except ImportError:
            logging.basicConfig(level=logging.INFO, format="%(asctime)s " + RICH_FORMAT,
                                datefmt=DATEFMT, stream=sys.stdout)
        _INITIALIZED = True
    return Overwatch(name)
