"""Selective checkpoint policies: which named intermediates of a block a
checkpointed block keeps for its backward.

Counterpart of the policy table of ``omnimamba_tpu/models/backbone.py``
(``jax.checkpoint`` with ``save_only_these_names``) and of the
``checkpoint_name`` calls of ``omnimamba_tpu/models/mamba2.py`` and
``omnimamba_tpu/ops/ssd_pallas_bwd.py``.

A checkpointed block (``models/backbone._checkpointed``) runs under
``torch.utils.checkpoint`` (non-reentrant) with a ``BlockTape`` that holds
the policy's names. Each named intermediate comes out of one
``torch.autograd.Function`` whose forward calls ``kept(names, compute)``: in
the block's first forward ``compute()`` runs and the tape keeps its output
where the policy names it; in the backward's second forward ``kept`` hands
that output back instead of running ``compute()``, and the Function's own
backward needs only its inputs, which the second forward gives again. The
named intermediates:

- ``in_proj_z_out``, ``in_proj_out``: the products of the z columns and of
  the x | bc | dt columns of in_proj (``kept_product``);
- ``conv_out``: the conv + SiLU of x (``ops/conv.causal_conv1d_train``);
  where a policy keeps it, bc is convolved apart (``conv_bc_out``, which no
  policy keeps), elsewhere x | bc in one call (the conv is per channel: the
  same bits either way);
- ``ssd_out`` and ``ssd_resid``: K1's y and its chunk-entry states, kept
  together (``ops/ssd_kernel._SSDFunction``): the backward feeds K5 the kept
  states, and K1 does not launch again;
- ``lora_a_out``, ``lora_b_out``, ``out_proj_out``: the block's other 2-D
  products, which only ``"dots"`` keeps.

The JAX names cover the sums with the LoRA branch; the port keeps the
products and runs the rank-r LoRA terms again (a product over r columns and
an add), which keeps the same bytes. ``"dots"`` keeps every 2-D product of
the block, what ``dots_with_no_batch_dims_saveable`` keeps.
"""

from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from typing import Callable, Tuple

import torch

DOTS = ("in_proj_z_out", "in_proj_out", "lora_a_out", "lora_b_out", "out_proj_out")
# the names each policy keeps: JAX backbone.py's table, and "dots"
POLICIES = {
    "proj": ("in_proj_out", "in_proj_z_out"),
    "proj_xbd": ("in_proj_out",),
    "proj_ssd": ("in_proj_out", "ssd_out", "ssd_resid"),
    "proj_conv_ssd": ("in_proj_out", "conv_out", "ssd_out", "ssd_resid"),
    "dots": DOTS,
}


def check_remat(remat):
    """``remat`` as True (checkpoint the whole block), False (keep every
    activation) or a policy's name (checkpoint the block, keep what the
    policy names); anything else raises."""
    if remat is True or remat is False or remat in POLICIES:
        return remat
    raise ValueError(f"remat={remat!r}: expected True, False or one of {sorted(POLICIES)}")


class BlockTape:
    """What one checkpointed block keeps: the outputs of its named
    intermediates from the first forward, handed back in the same order in
    the second (each once: the tape lets go of it there)."""

    def __init__(self, remat):
        self.names = frozenset(() if remat is True else POLICIES[remat])
        self.kept = {}
        self.replaying = False
        self.calls = defaultdict(int)


_active = threading.local()


@contextlib.contextmanager
def running(tape: BlockTape, replaying: bool):
    """The block's forward runs inside: its first (``replaying=False``) or
    the backward's second."""
    outer = getattr(_active, "tape", None)
    _active.tape, tape.replaying, tape.calls = tape, replaying, defaultdict(int)
    try:
        yield
    finally:
        _active.tape = outer


class _Recorder(threading.local):
    log = None  # a list while record_kept() is active


_recorder = _Recorder()


@contextlib.contextmanager
def record_kept():
    """Collects (names, shapes) of every output a tape keeps while inside:
    what checkpointed blocks hold for their backward."""
    _recorder.log = []
    try:
        yield _recorder.log
    finally:
        _recorder.log = None


def _detached(out):
    if isinstance(out, tuple):
        return tuple(t.detach() for t in out)
    return out.detach()


def keeps(name: str) -> bool:
    """Whether the checkpointed block running here keeps ``name``."""
    tape = getattr(_active, "tape", None)
    return tape is not None and name in tape.names


def kept(names: Tuple[str, ...], compute: Callable):
    """``compute()``, or the output a checkpointed block kept for ``names``
    in its first forward. Called from the forward of the Function that
    computes the named intermediate (autograd does not record there); the
    result is a fresh alias of the kept tensors."""
    tape = getattr(_active, "tape", None)
    if tape is None or tape.names.isdisjoint(names):
        return compute()
    key = (names, tape.calls[names])
    tape.calls[names] += 1
    if tape.replaying:
        return _detached(tape.kept.pop(key))
    out = compute()
    tape.kept[key] = _detached(out)
    if _recorder.log is not None:
        shapes = [tuple(t.shape) for t in (out if isinstance(out, tuple) else (out,))]
        _recorder.log.append((names, shapes))
    return out


class _Product(torch.autograd.Function):
    """``x @ w`` as a named intermediate."""

    @staticmethod
    def forward(ctx, x, w, names):
        ctx.save_for_backward(x, w)
        return kept(names, lambda: x @ w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw, None


def kept_product(names: Tuple[str, ...], x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (x (..., K), w (K, N)) that a checkpoint policy naming any
    of ``names`` keeps."""
    return _Product.apply(x, w, names)
