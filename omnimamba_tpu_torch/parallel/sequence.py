"""Sequence parallelism for the SSM: a long prefill cut along its length over
the ranks of an ``sp`` axis. Counterpart of
``omnimamba_tpu/parallel/sequence.py``.

The linear recurrence passes states, not activations:

1. each rank scans its own slice from a zero state with K1 (``ssd_fused``);
2. every rank's (final state, total decay of its slice) is gathered, one
   ``all_gather_into_tensor`` of (B, H, P, N) + (B, H) fp32 a layer, and
   the state entering each rank is an exclusive prefix over the ranks;
3. each rank corrects its output in tensor code:
   y_t += exp(cumsum(dt A)_t) * (C_t . h_in).

The causal conv needs the previous rank's last ``W - 1`` positions
(``halo_left``): each rank's tail is gathered by every rank (a few KB a
layer) and rank 0 takes zeros. JAX sends it with ``ppermute``; an
all-gather is the collective that gloo also carries on CUDA tensors, where
a point-to-point ring would need ``send`` / ``recv`` pairs.

Inputs and outputs are this rank's slices along the length, contiguous and
in rank order; the model-level entry is ``models/backbone.backbone_forward_sp``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from omnimamba_tpu_torch.ops.ssd_kernel import ssd_fused
from omnimamba_tpu_torch.parallel.sharding import all_gather_stacked


def _local_correction(y_loc, dt, A, Cmat, h_in):
    """y_loc + exp(cumsum(dt A)) * (C . h_in), in fp32, back to y's type.
    y_loc (B, L, H, P), dt (B, L, H), A (H,), Cmat (B, L, G, N), h_in (B, H,
    P, N) fp32; head h reads group h // (H / G)."""
    B, L, H, P = y_loc.shape
    G, N = Cmat.shape[2], Cmat.shape[3]
    cums = torch.cumsum(dt.float() * A.float()[None, None, :], dim=1)  # inclusive (B, L, H)
    corr = torch.einsum("blgn,bgrpn->blgrp", Cmat.float(), h_in.reshape(B, G, H // G, P, N))
    corr = corr.reshape(B, L, H, P) * torch.exp(cums)[..., None]
    return (y_loc.float() + corr).to(y_loc.dtype)


def ssd_sp_local(
    xs: torch.Tensor,  # (B, Lloc, H, P) this rank's slice
    dts: torch.Tensor,  # (B, Lloc, H) softplus'ed
    A: torch.Tensor,  # (H,)
    Bs: torch.Tensor,  # (B, Lloc, G, N)
    Cs: torch.Tensor,  # (B, Lloc, G, N)
    D: Optional[torch.Tensor] = None,
    *,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """State-passing SSD over the ranks of ``group`` (None: the default
    group), each holding the next slice of the sequence. Returns (y of this
    slice in xs's type, the fp32 final state of the whole sequence, the same
    on every rank)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    y_loc, state_loc = ssd_fused(xs, dts, A, Bs, Cs, D)
    decay = torch.exp(torch.sum(dts.float() * A.float()[None, None, :], dim=1))  # (B, H)
    B, H, P, N = state_loc.shape
    packed = all_gather_stacked(torch.cat([state_loc.reshape(B, -1), decay], dim=1), group)
    states = packed[:, :, : H * P * N].reshape(n, B, H, P, N)
    decays = packed[:, :, H * P * N:]
    h = torch.zeros_like(state_loc)
    h_in = h
    for t in range(n):  # exclusive prefix over the ranks: n is small
        if t == idx:
            h_in = h
        h = h * decays[t][..., None, None] + states[t]
    return _local_correction(y_loc, dts, A, Cs, h_in), h


def halo_left(x: torch.Tensor, width: int, group=None) -> torch.Tensor:
    """The previous rank's last ``width`` positions of x (B, Lloc, C), zeros
    on the first rank: the left context of a causal conv whose sequence is
    cut over the ranks of ``group``. (B, width, C)."""
    if x.shape[1] < width:
        raise ValueError(f"a slice of {x.shape[1]} positions is shorter than the halo of {width}")
    tails = all_gather_stacked(x[:, x.shape[1] - width:, :], group)
    idx = dist.get_rank(group)
    return torch.zeros_like(tails[0]) if idx == 0 else tails[idx - 1]


def ssd_sequence_parallel(
    mesh,
    x: torch.Tensor,  # (B, Lloc, H, P) this rank's slice along L
    dt: torch.Tensor,  # (B, Lloc, H)
    A: torch.Tensor,  # (H,)
    Bmat: torch.Tensor,  # (B, Lloc, G, N)
    Cmat: torch.Tensor,  # (B, Lloc, G, N)
    D: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_sp_local`` over the ``sp`` ranks of ``mesh``: (y of this
    rank's slice, the final fp32 state, the same on every rank). JAX's
    function takes the whole arrays and returns y sharded; here each rank
    holds only its slice."""
    return ssd_sp_local(x, dt, A, Bmat, Cmat, D, group=mesh.get_group("sp"))
