"""The collectives of head-parallel tp inside the model, which GSPMD inserts
in JAX (``omnimamba_tpu/parallel/sharding.py:1-17``), as autograd Functions.

A Mamba-2 mixer under tp runs on its rank's heads: the replicated stream
enters the cut region (``tp_enter``: identity forward, the input gradient
summed over the tp ranks backward, since each rank's in_proj gives only its
columns' share of it), the gated RMSNorm sums its rows' partial sums over
the ranks (``tp_all_reduce``, inside ``ops/norms_kernel.py``), and the
row-parallel out_proj's partial products are summed back into the
replicated stream (``row_parallel``: the rank's rows' product with an fp32
result, all-reduced and rounded once forward; one card's product backward).
``project_in`` and the projector do the same around fc1 / fc2.

Every rank of a tp group computes the same replicated values, so where a
sampled token leaves the model (``generate``, ``speculative_generate``) the
group's first rank's token is taken by all (``tp_same_tokens``): a stream
never forks across ranks.

The tp group comes from the leaves (``parallel/sharding.tp_of``): model code
asks ``tp_cut(leaf)`` and gets None on one card, where everything here is
the identity and costs nothing. Each collective counts its calls and bytes
in ``sharding.COLLECTIVES`` (``tp_all_reduce``, ``tp_all_gather``,
``tp_broadcast``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from omnimamba_tpu_torch.parallel.sharding import TpCut, count_collective, tp_of


def tp_cut(leaf) -> Optional[TpCut]:
    """The tp cut of a leaf of a cut region (its group, size and this rank's
    index), or None where tp does not cut it (one card)."""
    cut = tp_of(leaf)
    return cut if cut is not None and cut.size > 1 else None


def mixer_tp(mixer_params) -> Optional[TpCut]:
    """The tp cut a Mamba-2 mixer runs under, read from its gated norm's weight."""
    return tp_cut(mixer_params["norm"]["weight"])


def backbone_tp(params) -> Optional[TpCut]:
    """The tp cut of a backbone's mixers (None on one card)."""
    return mixer_tp(params["layers"][0]["mixer"])


def tp_heads(mixer_params, nheads: int) -> Tuple[Optional[TpCut], int, int]:
    """(the mixer's tp cut or None, this rank's first head, its number of
    heads) of a mixer of ``nheads`` heads."""
    cut = mixer_tp(mixer_params)
    if cut is None:
        return None, 0, nheads
    count = nheads // cut.size
    return cut, cut.index * count, count


def tp_all_reduce(t: torch.Tensor, cut: TpCut) -> torch.Tensor:
    """The sum of ``t`` over the tp ranks of ``cut`` (a new tensor)."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=cut.group)
    count_collective("tp_all_reduce", out)
    return out


def tp_all_gather(t: torch.Tensor, cut: TpCut, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every tp rank's ``t`` stacked in rank order, (size, *t.shape): one
    ``all_gather_into_tensor``, into ``out`` (contiguous, of that many
    elements) where given."""
    t = t.contiguous()
    flat = (t.new_empty((cut.size * t.shape[0], *t.shape[1:])) if out is None
            else out.view(cut.size * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(flat, t, group=cut.group)
    count_collective("tp_all_gather", flat)
    return flat.view(cut.size, *t.shape)


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp ranks backward."""

    @staticmethod
    def forward(ctx, x, cut):
        ctx.cut = cut
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tp_all_reduce(g, ctx.cut), None


def _partial(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` with an fp32 result: a dense bf16 or fp16 weight on the
    card in its own type (cuBLAS's product with fp32 output, on the tensor
    cores), an int8 entry through ``qmatmul``, fp32 operands elsewhere."""
    from omnimamba_tpu_torch.ops.quant import matmul_any

    if (isinstance(w, torch.Tensor) and x.is_cuda and x.dtype == w.dtype
            and x.dtype in (torch.bfloat16, torch.float16)):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[-1])
    return matmul_any(x, w, out_dtype=torch.float32)


class _Partial(torch.autograd.Function):
    """The rank's partial product with an fp32 result, a named intermediate
    (``ops/remat.kept``); backward one card's product's in x's type (the
    cotangent of the rounded sum is a value of that type), the rank's rows
    giving whole gradients."""

    @staticmethod
    def forward(ctx, x, w, names):
        from omnimamba_tpu_torch.ops.remat import kept

        ctx.save_for_backward(x, w)
        return kept(names, lambda: _partial(x, w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw, None


class _Reduce(torch.autograd.Function):
    """Sum over the tp ranks forward; identity backward. It saves nothing, so
    a checkpointed block's second forward stops at the product before it
    (torch's early stop) and the all-reduce runs once a block."""

    @staticmethod
    def forward(ctx, x, cut):
        return tp_all_reduce(x, cut)

    @staticmethod
    def backward(ctx, g):
        return g, None


def row_parallel(x: torch.Tensor, w, cut: TpCut, names: Tuple[str, ...] = ()) -> torch.Tensor:
    """``x @ w`` of a row-parallel layer (out_proj, fc2) whose ``w`` holds
    the rank's rows and ``x`` the matching columns: the replicated product
    in x's type, its fp32 partials summed over the tp ranks and rounded
    once, as one card's product rounds its fp32 sums once. ``names``: what a
    checkpoint policy keeps the partial as."""
    if torch.is_grad_enabled() and (x.requires_grad or (
            isinstance(w, torch.Tensor) and w.requires_grad)):
        return _Reduce.apply(_Partial.apply(x, w, names), cut).to(x.dtype)
    return tp_all_reduce(_partial(x, w), cut).to(x.dtype)


def tp_enter(x: torch.Tensor, cut: Optional[TpCut]) -> torch.Tensor:
    """Where the replicated stream ``x`` enters a cut region."""
    if cut is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Enter.apply(x, cut)


def tp_same_tokens(tokens: torch.Tensor, cut: Optional[TpCut]) -> torch.Tensor:
    """The tp group's first rank's ``tokens`` on every rank of the group: one
    all-reduce in which the other ranks add zeros (exact in integers)."""
    if cut is None:
        return tokens
    out = tokens if cut.index == 0 else torch.zeros_like(tokens)
    out = out.contiguous().clone()
    dist.all_reduce(out, group=cut.group)
    count_collective("tp_broadcast", out)
    return out


def kernel_leaf(entry) -> torch.Tensor:
    """The tensor that carries a kernel's cut: the kernel, or an int8 entry's q."""
    return entry["q"] if isinstance(entry, dict) else entry


def tp_linear_cols(p, x: torch.Tensor, cut: TpCut) -> torch.Tensor:
    """``x @ kernel + bias`` of a linear layer whose kernel holds this rank's
    columns (fc1 under tp): the whole bias, and an int8 kernel's whole
    scale, taken at those columns; a dense kernel in x's type. The product
    rounds to x's type before the bias is added, as one card's ``_linear``."""
    from omnimamba_tpu_torch.ops.quant import matmul_any

    kernel = p["kernel"]
    n = kernel_leaf(kernel).shape[-1]
    cols = slice(cut.index * n, (cut.index + 1) * n)
    if isinstance(kernel, dict):
        if kernel["scale"].shape[-1] != n:
            kernel = {"q": kernel["q"], "scale": kernel["scale"][..., cols]}
    else:
        kernel = kernel.to(x.dtype)
    return matmul_any(x, kernel) + p["bias"][cols].to(x.dtype)
