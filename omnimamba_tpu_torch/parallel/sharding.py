"""Parameters and batches over the (dp, fsdp, tp) mesh: counterpart of
``omnimamba_tpu/parallel/sharding.py``.

fsdp cuts every leaf into one slice a rank along one dimension (ZeRO-3: the
AdamW moments are made from the slices, so they are cut too). Where JAX's
rules give a leaf an fsdp axis and the port's layout has that axis, the
leaf is cut there; every other leaf along dimension 0. A leaf whose
dimension does not divide by the fsdp size stays whole on every rank, as
JAX replicates such a leaf. Gathering gives the whole leaf back bit for
bit, so the choice of dimension changes no number.

A slice is a plain tensor that its rank holds, tagged with a ``Shard`` (its
dimension, the whole shape, the fsdp group); it is not a DTensor, because
the kernels are ``ctypes`` calls that a DTensor cannot enter. Model code
calls ``whole(...)`` on the parameters it is about to use: a tagged slice
comes back whole through ``all_gather_into_tensor``, and the gradient of
that whole leaf goes back to the slice through ``reduce_scatter_tensor``
(summed over the fsdp ranks); an untagged tensor passes through untouched,
so one card pays a walk over a few dicts. The backbone gathers a block's
leaves inside the block, so a checkpointed block gathers them again in its
second forward and only one block's whole leaves are alive at a time.

Batches: each rank of the dp x fsdp ranks takes its own contiguous rows
(``shard_batch``); JAX shards rows over dp alone and lets the compiler
spread the work over fsdp, where a rank here would have to run every row.

The collectives count their calls and the bytes of the whole tensors they
handle in ``COLLECTIVES`` (``reset_collective_counts``), which
``chip_smoke.py`` holds against the count of what a step must move.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from omnimamba_tpu_torch.parallel.mesh import axis_rank, axis_size
from omnimamba_tpu_torch.utils.tree import map_named, named_leaves

# PyTorch 2.13 marks these two collectives deprecated (for *_single forms); both 2.13
# and the card's 2.11 take them (tools/collective_probe.py)
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor).*deprecated",
                        category=FutureWarning)

# JAX's rules (omnimamba_tpu/parallel/sharding.py:28-69) that give a leaf an fsdp axis, in
# the port's layout: the pattern, then the spec of the kernel the rule names, one entry a
# dimension. The port stores in_proj fused (d_model, z | x | bc | dt), the layers as a list
# and int8 entries as {"q", "scale"}: q keeps its kernel's spec, and a leaf of fewer
# dimensions than the spec (a 1-D scale) has no fsdp axis, as _spec_for gives it. First
# match wins; tp entries arrive with slice 6b. out_proj alone is cut along another
# dimension than 0, so each gather and reduce-scatter of it copies the leaf once more
# (``assemble`` / ``split_slices``); JAX's axis is kept because tp over heads (slice 6b)
# cuts out_proj's d_inner, dimension 0. The copy's cost: tools/collective_probe.py.
_RULES = (
    ("mixer/in_proj/kernel", ("fsdp", None)),  # JAX in_proj/{z,x,bc,dt}: P(None, "fsdp", ...)
    ("mixer/out_proj/kernel", (None, "fsdp")),  # JAX out_proj: P(None, "tp", "fsdp")
    ("mamba/embedding", ("fsdp", None)),
    ("img_embeddings/word_embeddings", ("fsdp", None)),
)


def jax_fsdp_dim(path: str, ndim: int) -> Optional[int]:
    """The dimension of the port's leaf at ``path`` that JAX's rules put on
    fsdp, or None where they keep the leaf whole there."""
    for pattern, spec in _RULES:
        if pattern in path:
            return None if len(spec) > ndim else spec.index("fsdp")
    return None


def fsdp_dim(path: str, shape: Tuple[int, ...], n: int) -> Optional[int]:
    """The dimension the leaf at ``path`` of ``shape`` is cut along over
    ``n`` fsdp ranks: JAX's where the port has it, else 0; None (whole on
    every rank) for one rank, a scalar, or a dimension that ``n`` does not
    divide."""
    if n == 1 or not shape:
        return None
    dim = jax_fsdp_dim(path, len(shape))
    dim = 0 if dim is None else dim
    return dim if shape[dim] % n == 0 else None


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """What a rank's slice of a leaf is: cut along ``dim`` into ``size``
    slices over ``group``, this one the ``index``-th, of a leaf of
    ``full_shape``."""

    dim: int
    size: int
    index: int
    full_shape: Tuple[int, ...]
    group: Any


_TAG = "_omt_shard"


def shard_of(t: torch.Tensor) -> Optional[Shard]:
    """The ``Shard`` of a slice made by ``shard_params``, None for a whole leaf."""
    return getattr(t, _TAG, None)


def logical_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the whole leaf that ``t`` is, or is a slice of."""
    spec = shard_of(t)
    return tuple(t.shape) if spec is None else spec.full_shape


def param_shardings(mesh, params) -> Dict[str, Optional[int]]:
    """path -> the dimension each leaf of ``params`` is cut along over the
    mesh's fsdp axis (None: whole on every rank)."""
    n = axis_size(mesh, "fsdp")
    return {path: fsdp_dim(path, tuple(t.shape), n) for path, t in named_leaves(params)}


def local_slice(full: torch.Tensor, spec: Shard) -> torch.Tensor:
    """This rank's slice of the whole leaf ``full`` (a view)."""
    step = spec.full_shape[spec.dim] // spec.size
    return full.narrow(spec.dim, spec.index * step, step)


def shard_params(mesh, params):
    """``params`` with every leaf that ``param_shardings`` cuts replaced by a
    new tensor holding this rank's slice (tagged, ``requires_grad`` kept);
    leaves kept whole are the same tensors. Without an fsdp axis the tree is
    returned as it is."""
    n = axis_size(mesh, "fsdp")
    if n == 1:
        return params
    group, index = mesh.get_group("fsdp"), axis_rank(mesh, "fsdp")

    def cut(path, t):
        dim = fsdp_dim(path, tuple(t.shape), n)
        if dim is None:
            return t
        spec = Shard(dim, n, index, tuple(t.shape), group)
        out = local_slice(t.detach(), spec).clone(memory_format=torch.contiguous_format)
        out.requires_grad_(t.requires_grad)
        setattr(out, _TAG, spec)
        return out

    return map_named(cut, params)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

COLLECTIVES = {name: {"calls": 0, "bytes": 0}
               for name in ("all_gather", "reduce_scatter", "all_reduce")}


def reset_collective_counts() -> None:
    for rec in COLLECTIVES.values():
        rec["calls"] = rec["bytes"] = 0


def _count(name: str, t: torch.Tensor) -> None:
    COLLECTIVES[name]["calls"] += 1
    COLLECTIVES[name]["bytes"] += t.numel() * t.element_size()


def all_gather_stacked(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order, (ranks, *t.shape): one
    ``all_gather_into_tensor`` over ``group`` (None: the default group)."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    # the output as the concatenation along dimension 0, the one form every backend takes
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    _count("all_gather", out)
    return out.view(n, *t.shape)


def assemble(stacked: torch.Tensor, spec: Shard) -> torch.Tensor:
    """The whole leaf from every rank's slice stacked in rank order,
    (size, *slice shape)."""
    if spec.dim == 0:
        return stacked.reshape(spec.full_shape)
    return stacked.movedim(0, spec.dim).reshape(spec.full_shape)


def split_slices(full: torch.Tensor, spec: Shard) -> torch.Tensor:
    """Every rank's slice of the whole leaf ``full``, stacked in rank order
    (contiguous): the inverse of ``assemble``."""
    dim, n, shape = spec.dim, spec.size, tuple(full.shape)
    parts = full.reshape(*shape[:dim], n, shape[dim] // n, *shape[dim + 1:])
    return parts.movedim(dim, 0).contiguous()


def _all_gather(part: torch.Tensor, spec: Shard) -> torch.Tensor:
    """The whole leaf from every rank's slice (one ``all_gather_into_tensor``)."""
    return assemble(all_gather_stacked(part, spec.group), spec)


def _reduce_scatter(full: torch.Tensor, spec: Shard) -> torch.Tensor:
    """This rank's slice of the sum over the fsdp ranks of ``full``."""
    parts = split_slices(full, spec)  # (n, *slice shape)
    out = full.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out, parts.view(-1, *parts.shape[2:]), group=spec.group)
    _count("reduce_scatter", parts)
    return out


class _Gather(torch.autograd.Function):
    """Whole leaf forward, its gradient reduce-scattered back to the slice."""

    @staticmethod
    def forward(ctx, part, spec):
        ctx.spec = spec
        return _all_gather(part, spec)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.spec), None


def whole(node):
    """``node`` (a tensor, or a dict / list tree of them) with every slice
    made by ``shard_params`` gathered whole; differentiable, and the
    gradient of a gathered leaf is reduce-scattered to its slice. Whole
    leaves pass through as they are."""
    if isinstance(node, dict):
        return {k: whole(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(whole(v) for v in node)
    if isinstance(node, torch.Tensor):
        spec = shard_of(node)
        if spec is not None:
            return _Gather.apply(node, spec)
    return node


@torch.no_grad()
def whole_tensor(t: torch.Tensor, spec: Optional[Shard] = None) -> torch.Tensor:
    """The whole leaf of a slice (or ``t`` itself), outside autograd: for
    checkpoints and comparisons. ``spec``: how ``t`` is cut, where ``t`` is
    not itself tagged (an AdamW moment of a slice). Every rank of the
    slice's group must call it in the same order."""
    spec = spec if spec is not None else shard_of(t)
    return t.detach() if spec is None else _all_gather(t.detach(), spec)


# the most bytes all_reduce_flat packs into one call: its flat copy of the gradients
# stays this small beside them
BUCKET_BYTES = 2**28


def all_reduce_flat(tensors, group=None):
    """Sum each tensor over the ranks of ``group`` (None: the default group)
    with few ``all_reduce`` calls: tensors of one dtype are packed into flat
    buckets of up to ``BUCKET_BYTES`` (a larger tensor alone) and cut out
    again. Returns new tensors in the given order."""
    out = list(tensors)
    buckets: Dict[torch.dtype, list] = {}  # dtype -> [[indices, bytes], ...]
    for i, t in enumerate(out):
        open_ = buckets.setdefault(t.dtype, [[[], 0]])
        size = t.numel() * t.element_size()
        if open_[-1][0] and open_[-1][1] + size > BUCKET_BYTES:
            open_.append([[], 0])
        open_[-1][0].append(i)
        open_[-1][1] += size
    for idx in (b[0] for per_dtype in buckets.values() for b in per_dtype):
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        _count("all_reduce", flat)
        for i, piece in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = piece.view(out[i].shape)
    return out


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_sharding(mesh) -> Tuple[int, int]:
    """(this rank's index, number of ranks) among the dp x fsdp ranks that
    split a batch's rows: which rows ``shard_batch`` gives this rank."""
    fsdp = axis_size(mesh, "fsdp")
    return axis_rank(mesh, "dp") * fsdp + axis_rank(mesh, "fsdp"), axis_size(mesh, "dp") * fsdp


def shard_batch(mesh, batch, *, stacked: bool = False):
    """This rank's contiguous rows of a global batch (nested dicts of numpy
    arrays or tensors): the rows split over every dp x fsdp rank. With
    ``stacked=True`` (grad accumulation: a leading micro-batch axis on every
    leaf) the rows are axis 1. A leaf whose rows do not divide by the number
    of ranks raises, naming it: JAX keeps such a leaf whole on every rank,
    but a rank here computes only its own rows. Without a mesh the batch is
    returned as it is."""
    index, count = batch_sharding(mesh)
    if count == 1:
        return batch
    axis = 1 if stacked else 0

    def take(path, x):
        if isinstance(x, dict):
            return {k: take(f"{path}/{k}" if path else k, v) for k, v in x.items()}
        rows = x.shape[axis] if x.ndim > axis else 0
        if rows == 0 or rows % count:
            raise ValueError(f"batch leaf {path!r} of shape {tuple(x.shape)} has {rows} rows on "
                             f"axis {axis}: they do not split over {count} ranks")
        per = rows // count
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(index * per, (index + 1) * per)
        return x[tuple(sl)]

    return take("", batch)


def rank_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed of ``rank``: ``seed`` itself on rank 0, so
    a one-rank mesh draws what one card draws, another stream elsewhere."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2**63
