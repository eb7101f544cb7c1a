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

tp (head-parallel tensor parallelism, JAX's Megatron-style rules) cuts a
leaf first: each rank keeps the columns of its heads (``TpCut``). in_proj is
re-packed ``z_r | x_r | bc | dt`` (bc and dt whole, as JAX keeps them), and
so are its LoRA B factors and the int8 scales of its columns; the conv keeps
``x_r | bc``; the gated norm's weight and out_proj's rows keep ``d_inner /
tp``; ``project_in`` and the projector cut fc1 by columns and fc2's kernel by
rows. A few whole leaves are used by each rank for its own heads only (the
LoRA A factors, ``dt_bias``, ``A_log``, ``D``, fc1's bias): they carry a
``TpCut`` without a dimension, which tells the trainer that each rank holds
only its heads' share of their gradient (as it does for in_proj's bc and dt
columns). fsdp then cuts the rank's tp slice as it cuts a whole leaf. A leaf
carries up to two cuts: ``tp_of`` and ``shard_of``. The model reads the tp
group from its leaves (``parallel/tensor.py``), so nothing else changes its
signature.

Batches: each rank of the dp x fsdp ranks takes its own contiguous rows
(``shard_batch``); JAX shards rows over dp alone and lets the compiler
spread the work over fsdp, where a rank here would have to run every row.
The tp ranks of a dp x fsdp coordinate take the same rows.

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
# match wins. out_proj alone is cut along another dimension than 0, so each gather and
# reduce-scatter of it copies the leaf once more (``assemble`` / ``split_slices``); JAX's
# axis is kept because tp over heads cuts out_proj's d_inner, dimension 0. The copy's
# cost: tools/collective_probe.py.
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


# JAX's tp rules (omnimamba_tpu/parallel/sharding.py:28-69) in the port's layout: the
# pattern, the dimension cut over tp, and which parts of it are cut (by the mixer's
# widths, ``_tp_segments``). in_proj's int8 scales follow its columns (JAX's z and x
# scales on tp, bc's and dt's whole); out_proj's and project_in's scales stay whole.
# The LoRA B factors are packed as in_proj is (JAX keeps them whole and lets GSPMD slice
# them): a rank then holds one contiguous (r, z_r | x_r | bc | dt) factor, what K4 reads.
_TP_RULES = (
    ("mixer/in_proj/kernel/scale", 0, "in_proj"),
    ("mixer/out_proj/kernel/scale", None, None),
    ("mixer/in_proj/kernel", 1, "in_proj"),
    ("mixer/lora/t2i_B", 2, "in_proj"),
    ("mixer/lora/mmu_B", 2, "in_proj"),
    ("mixer/conv/weight", 1, "conv"),
    ("mixer/conv/bias", 0, "conv"),
    ("mixer/norm/weight", 0, "heads"),
    ("mixer/out_proj/kernel", 0, "heads"),
    ("img_embeddings/project_in/fc1/kernel/scale", None, None),
    ("img_embeddings/project_in/fc2/kernel/scale", None, None),
    ("img_embeddings/project_in/fc1/kernel", 1, "all"),
    ("img_embeddings/project_in/fc2/kernel", 0, "all"),
    ("projector/fc1/kernel", 1, "all"),
    ("projector/fc2/kernel", 0, "all"),
)
# whole leaves that each rank uses for its own heads (or fc1 columns) only: their
# gradient is a partial sum on each rank (path endings)
_TP_PARTIAL = ("mixer/lora/t2i_A", "mixer/lora/mmu_A", "mixer/dt_bias", "mixer/A_log", "mixer/D",
               "img_embeddings/project_in/fc1/bias", "projector/fc1/bias")


@dataclasses.dataclass(frozen=True, eq=False)
class TpCut:
    """What a rank's tp slice of a leaf is. Along ``dim`` the whole leaf of
    ``full_shape`` is a run of ``segments`` (start, length, cut): a cut
    segment is split into ``size`` equal parts over ``group``, this rank
    keeping the ``index``-th, and a whole segment is kept whole; the rank's
    slice is its parts in segment order. ``dim`` None: a whole leaf that the
    rank uses for its own heads only."""

    dim: Optional[int]
    size: int
    index: int
    segments: Tuple[Tuple[int, int, bool], ...]
    full_shape: Tuple[int, ...]
    group: Any

    def local_segments(self):
        """(start, length, cut) of each segment in the rank's slice."""
        out, at = [], 0
        for _, length, is_cut in self.segments:
            n = length // self.size if is_cut else length
            out.append((at, n, is_cut))
            at += n
        return out

    def partial_ranges(self):
        """(dim, start, length) of the rank's slice whose gradient each rank
        holds only its own heads' share of: the whole leaf (dim None), or the
        whole segments of a cut leaf."""
        if self.dim is None:
            return [(None, 0, 0)]
        return [(self.dim, s, n) for s, n, is_cut in self.local_segments() if not is_cut]


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """What a rank's fsdp slice of a leaf is: cut along ``dim`` into
    ``size`` slices over ``group``, this one the ``index``-th, of a leaf of
    ``full_shape`` (the rank's tp slice where tp cuts the leaf too)."""

    dim: int
    size: int
    index: int
    full_shape: Tuple[int, ...]
    group: Any


_TAG = "_omt_shard"
_TP_TAG = "_omt_tp"


def shard_of(t: torch.Tensor) -> Optional[Shard]:
    """The fsdp ``Shard`` of a slice made by ``shard_params``, None for a
    leaf that fsdp keeps whole."""
    return getattr(t, _TAG, None)


def tp_of(t) -> Optional[TpCut]:
    """The ``TpCut`` of a leaf made by ``shard_params`` (or of a leaf
    ``whole`` gathered over fsdp), None for a leaf that tp leaves alone."""
    return getattr(t, _TP_TAG, None)


def tag_tp(t: torch.Tensor, cut: Optional[TpCut]) -> torch.Tensor:
    """``t`` tagged as a leaf of tp cut ``cut`` (a derived leaf: an int8 entry
    made from a slice); returns ``t``."""
    setattr(t, _TP_TAG, cut)
    return t


def logical_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the whole leaf that ``t`` is, or is a slice of."""
    tp = tp_of(t)
    if tp is not None:
        return tp.full_shape
    spec = shard_of(t)
    return tuple(t.shape) if spec is None else spec.full_shape


def _mixer_widths(params) -> Optional[Tuple[int, int, int]]:
    """(d_inner, 2 G N, nheads) of the tree's Mamba-2 mixers, from the first
    one's leaves; None for a tree without one."""
    di = heads = width = None
    for path, t in named_leaves(params):
        if path.endswith("mixer/norm/weight"):
            di = t.shape[0]
        elif path.endswith("mixer/dt_bias"):
            heads = t.shape[0]
        elif path.endswith("mixer/in_proj/kernel") or path.endswith("mixer/in_proj/kernel/q"):
            width = t.shape[1]
        if di is not None and heads is not None and width is not None:
            return di, width - 2 * di - heads, heads
    return None


def _tp_segments(kind: str, length: int, widths) -> Tuple[Tuple[int, int, bool], ...]:
    """The (start, length, cut) parts of a dimension of ``length`` that a
    rule of ``kind`` cuts: all of it, or in_proj's z | x | bc dt, or the
    conv's x | bc."""
    if kind == "all" or kind == "heads":
        return ((0, length, True),)
    di, gn2, heads = widths
    if kind == "conv":
        return ((0, di, True), (di, gn2, False))
    return ((0, di, True), (di, di, True), (2 * di, gn2 + heads, False))  # in_proj


def tp_rule(path: str, ndim: int) -> Optional[Tuple[Optional[int], Optional[str]]]:
    """(dimension, kind) of the port's tp rule for the leaf at ``path``:
    (None, None) for a partial whole leaf, None for a leaf tp leaves alone."""
    for pattern, dim, kind in _TP_RULES:
        if pattern in path:
            return None if dim is None or dim >= ndim else (dim, kind)
    if path.endswith(_TP_PARTIAL):
        return (None, None)
    return None


def tp_cut_for(path: str, shape: Tuple[int, ...], n: int, index: int, group, widths):
    """The ``TpCut`` of the leaf at ``path`` of ``shape`` on rank ``index``
    of ``n`` tp ranks, or None. Raises where ``n`` does not divide a cut
    segment: the model's code runs on equal parts only."""
    rule = tp_rule(path, len(shape))
    if rule is None:
        return None
    dim, kind = rule
    if dim is None:
        return TpCut(None, n, index, (), tuple(shape), group)
    segments = _tp_segments(kind, shape[dim], widths)
    if sum(length for _, length, _ in segments) != shape[dim]:
        raise ValueError(f"{path}: {shape} does not match the mixer's widths {widths}")
    for _, length, is_cut in segments:
        if is_cut and length % n:
            raise ValueError(f"{path}: tp={n} does not divide a part of {length} of {shape}")
    return TpCut(dim, n, index, segments, tuple(shape), group)


def tp_local(full: torch.Tensor, cut: TpCut) -> torch.Tensor:
    """The rank's tp slice of the whole leaf ``full`` (a copy where it is
    more than one part, else a view)."""
    if cut.dim is None:
        return full
    parts = []
    for start, length, is_cut in cut.segments:
        if is_cut:
            step = length // cut.size
            parts.append(full.narrow(cut.dim, start + cut.index * step, step))
        else:
            parts.append(full.narrow(cut.dim, start, length))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=cut.dim)


def tp_assemble(stacked: torch.Tensor, cut: TpCut) -> torch.Tensor:
    """The whole leaf from every tp rank's slice stacked in rank order
    (size, *slice shape): the cut parts in rank order, the whole parts from
    rank 0."""
    dim = cut.dim + 1
    parts = []
    for start, length, is_cut in cut.local_segments():
        piece = stacked.narrow(dim, start, length)
        if is_cut:
            parts.extend(piece[r] for r in range(cut.size))
        else:
            parts.append(piece[0])
    return torch.cat(parts, dim=cut.dim).contiguous()


def param_shardings(mesh, params) -> Dict[str, Optional[int]]:
    """path -> the dimension each leaf of ``params`` is cut along over the
    mesh's fsdp axis (None: whole on every rank), on the rank's tp slice."""
    return {path: dims[1] for path, dims in param_cuts(mesh, params).items()}


def param_cuts(mesh, params) -> Dict[str, Tuple[Optional[TpCut], Optional[int]]]:
    """path -> (the leaf's ``TpCut`` on this rank or None, the dimension of
    its tp slice that fsdp cuts or None)."""
    n_tp, n_fsdp = axis_size(mesh, "tp"), axis_size(mesh, "fsdp")
    widths = _mixer_widths(params) if n_tp > 1 else None
    group = mesh.get_group("tp") if n_tp > 1 else None
    index = axis_rank(mesh, "tp")
    out = {}
    for path, t in named_leaves(params):
        cut = tp_cut_for(path, tuple(t.shape), n_tp, index, group, widths) if n_tp > 1 else None
        shape = list(t.shape)
        if cut is not None and cut.dim is not None:
            shape[cut.dim] = sum(n for _, n, _ in cut.local_segments())
        dim = fsdp_dim(path, tuple(shape), n_fsdp)
        if dim is not None and cut is not None and cut.dim == dim and cut.partial_ranges():
            dim = None  # fsdp and the whole parts of a tp cut never share a dimension
        out[path] = (cut, dim)
    return out


def local_slice(full: torch.Tensor, spec: Shard) -> torch.Tensor:
    """This rank's fsdp slice of ``full`` (a view)."""
    step = spec.full_shape[spec.dim] // spec.size
    return full.narrow(spec.dim, spec.index * step, step)


def local_part(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole leaf ``full`` for the live leaf
    ``like``: its tp slice, then its fsdp slice of that."""
    tp, spec = tp_of(like), shard_of(like)
    out = full if tp is None else tp_local(full, tp)
    return out if spec is None else local_slice(out, spec)


def shard_params(mesh, params):
    """``params`` with every leaf that the mesh's tp or fsdp axis cuts
    replaced by a new tensor holding this rank's slice (tagged,
    ``requires_grad`` kept); the partial whole leaves of tp are new tensors
    on the same storage, tagged; other leaves are the same tensors. Without
    a tp or fsdp axis the tree is returned as it is. int8 ``{q, scale}``
    entries are cut as their kernels are (quantize, then cut: the scales of
    a cut reduction need every row)."""
    if axis_size(mesh, "fsdp") == 1 and axis_size(mesh, "tp") == 1:
        return params
    cuts = param_cuts(mesh, params)
    n_fsdp, index = axis_size(mesh, "fsdp"), axis_rank(mesh, "fsdp")
    group = mesh.get_group("fsdp") if n_fsdp > 1 else None

    def cut(path, t):
        tp, dim = cuts[path]
        if tp is None and dim is None:
            return t
        out = t.detach()
        if tp is not None and tp.dim is not None:
            out = tp_local(out, tp)
        spec = None
        if dim is not None:
            spec = Shard(dim, n_fsdp, index, tuple(out.shape), group)
            out = local_slice(out, spec)
        if tuple(out.shape) != tuple(t.shape):  # a slice: storage of its own
            out = out.clone(memory_format=torch.contiguous_format)
        out.requires_grad_(t.requires_grad)
        if spec is not None:
            setattr(out, _TAG, spec)
        if tp is not None:
            setattr(out, _TP_TAG, tp)
        return out

    return map_named(cut, params)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# the tp collectives inside the model (parallel/tensor.py) count apart from the
# gathers of fsdp and the gradient sums of the trainer
COLLECTIVES = {name: {"calls": 0, "bytes": 0}
               for name in ("all_gather", "reduce_scatter", "all_reduce", "tp_all_reduce",
                            "tp_all_gather", "tp_broadcast")}


def reset_collective_counts() -> None:
    for rec in COLLECTIVES.values():
        rec["calls"] = rec["bytes"] = 0


def count_collective(name: str, t: torch.Tensor) -> None:
    """Count one call of collective ``name`` over the whole tensor ``t``."""
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
    count_collective("all_gather", out)
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
    count_collective("reduce_scatter", parts)
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
            out = _Gather.apply(node, spec)
            tp = tp_of(node)
            if tp is not None:  # the rank's tp slice: the model reads its group from it
                setattr(out, _TP_TAG, tp)
            return out
    return node


@torch.no_grad()
def whole_tensor(t: torch.Tensor, spec: Optional[Shard] = None,
                 tp: Optional[TpCut] = None) -> torch.Tensor:
    """The whole leaf of a slice (or ``t`` itself), outside autograd: for
    checkpoints and comparisons; gathered over fsdp, then over tp.
    ``spec`` and ``tp``: how ``t`` is cut, where ``t`` is not itself tagged
    (an AdamW moment or a gradient of a slice: ``whole_like``). Every rank
    of the slice's groups must call it in the same order."""
    spec = spec if spec is not None else shard_of(t)
    tp = tp if tp is not None else tp_of(t)
    out = t.detach() if spec is None else _all_gather(t.detach(), spec)
    if tp is not None and tp.dim is not None:
        out = tp_assemble(all_gather_stacked(out, tp.group), tp)
    return out


def whole_like(t: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``whole_tensor`` of ``t`` cut as the live ``leaf`` is (its gradient,
    an AdamW moment of it)."""
    return whole_tensor(t, shard_of(leaf), tp_of(leaf))


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
        count_collective("all_reduce", flat)
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
