"""The training step and the loop around it, on one card or over the ranks of
a (dp, fsdp, tp) mesh.

Counterpart of ``omnimamba_tpu/train/trainer.py``. A step computes
``loss = loss_t2i + loss_mmu`` over one combined batch, differentiates the
trainable leaves (frozen leaves carry ``requires_grad=False``, so autograd
never builds their backward), clips to a global norm of 1.0, applies AdamW
and reports both per-task losses.

With a ``mesh`` (``parallel/mesh.create_mesh``), each rank runs the step on
its own rows of the global batch (``parallel/sharding.shard_batch``; the
loader hands each rank only its rows) and the step is the global batch's:

- each flow's loss on a rank is its rows' sum over the count of labelled
  positions on every rank, so the shares of the ranks sum to the global
  mean, rows with unequal label counts included;
- under fsdp the leaves are slices (``shard_params``): the model gathers a
  leaf where it uses it and autograd reduce-scatters its gradient; the dp
  ranks then sum the slices' gradients, and every rank sums the gradients
  of leaves kept whole;
- the gradient norm is the global one (the slices' squares summed over
  fsdp), and clipping and AdamW run on each rank's slices;
- metrics are the global batch's, identical on every rank; only rank 0 logs
  and writes metrics and checkpoints;
- under tp (``parallel/tensor.py``) the tp ranks of a dp x fsdp coordinate
  take the same rows and the same dropout draws, and each runs its heads:
  its tp slices' gradients are its own, and the leaves and parts that each
  rank uses for its own heads only (in_proj's bc and dt columns, the LoRA
  factors' like them, the conv's bc channels, the LoRA A factors, dt_bias,
  A_log, D, fc1's bias: ``TpCut.partial_ranges``) are summed over tp; sums
  over the batch go over the dp x fsdp ranks only, and the norm counts each
  cut part once and each replicated part once.

What differs from the JAX trainer:

- nothing is jitted; no ``donate``: the step updates in place;
- there is no ``scan_impl``: a CUDA tensor takes the kernels (forward and
  backward), a CPU tensor their plain versions;
- a ``torch.Generator`` takes the place of the PRNG key (LoRA dropout);
- the parameters and the AdamW state are updated **in place**; a step
  returns a ``TrainState`` holding the same objects and ``step + 1``;
- ``remat="proj"`` climbs a ladder of checkpoint policies by the tokens of
  the t2i flow (``resolve_remat``; rungs measured on the card, not the JAX
  trainer's); the mmu flow takes ``cfg.remat_mmu`` (None: every block
  checkpointed; a policy's name as the t2i flow);
- an mmu flow's ``pixel_values`` may be raw uint8 (B, H, W, 3): the step
  moves them to the device and applies the towers' transform there.

Metric sinks: ``MetricsWriter`` (JSONL), ``TensorBoardWriter``,
``WandbWriter`` and ``MultiWriter``, as in the JAX trainer; across ranks only
rank 0 writes.
"""

from __future__ import annotations

import json
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from omnimamba_tpu_torch.config import TrainConfig
from omnimamba_tpu_torch.data.transforms import dinosiglip_transform
from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel, mmu_loss, t2i_loss
from omnimamba_tpu_torch.ops.remat import check_remat
from omnimamba_tpu_torch.parallel.mesh import AXES, axis_size
from omnimamba_tpu_torch.parallel.sharding import (
    all_reduce_flat,
    batch_sharding,
    rank_seed,
    shard_of,
    tp_of,
)
from omnimamba_tpu_torch.train.optimizer import make_optimizer, make_schedule, named_leaves
from omnimamba_tpu_torch.utils.device import resolve_device
from omnimamba_tpu_torch.utils.logging import Overwatch

# remat="proj": the rung of checkpointing a step of this many tokens takes,
# the first whose limit lies above them; from the last limit on every block is
# checkpointed and nothing else kept (True). Measured on an NVIDIA H100 80GB
# HBM3 (700 W) at 1.3B in bf16, stage 1 (align), by chip_smoke.py's phases
# remat_policies and remat_threshold (PERF.md section 6): a token keeps 9.65 MB
# without checkpointing, 2.48 under "dots", 1.66 under "proj", 1.27 under
# "proj_xbd" and 0.84 under True, on top of what the trainer holds (3.6 GiB);
# each limit is where the rung's peak would reach 85% of the card's 79.2 GiB.
# At its largest batch each rung's forward and backward beat the next rung's
# in every run (B=21: 0.36 s against 0.49-0.55; B=82-84: 1.71-1.76 against
# 1.75-1.80; B=123-125: 2.61-2.66 against 2.65-2.70; B=161-164: 3.45-3.53
# against 3.51-3.59), and B=90 (29,520 tokens) takes "proj": 1.92-1.94 s
# against 1.99-2.03 under True. "proj_ssd" and "proj_conv_ssd" keep K1's fp32
# chunk states (8.41 and 8.80 MB a token) and fit 400-700 tokens more than no
# checkpointing, at the card's limit: beside "dots" there, "proj_ssd" took
# 0.53-0.64 s against 0.53-0.54 and "proj_conv_ssd" 0.44-1.31 against 0.51-0.52
# (the allocator reshuffling near the limit); neither is a rung. A step that
# holds more (stage 2's AdamW state over the backbone, the towers) has less
# room.
REMAT_LADDER = ((False, 7000), ("dots", 27500), ("proj", 41200), ("proj_xbd", 54000))


class TrainState(NamedTuple):
    params: Any
    opt_state: Any  # the torch optimizer; it holds the moments of the trainable leaves
    step: int


def create_train_state(params, cfg: TrainConfig, stage: Optional[str] = None):
    """(state, tx): marks the leaves of ``params`` trainable or frozen for
    the stage and builds the optimizer over the trainable ones."""
    tx, _schedule, _tmask = make_optimizer(params, cfg, stage)
    return TrainState(params=params, opt_state=tx, step=0), tx


def resolve_remat(remat, tokens: int):
    """The config's ``remat`` for a step of ``tokens`` tokens: ``"proj"``
    climbs ``REMAT_LADDER``; True, False and the other policies' names stand
    as they are."""
    if remat == "proj":
        for rung, limit in REMAT_LADDER:
            if tokens < limit:
                return rung
        return True
    return check_remat(remat)


def _trainable(params) -> List[torch.Tensor]:
    return [leaf for _, leaf in named_leaves(params) if leaf.requires_grad]


def _tree_to(batch, device):
    if isinstance(batch, dict):
        return {k: _tree_to(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch, device=device)


def prepare_batch(batch, model: OmniMambaModel, device: torch.device, stacked: bool = False):
    """The batch on ``device``; an mmu flow's raw uint8 ``pixel_values`` (B, H,
    W, 3), or (accum, B, H, W, 3) when ``stacked``, become the towers' inputs
    ``{"dino", "siglip"}`` there (``data/transforms.dinosiglip_transform``)."""
    batch = _tree_to(batch, device)
    mmu = batch.get("mmu_flow")
    if mmu is not None and not isinstance(mmu["pixel_values"], dict):
        raw = mmu["pixel_values"]
        if stacked:
            per = [dinosiglip_transform(r, model.vision_cfg) for r in raw]
            mmu["pixel_values"] = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        else:
            mmu["pixel_values"] = dinosiglip_transform(raw, model.vision_cfg)
    return batch


def check_train_mesh(mesh, nheads: Optional[int] = None) -> None:
    """Raise for a mesh the training step cannot run on: an extra axis of
    more than one rank, a mesh that leaves ranks of the process group out,
    or (given the model's ``nheads``) a tp that does not divide the heads."""
    if mesh is None:
        return
    tp = axis_size(mesh, "tp")
    if nheads is not None and nheads % tp:
        raise ValueError(f"tp={tp} does not divide the model's {nheads} heads")
    extra = {ax: axis_size(mesh, ax) for ax in mesh.mesh_dim_names
             if ax not in AXES and axis_size(mesh, ax) > 1}
    if extra:
        raise ValueError(f"a training mesh is dp x fsdp x tp; it has {extra} besides")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a training mesh covers every rank: {mesh.size()} of "
                         f"{dist.get_world_size()}")


def _data_sum(mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks that hold other rows of the batch:
    every rank without tp, else the dp x fsdp ranks of this tp coordinate
    (over dp, then over fsdp)."""
    if axis_size(mesh, "tp") == 1:
        return all_reduce_flat(tensors)
    for axis in ("dp", "fsdp"):
        if axis_size(mesh, axis) > 1:
            tensors = all_reduce_flat(tensors, mesh.get_group(axis))
    return list(tensors)


def _global_means(parts: Dict[str, tuple], mesh) -> Dict[str, torch.Tensor]:
    """{flow: (sum, count) of this rank's rows} -> {flow: sum / the count on
    every rank}: this rank's share of each flow's global mean (one
    ``all_reduce`` of the counts, in fp32: exact below 2^24 labelled positions)."""
    counts = torch.stack([count for _, count in parts.values()]).float()
    counts = _data_sum(mesh, [counts])[0]
    return {k: total / torch.clamp(c, min=1.0) for (k, (total, _)), c in zip(parts.items(), counts)}


def _sum_tp_partials(mesh, leaves: List[torch.Tensor], grads: List[torch.Tensor]):
    """The gradients with every part that each tp rank holds only its own
    heads' share of (``TpCut.partial_ranges``) summed over the tp ranks, in
    one bucketed all-reduce."""
    out = list(grads)
    where, pieces = [], []
    for i, leaf in enumerate(leaves):
        cut = tp_of(leaf)
        if cut is None or cut.size == 1:
            continue
        for dim, start, length in cut.partial_ranges():
            where.append((i, dim, start, length))
            pieces.append(out[i] if dim is None else out[i].narrow(dim, start, length))
    if not pieces:
        return out
    summed = all_reduce_flat(pieces, mesh.get_group("tp"))
    for (i, dim, start, length), total in zip(where, summed):
        if dim is None:
            out[i] = total
        else:
            if out[i] is grads[i]:
                out[i] = grads[i].clone()
            out[i].narrow(dim, start, length).copy_(total)
    return out


def _sync_gradients(mesh, leaves: List[torch.Tensor], grads: List[torch.Tensor]):
    """The global batch's gradients from this rank's: the parts each tp rank
    holds only its heads' share of are summed over tp; a slice's gradient was
    summed over fsdp by the gather's backward, so dp sums it; the gradient of
    a leaf kept whole is summed over the ranks that hold other rows."""
    out = _sum_tp_partials(mesh, leaves, grads)
    cut = [i for i, p in enumerate(leaves) if shard_of(p) is not None]
    kept = [i for i, p in enumerate(leaves) if shard_of(p) is None]
    if kept:
        for i, g in zip(kept, _data_sum(mesh, [out[i] for i in kept])):
            out[i] = g
    if cut and axis_size(mesh, "dp") > 1:
        for i, g in zip(cut, all_reduce_flat([out[i] for i in cut], mesh.get_group("dp"))):
            out[i] = g
    return out


def _global_norm(mesh, leaves: List[torch.Tensor], grads: List[torch.Tensor]) -> torch.Tensor:
    """fp32 norm of the global gradient, each square counted once whoever
    holds it. Four sums: (an fsdp slice or a leaf kept whole) x (a part tp
    cuts, distinct on each tp rank, or a part the same on each after
    ``_sum_tp_partials``); the slices' sums go over fsdp, the cut parts'
    over tp."""
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    sums = [zero, zero, zero, zero]  # fsdp slice x tp cut, slice x replicated, whole x cut, whole
    for leaf, g in zip(leaves, grads):
        sq = torch.square(g.float())
        cut, spec = tp_of(leaf), shard_of(leaf)
        base = 0 if spec is not None else 2
        if cut is None or cut.size == 1 or cut.dim is None:
            sums[base + 1] = sums[base + 1] + sq.sum()
        elif spec is not None and spec.dim == cut.dim:
            # fsdp cuts the tp slice along the tp dimension: it has no whole part
            sums[base] = sums[base] + sq.sum()
        else:
            parts = cut.local_segments()
            sums[base] = sums[base] + sum(
                (sq.narrow(cut.dim, s, n).sum() for s, n, is_cut in parts if is_cut), zero)
            sums[base + 1] = sums[base + 1] + sum(
                (sq.narrow(cut.dim, s, n).sum() for s, n, is_cut in parts if not is_cut), zero)
    if axis_size(mesh, "tp") > 1:
        sums[0], sums[2] = all_reduce_flat([torch.stack([sums[0], sums[2]])],
                                           mesh.get_group("tp"))[0]
    sliced, kept = sums[0] + sums[1], sums[2] + sums[3]
    if axis_size(mesh, "fsdp") > 1:
        sliced = all_reduce_flat([sliced], mesh.get_group("fsdp"))[0]
    return torch.sqrt(sliced + kept)


def clip_and_apply(state: TrainState, tx, schedule, grads: List[torch.Tensor],
                   gnorm: Optional[torch.Tensor] = None):
    """Clip ``grads`` (of the trainable leaves, in their order) to a global
    norm of 1.0, apply one AdamW update at the schedule's rate and return
    (new state, fp32 global norm before clipping). ``gnorm``: the norm where
    the caller has it (across ranks); else it is taken over ``grads``. No
    host synchronisation."""
    leaves = _trainable(state.params)
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.where(gnorm < 1.0, torch.ones_like(gnorm), 1.0 / gnorm)
    for leaf, g in zip(leaves, grads):
        leaf.grad = (g.float() * scale).to(leaf.dtype)
    lr = schedule(state.step)
    for group in tx.param_groups:
        group["lr"] = lr
    tx.step()
    tx.zero_grad(set_to_none=True)
    return TrainState(state.params, tx, state.step + 1), gnorm


def make_grad_fn(
    model: OmniMambaModel,
    cfg: TrainConfig,
    *,
    mesh=None,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
):
    """Returns grads(params, batch, generator) -> (loss, parts, grads, norm):
    a training step without its update. ``grads`` are the gradients of the
    trainable leaves of ``params``, in ``named_leaves`` order (zeros where a
    leaf takes no part), the global batch's: across ranks summed as
    ``make_train_step`` says, each a rank's slice under fsdp; ``norm`` is
    their fp32 global norm, ``loss`` and ``parts`` (``loss_t2i``,
    ``loss_mmu``) detached 0-dim tensors. Arguments as ``make_train_step``."""
    device = resolve_device(device)
    check_train_mesh(mesh, model.cfg.mixer.nheads)
    accum = max(int(cfg.grad_accum or 1), 1)
    # the mmu flow's rows are 1,182 tokens long: checkpoint every block of them
    # unless told otherwise
    remat_mmu = check_remat(True if cfg.remat_mmu is None else cfg.remat_mmu)
    reduction = "mean" if mesh is None else "sum_and_count"

    def loss_fn(params, batch, generator):
        parts = {}
        if cfg.t2i_task and "t2i_flow" in batch:
            flow = batch["t2i_flow"]
            b, n_cap = flow["caption_ids"].shape
            tokens = b * (n_cap + flow["inputs"].shape[1])  # this rank's rows of this flow
            parts["loss_t2i"] = t2i_loss(
                params, model, flow["inputs"], flow["caption_ids"], dtype=dtype,
                generator=generator, remat=resolve_remat(cfg.remat, tokens), reduction=reduction)
        if cfg.mmu_task and "mmu_flow" in batch:
            flow = batch["mmu_flow"]
            parts["loss_mmu"] = mmu_loss(
                params, model, flow["pixel_values"], flow["input_ids"], flow["labels"],
                flow["multimodal_mask"], dtype=dtype, generator=generator, remat=remat_mmu,
                reduction=reduction)
        if mesh is not None and parts:
            parts = _global_means(parts, mesh)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        loss_t2i, loss_mmu = parts.get("loss_t2i", zero), parts.get("loss_mmu", zero)
        return loss_t2i + loss_mmu, {"loss_t2i": loss_t2i, "loss_mmu": loss_mmu}

    def grad_fn(params, batch, generator: Optional[torch.Generator] = None):
        batch = prepare_batch(batch, model, device, stacked=accum > 1)
        leaves = _trainable(params)
        if accum == 1:
            loss, parts = loss_fn(params, batch, generator)
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            parts = {k: v.detach() for k, v in parts.items()}
        else:
            # one micro-batch of activations alive at a time; fp32 sums, since
            # a bf16 += would lose low bits across the micro-batches
            sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            seen: Dict[str, List[torch.Tensor]] = {"loss": [], "loss_t2i": [], "loss_mmu": []}
            for i in range(accum):
                micro = _index(batch, i)
                l, p = loss_fn(params, micro, generator)
                for s, g in zip(sums, torch.autograd.grad(l, leaves, allow_unused=True)):
                    if g is not None:
                        s += g.float()
                for k, v in {"loss": l, **p}.items():
                    seen[k].append(v.detach())
            grads = [(s / accum).to(p.dtype) for s, p in zip(sums, leaves)]
            means = {k: torch.stack(v).mean() for k, v in seen.items()}
            loss, parts = means.pop("loss"), means
        if mesh is None:
            return loss.detach(), parts, grads, torch.sqrt(
                sum(torch.sum(torch.square(g.float())) for g in grads))
        grads = _sync_gradients(mesh, leaves, grads)
        # each rank holds its share of each mean: their sum is the global batch's
        shares = _data_sum(mesh, [torch.stack([loss.detach(), parts["loss_t2i"],
                                               parts["loss_mmu"]])])[0]
        parts = {"loss_t2i": shares[1], "loss_mmu": shares[2]}
        return shares[0], parts, grads, _global_norm(mesh, leaves, grads)

    return grad_fn


def make_train_step(
    model: OmniMambaModel,
    tx,
    cfg: TrainConfig,
    *,
    mesh=None,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
):
    """Returns step(state, batch, generator) -> (state, metrics).

    With ``cfg.grad_accum > 1`` every batch leaf carries a leading (accum,)
    micro-batch axis (see ``accumulate_batches``); the step runs the
    micro-batches one after the other, accumulates their gradients in fp32
    and applies one update.

    batch = {
      "t2i_flow": {"inputs": (B, 256) int, "caption_ids": (B, 73) int},
      "mmu_flow": {"pixel_values": {"dino", "siglip"}: (B, H, W, 3) float, or raw
                   uint8 (B, H, W, 3), "input_ids": (B, T), "labels": (B, T),
                   "multimodal_mask": (B,) bool},
    }; either flow may be missing. ``loss = loss_t2i + loss_mmu``.
    With a ``mesh`` the batch holds this rank's rows (``shard_batch``), and the
    state's parameters are its slices under fsdp (``shard_params``); every
    rank of the mesh must call the step, with the same flows.
    ``generator`` draws the LoRA dropout masks, the t2i flow's first, then
    the mmu flow's; None means no dropout. The metrics are 0-dim tensors on
    the device (``loss``, ``grad_norm``, ``loss_t2i``, ``loss_mmu``), the
    global batch's."""
    grad_fn = make_grad_fn(model, cfg, mesh=mesh, dtype=dtype, device=device)
    schedule = make_schedule(cfg)

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        loss, parts, grads, gnorm = grad_fn(state.params, batch, generator)
        state, gnorm = clip_and_apply(state, tx, schedule, grads, gnorm)
        return state, {"loss": loss, "grad_norm": gnorm, **parts}

    return step


def _index(batch, i: int):
    if isinstance(batch, dict):
        return {k: _index(v, i) for k, v in batch.items()}
    return batch[i]


def accumulate_batches(loader, accum: int):
    """Group ``accum`` consecutive loader batches into one stacked batch (new
    leading micro-batch axis on every leaf); a trailing partial group is
    dropped. An epoch with fewer than ``accum`` batches would yield nothing
    and the training loop would spin for ever, so that raises."""
    import numpy as np

    if accum <= 1:
        yield from loader
        return

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return np.stack([np.asarray(n) for n in nodes])

    buf, yielded = [], 0
    for b in loader:
        buf.append(b)
        if len(buf) == accum:
            yield stack(*buf)
            yielded += 1
            buf = []
    if not yielded:
        raise ValueError(
            f"grad_accum={accum} exceeds the loader's batches per epoch "
            f"({len(buf)}): no optimizer step could ever run"
        )


def _rank_zero() -> bool:
    """Whether this process writes metrics: rank 0 of its process group (or
    of the launcher's ``RANK``), the only process of a one-card run."""
    return Overwatch.rank() == 0


class MetricsWriter:
    """JSONL metrics sink; on a rank other than 0 it opens nothing and drops
    every row."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", buffering=1) if _rank_zero() else None

    def log(self, step: int, metrics: dict):
        if self._fh is not None:
            self._fh.write(json.dumps({"step": step, **metrics}) + "\n")

    def close(self):
        if self._fh is not None:
            self._fh.close()


class TensorBoardWriter:
    """TensorBoard scalar sink through ``torch.utils.tensorboard`` (which
    needs the ``tensorboard`` package). Without it the writer warns once and
    drops every scalar; on a rank other than 0 it writes nothing."""

    def __init__(self, log_dir: str):
        self._w = None
        if not _rank_zero():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(log_dir=log_dir)
        except ImportError as e:
            warnings.warn(f"[metrics] tensorboard unavailable ({e}); scalars dropped",
                          RuntimeWarning, stacklevel=2)

    def log(self, step: int, metrics: dict):
        if self._w is None:
            return
        for k, v in metrics.items():
            try:
                self._w.add_scalar(k, float(v), step)
            except (TypeError, ValueError):  # a value that is not a scalar
                pass

    def close(self):
        if self._w is not None:
            self._w.close()


class WandbWriter:
    """wandb sink, where the ``wandb`` package is installed (its login and
    mode are the environment's). Without it the writer warns once and drops
    every metric; on a rank other than 0 it starts no run."""

    def __init__(self, project: str = "omnimamba-tpu", run_name: str = ""):
        self._wandb = None
        if not _rank_zero():
            return
        try:
            import wandb
        except ImportError as e:
            warnings.warn(f"[metrics] wandb unavailable ({e}); metrics dropped",
                          RuntimeWarning, stacklevel=2)
            return
        wandb.init(project=project, name=run_name or None)
        self._wandb = wandb

    def log(self, step: int, metrics: dict):
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def close(self):
        if self._wandb is not None:
            self._wandb.finish()


class MultiWriter:
    """Fan a metrics stream out to several sinks."""

    def __init__(self, *writers):
        self.writers = [w for w in writers if w is not None]

    def log(self, step: int, metrics: dict):
        for w in self.writers:
            w.log(step, metrics)

    def close(self):
        for w in self.writers:
            w.close()


class Trainer:
    """The training loop: max_steps, logging, checkpoint and eval cadence.

    With a ``mesh`` every rank of it runs a ``Trainer`` over its own loader,
    which hands it its own rows of each global batch (``DataLoader(shard=...)``
    or ``shard_batch``), and under fsdp over the slices of ``shard_params``.
    The dropout generator of the rank at row index r (``batch_sharding``: the
    tp ranks of a dp x fsdp coordinate share it) starts from
    ``rank_seed(cfg.seed, r)``.
    Only rank 0 calls ``log_fn`` and the metrics writer; a checkpoint is
    written by rank 0 with every rank taking part (``utils/checkpoint.py``)."""

    def __init__(
        self,
        model: OmniMambaModel,
        params,
        cfg: TrainConfig,
        combined_loader,
        *,
        mesh=None,
        dtype: torch.dtype = torch.bfloat16,
        checkpoint_manager=None,
        log_fn: Callable = print,
        metrics_writer=None,
        eval_loader=None,
        device="cuda",
    ):
        check_train_mesh(mesh, model.cfg.mixer.nheads)
        if axis_size(mesh, "fsdp") > 1 and not any(
                shard_of(t) is not None for _, t in named_leaves(params)):
            raise ValueError("under fsdp the trainer takes this rank's slices: "
                             "parallel.shard_params(mesh, params)")
        if axis_size(mesh, "tp") > 1 and not any(
                tp_of(t) is not None for _, t in named_leaves(params)):
            raise ValueError("under tp the trainer takes this rank's slices: "
                             "parallel.shard_params(mesh, params)")
        self.model = model
        self.cfg = cfg
        self.loader = combined_loader
        self.mesh = mesh
        self.rank = 0 if mesh is None else dist.get_rank()
        self.log_fn = log_fn if self.rank == 0 else (lambda *a, **k: None)
        self.checkpoint_manager = checkpoint_manager
        self.metrics_writer = metrics_writer if self.rank == 0 else None
        self.eval_loader = eval_loader
        self.dtype = dtype
        self.device = resolve_device(device)
        self.state, self.tx = create_train_state(params, cfg)
        self.step_fn = make_train_step(model, self.tx, cfg, mesh=mesh, dtype=dtype,
                                       device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.seed, batch_sharding(mesh)[0] if mesh is not None else 0))

    def train(self, resume_step: int = 0, max_steps: Optional[int] = None):
        """Run the loop from ``resume_step`` (a restored state carries its own
        step and generator state). On any exception an emergency checkpoint
        is written before it is raised again, on one card only: across ranks
        the save gathers from every rank, which a failing rank cannot count
        on."""
        try:
            return self._train_inner(resume_step, max_steps)
        except BaseException:
            if self.checkpoint_manager is not None and self.mesh is None:
                try:
                    self.checkpoint_manager.save(self.state.step, self.state, self.generator)
                    self.log_fn(f"[emergency] saved checkpoint at step {self.state.step}")
                except Exception as e:  # noqa: BLE001
                    self.log_fn(f"[emergency] checkpoint save failed: {e}")
            raise

    def _train_inner(self, resume_step, max_steps):
        max_steps = max_steps or self.cfg.max_steps
        step = resume_step
        t_last, step_last = time.time(), step
        metrics: Dict[str, torch.Tensor] = {}
        accum = max(int(self.cfg.grad_accum or 1), 1)
        while step < max_steps:
            for batch in accumulate_batches(self.loader, accum):
                if step >= max_steps:
                    break
                self.state, metrics = self.step_fn(self.state, batch, self.generator)
                step += 1
                if step % self.cfg.logging_steps == 0 or step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t_last
                    n_done = step - step_last
                    t_last, step_last = time.time(), step
                    self.log_fn(
                        f"step {step} loss {m['loss']:.4f} "
                        f"(t2i {m['loss_t2i']:.4f} mmu {m['loss_mmu']:.4f}) "
                        f"gnorm {m['grad_norm']:.3f} {n_done / max(dt, 1e-9):.2f} it/s"
                    )
                if self.metrics_writer is not None and step % self.cfg.logging_steps == 0:
                    self.metrics_writer.log(step, {k: float(v) for k, v in metrics.items()})
                if self.checkpoint_manager is not None and step % self.cfg.save_steps == 0:
                    self.checkpoint_manager.save(step, self.state, self.generator)
                if (self.eval_loader is not None and self.cfg.eval_steps
                        and step % self.cfg.eval_steps == 0):
                    self.evaluate()
        return self.state, metrics

    def restore(self, step: Optional[int] = None) -> int:
        """Load the latest (or the given) checkpoint into this trainer's
        parameters, optimizer and generator; returns the restored step, the
        ``resume_step`` to hand to ``train``."""
        if self.checkpoint_manager is None:
            raise ValueError("no checkpoint manager configured")
        self.state = self.checkpoint_manager.restore(self.state, step, self.generator)
        return self.state.step

    @torch.no_grad()
    def evaluate(self, metric_key_prefix: str = "eval"):
        """Average per-task losses over the eval loader. Eval batches are bare
        t2i dicts ({"inputs", "caption_ids"}) or flow-keyed dicts carrying
        "t2i_flow" and / or "mmu_flow" (the training batch schema); each
        present flow contributes its own averaged loss, without dropout. With
        a mesh each rank holds its rows of a batch and a batch's loss is the
        global batch's."""
        if self.eval_loader is None:
            raise ValueError("no eval loader configured")
        totals, counts = {"t2i": 0.0, "mmu": 0.0}, {"t2i": 0, "mmu": 0}
        params = self.state.params
        reduction = "mean" if self.mesh is None else "sum_and_count"

        def mean(loss):  # across ranks: the sum of the ranks' shares of the global mean
            if self.mesh is None:
                return float(loss)
            return float(_data_sum(self.mesh, [_global_means({"": loss}, self.mesh)[""]])[0])

        for batch in self.eval_loader:
            if "inputs" in batch:
                batch = {"t2i_flow": batch}
            batch = prepare_batch(batch, self.model, self.device)
            t2i = batch.get("t2i_flow")
            if t2i is not None:
                totals["t2i"] += mean(t2i_loss(params, self.model, t2i["inputs"],
                                               t2i["caption_ids"], dtype=self.dtype,
                                               reduction=reduction))
                counts["t2i"] += 1
            mmu = batch.get("mmu_flow")
            if mmu is not None:
                totals["mmu"] += mean(mmu_loss(
                    params, self.model, mmu["pixel_values"], mmu["input_ids"], mmu["labels"],
                    mmu["multimodal_mask"], dtype=self.dtype, reduction=reduction))
                counts["mmu"] += 1
        metrics = {f"{metric_key_prefix}_{task}_loss": totals[task] / counts[task]
                   for task in ("t2i", "mmu") if counts[task]}
        if counts["t2i"] and not counts["mmu"]:  # t2i-only loaders' key
            metrics[f"{metric_key_prefix}_loss"] = metrics[f"{metric_key_prefix}_t2i_loss"]
        self.log_fn(str(metrics))
        if self.metrics_writer is not None:
            self.metrics_writer.log(self.state.step, metrics)
        return metrics
