"""Optimizer, schedule and stage-dependent freezing.

Counterpart of ``omnimamba_tpu/train/optimizer.py``:

- AdamW with betas (0.9, 0.95), eps 1e-8, weight decay 0 by default;
- decay only on parameters of rank >= 2 inside the ``mamba`` subtree;
- four schedules: ``cosine_with_min_lr`` (linear warmup, cosine from the peak
  to ``min_lr_rate`` of it), ``linear``, ``constant_with_warmup``,
  ``constant``;
- stage freezing:
    align:     vision and the backbone core frozen; t2i trains
               img_embeddings / embedding / pos_embed / caption_embed (the
               tied image head with them) and the LoRA factors; mmu trains
               the projector and the LoRA factors
    finetune:  vision and vq frozen; the whole backbone and the projector train
    inference: everything frozen
- gradients are clipped to a global norm of 1.0 over the trainable leaves.

Paths are the port's: the layers are a list (``mamba/layers/3/mixer/...``),
in_proj and the LoRA B factors are stored fused, so a leaf's rank is its
logical rank (the JAX package subtracts the stacked layer axis). A frozen
leaf gets ``requires_grad=False`` and no optimizer state. The update itself
is ``torch.optim.AdamW``: the JAX package computes it in no kernel of its own.
Under fsdp each rank's AdamW holds the moments of its own slices
(``parallel/sharding.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from omnimamba_tpu_torch.config import TrainConfig
from omnimamba_tpu_torch.parallel.sharding import logical_shape
from omnimamba_tpu_torch.utils.tree import named_leaves  # noqa: F401 - imported from here too


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """step (number of updates already made) -> learning rate."""
    peak, warmup, total = cfg.lr, cfg.warmup_steps, cfg.max_steps
    min_lr = peak * cfg.min_lr_rate

    def warm(step):  # linear 0 -> peak over max(warmup, 1) steps
        return peak * min(step / max(warmup, 1), 1.0)

    if cfg.scheduler == "constant":
        return lambda step: peak
    if cfg.scheduler == "constant_with_warmup":
        return lambda step: warm(step) if step < warmup else peak
    if cfg.scheduler == "linear":
        def linear(step):
            if step < warmup:
                return warm(step)
            return peak * (1.0 - min((step - warmup) / max(total - warmup, 1), 1.0))
        return linear

    def cosine(step):  # cosine_with_min_lr
        step = min(step, total)
        if step < warmup:
            return peak * step / warmup
        progress = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return min_lr + 0.5 * (peak - min_lr) * (1.0 + math.cos(math.pi * progress))

    return cosine


def _trains(path: str, stage: str, cfg: TrainConfig) -> bool:
    if path.startswith("vision") or path.startswith("vq"):
        return False  # frozen in every stage
    if stage == "inference":
        return False
    if stage == "finetune":
        return True
    if stage == "align":
        if "lora" in path:
            return bool(cfg.t2i_task or cfg.mmu_task)
        if path.startswith("projector"):
            return bool(cfg.mmu_task)
        return bool(
            cfg.t2i_task
            and any(s in path for s in ("img_embeddings", "caption_embed", "pos_embed", "embedding"))
            and "mmu_pos_embed" not in path
        )
    raise ValueError(f"unknown stage {stage}")


def trainable_mask(params: Dict, stage: str, cfg: TrainConfig) -> Dict[str, bool]:
    """path -> True where the parameter trains in this stage."""
    return {path: _trains(path, stage, cfg) for path, _ in named_leaves(params)}


def decay_mask(params: Dict) -> Dict[str, bool]:
    """path -> True where weight decay applies: rank >= 2 inside ``mamba``.
    The rank is the whole leaf's, also for an fsdp slice
    (``parallel/sharding.logical_shape``)."""
    return {path: path.startswith("mamba") and len(logical_shape(leaf)) >= 2
            for path, leaf in named_leaves(params)}


def make_optimizer(params: Dict, cfg: TrainConfig, stage: Optional[str] = None):
    """Marks the leaves of ``params`` as trainable or frozen for the stage and
    returns (AdamW over the trainable leaves, schedule, trainable mask). The
    optimizer has two groups, with and without weight decay; the caller sets
    their learning rate from the schedule before every update."""
    stage = stage or cfg.stage
    schedule = make_schedule(cfg)
    tmask = trainable_mask(params, stage, cfg)
    dmask = decay_mask(params)
    groups: Dict[bool, List[torch.Tensor]] = {True: [], False: []}
    for path, leaf in named_leaves(params):
        leaf.requires_grad_(tmask[path])
        if tmask[path]:
            groups[dmask[path]].append(leaf)
    tx = torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": cfg.decay},
         {"params": groups[False], "weight_decay": 0.0}],
        lr=schedule(0), betas=(cfg.beta1, cfg.beta2), eps=1e-8,
    )
    return tx, schedule, tmask
