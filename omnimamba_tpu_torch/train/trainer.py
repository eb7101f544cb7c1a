"""The training step and the loop around it, on one card.

Counterpart of ``omnimamba_tpu/train/trainer.py``. A step computes
``loss = loss_t2i + loss_mmu`` over one combined batch, differentiates the
trainable leaves (frozen leaves carry ``requires_grad=False``, so autograd
never builds their backward), clips to a global norm of 1.0, applies AdamW
and reports both per-task losses.

What differs from the JAX trainer:

- nothing is jitted or sharded: no ``mesh``, ``shard_batch`` or ``donate``;
- there is no ``scan_impl``: a CUDA tensor takes the kernels (forward and
  backward), a CPU tensor their plain versions;
- a ``torch.Generator`` takes the place of the PRNG key (LoRA dropout);
- the parameters and the AdamW state are updated **in place**; a step
  returns a ``TrainState`` holding the same objects and ``step + 1``;
- ``remat="proj"`` chooses between checkpointing every block and keeping
  every activation from the tokens of a step (``resolve_remat``); the
  selective policies of the JAX package are refused until they are ported;
- ``mmu_loss`` is not ported yet, so a step takes t2i flows only.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from omnimamba_tpu_torch.config import TrainConfig
from omnimamba_tpu_torch.models.backbone import check_remat
from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel, mmu_loss, t2i_loss
from omnimamba_tpu_torch.train.optimizer import make_optimizer, make_schedule, named_leaves
from omnimamba_tpu_torch.utils.device import resolve_device

# remat="proj": checkpoint every block from this many tokens a step on.
# Measured on an NVIDIA H100 80GB HBM3 (700 W) at 1.3B in bf16 by chip_smoke.py,
# phase remat_threshold (PERF.md section 6 has the peaks): without
# checkpointing a step keeps 9.9 MB a token (6.3 MB of them the fp32 chunk
# states of the scan) on top of 3.7 GiB, so 6,399 tokens peak near 63 of the
# card's 79 GiB and run faster than with checkpointing (17% at 2,624 tokens,
# 21% at 5,248); from 6,400 on every block is checkpointed (0.84 MB a token).
REMAT_TOKENS = 6400


class TrainState(NamedTuple):
    params: Any
    opt_state: Any  # the torch optimizer; it holds the moments of the trainable leaves
    step: int


def create_train_state(params, cfg: TrainConfig, stage: Optional[str] = None):
    """(state, tx): marks the leaves of ``params`` trainable or frozen for
    the stage and builds the optimizer over the trainable ones."""
    tx, _schedule, _tmask = make_optimizer(params, cfg, stage)
    return TrainState(params=params, opt_state=tx, step=0), tx


def resolve_remat(remat, tokens: int) -> bool:
    """The config's ``remat`` as a bool for a step of ``tokens`` tokens."""
    if remat == "proj":
        return tokens >= REMAT_TOKENS
    return check_remat(remat)


def _trainable(params) -> List[torch.Tensor]:
    return [leaf for _, leaf in named_leaves(params) if leaf.requires_grad]


def _tree_to(batch, device):
    if isinstance(batch, dict):
        return {k: _tree_to(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch, device=device)


def clip_and_apply(state: TrainState, tx, schedule, grads: List[torch.Tensor]):
    """Clip ``grads`` (of the trainable leaves, in their order) to a global
    norm of 1.0, apply one AdamW update at the schedule's rate and return
    (new state, fp32 global norm before clipping). No host synchronisation."""
    leaves = _trainable(state.params)
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


def make_train_step(
    model: OmniMambaModel,
    tx,
    cfg: TrainConfig,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
):
    """Returns step(state, batch, generator) -> (state, metrics).

    With ``cfg.grad_accum > 1`` every batch leaf carries a leading (accum,)
    micro-batch axis (see ``accumulate_batches``); the step runs the
    micro-batches one after the other, accumulates their gradients in fp32
    and applies one update.

    batch = {"t2i_flow": {"inputs": (B, 256) int, "caption_ids": (B, 72) int}}.
    ``generator`` draws the LoRA dropout masks; None means no dropout. The
    metrics are 0-dim tensors on the device (``loss``, ``grad_norm``,
    ``loss_t2i``, ``loss_mmu``)."""
    device = resolve_device(device)
    schedule = make_schedule(cfg)
    accum = max(int(cfg.grad_accum or 1), 1)

    def loss_fn(params, batch, generator):
        zero = torch.zeros((), dtype=torch.float32, device=device)
        loss_t2i, loss_mmu = zero, zero
        if cfg.t2i_task and "t2i_flow" in batch:
            flow = batch["t2i_flow"]
            b, n_cap = flow["caption_ids"].shape
            tokens = b * (n_cap + flow["inputs"].shape[1])
            loss_t2i = t2i_loss(
                params, model, flow["inputs"], flow["caption_ids"], dtype=dtype,
                generator=generator, remat=resolve_remat(cfg.remat, tokens))
        if cfg.mmu_task and "mmu_flow" in batch:
            loss_mmu = mmu_loss()
        return loss_t2i + loss_mmu, {"loss_t2i": loss_t2i, "loss_mmu": loss_mmu}

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        batch = _tree_to(batch, device)
        leaves = _trainable(state.params)
        if accum == 1:
            loss, parts = loss_fn(state.params, batch, generator)
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
                l, p = loss_fn(state.params, micro, generator)
                for s, g in zip(sums, torch.autograd.grad(l, leaves, allow_unused=True)):
                    if g is not None:
                        s += g.float()
                for k, v in {"loss": l, **p}.items():
                    seen[k].append(v.detach())
            grads = [(s / accum).to(p.dtype) for s, p in zip(sums, leaves)]
            means = {k: torch.stack(v).mean() for k, v in seen.items()}
            loss, parts = means.pop("loss"), means
        state, gnorm = clip_and_apply(state, tx, schedule, grads)
        return state, {"loss": loss.detach(), "grad_norm": gnorm, **parts}

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


class MetricsWriter:
    """JSONL metrics sink."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", buffering=1)

    def log(self, step: int, metrics: dict):
        self._fh.write(json.dumps({"step": step, **metrics}) + "\n")

    def close(self):
        self._fh.close()


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
    """The training loop: max_steps, logging, checkpoint and eval cadence."""

    def __init__(
        self,
        model: OmniMambaModel,
        params,
        cfg: TrainConfig,
        combined_loader,
        *,
        dtype: torch.dtype = torch.bfloat16,
        checkpoint_manager=None,
        log_fn: Callable = print,
        metrics_writer=None,
        eval_loader=None,
        device="cuda",
    ):
        self.model = model
        self.cfg = cfg
        self.loader = combined_loader
        self.log_fn = log_fn
        self.checkpoint_manager = checkpoint_manager
        self.metrics_writer = metrics_writer
        self.eval_loader = eval_loader
        self.dtype = dtype
        self.device = resolve_device(device)
        self.state, self.tx = create_train_state(params, cfg)
        self.step_fn = make_train_step(model, self.tx, cfg, dtype=dtype, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

    def train(self, resume_step: int = 0, max_steps: Optional[int] = None):
        """Run the loop from ``resume_step`` (a restored state carries its own
        step and generator state). On any exception an emergency checkpoint
        is written before it is raised again."""
        try:
            return self._train_inner(resume_step, max_steps)
        except BaseException:
            if self.checkpoint_manager is not None:
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
        """Average t2i loss over the eval loader. Eval batches are bare t2i
        dicts ({"inputs", "caption_ids"}) or flow-keyed dicts carrying
        "t2i_flow"; an "mmu_flow" waits for ``mmu_loss``."""
        if self.eval_loader is None:
            raise ValueError("no eval loader configured")
        total, count = 0.0, 0
        for batch in self.eval_loader:
            if "mmu_flow" in batch:
                mmu_loss()
            t2i = batch.get("t2i_flow", batch if "inputs" in batch else None)
            if t2i is not None:
                t2i = _tree_to(t2i, self.device)
                total += float(t2i_loss(self.state.params, self.model, t2i["inputs"],
                                        t2i["caption_ids"], dtype=self.dtype))
                count += 1
        metrics = {}
        if count:
            metrics[f"{metric_key_prefix}_t2i_loss"] = total / count
            metrics[f"{metric_key_prefix}_loss"] = total / count  # t2i-only loaders' key
        self.log_fn(str(metrics))
        if self.metrics_writer is not None:
            self.metrics_writer.log(self.state.step, metrics)
        return metrics
