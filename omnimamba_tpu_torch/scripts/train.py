"""Training from the command line, on one card. Counterpart of
``scripts/train.py``: the same config surface (stages align / finetune, the
t2i and mmu flows side by side), the port's ``Trainer`` underneath.

    python -m omnimamba_tpu_torch.scripts.train --synthetic-data --max-steps 3
    python -m omnimamba_tpu_torch.scripts.train --config config/config_stage2.yaml \\
        [--batch-t2i 48] [--batch-mmu 3] [--grad-accum 1] [--device cuda]

Without ``--config`` the config is ``TrainConfig()``, the values of
``config/config_stage2.yaml`` (reading a YAML needs PyYAML). With
``--synthetic-data`` (or where the configured COCO file is missing) the t2i
flow reads a synthetic pretokenized JSONL, and the mmu flow reads synthetic
instruction rows whose images are ``.npy`` files (reading other image files
needs PIL). A run writes ``metrics.jsonl`` and checkpoints under
``<output_dir>/<model>_<time>/``. There are no mesh flags: the port runs on
one card.
"""

from __future__ import annotations

import argparse
import itertools
import os
from datetime import datetime
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train OmniMamba (the PyTorch port) on one card.")
    p.add_argument("--config", type=str, default=None,
                   help="a YAML train config (needs PyYAML); default: TrainConfig(), the "
                   "stage-2 values")
    p.add_argument("--synthetic-data", action="store_true",
                   help="write schema-identical synthetic datasets and train on them")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--batch-t2i", type=int, default=None, help="override cfg.batch_size_t2i")
    p.add_argument("--batch-mmu", type=int, default=None, help="override cfg.batch_size_mmu")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="override cfg.grad_accum (micro-batches an optimizer step)")
    p.add_argument("--output-dir", type=str, default=None, help="override cfg.output_dir")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_loaders(cfg, uni, out_dir: str, synthetic: bool):
    """{"t2i_flow": ..., "mmu_flow": ...} for the tasks the config runs."""
    from omnimamba_tpu_torch.data.coco import (
        MSCOCOFeatureDataset, coco_collate, make_synthetic_coco_jsonl)
    from omnimamba_tpu_torch.data.llava import get_dataset_and_collator, make_synthetic_llava_json
    from omnimamba_tpu_torch.data.loader import DataLoader

    loaders = {}
    if cfg.t2i_task:
        path = cfg.dataset
        if synthetic or not os.path.exists(path):
            path = make_synthetic_coco_jsonl(os.path.join(out_dir, "synthetic_coco.jsonl"),
                                             n=max(cfg.batch_size_t2i * 4, 64))
            print(f"[data] synthetic t2i jsonl at {path}")
        loaders["t2i_flow"] = DataLoader(MSCOCOFeatureDataset(path, uni), cfg.batch_size_t2i,
                                         coco_collate, num_threads=cfg.num_workers)
    if cfg.mmu_task:
        ann = None
        if synthetic:
            ann = make_synthetic_llava_json(os.path.join(out_dir, "synthetic_llava.json"),
                                            n=max(cfg.batch_size_mmu * 4, 16),
                                            image_shape=(480, 640))
            print(f"[data] synthetic mmu json at {ann}")
        ds, collator = get_dataset_and_collator(
            cfg.stage, uni.text_tokenizer, eot_id=uni.sptids_dict["<|eot|>"], max_length=449,
            annotation_json=ann, image_dir=os.path.dirname(ann) if ann else None)
        loaders["mmu_flow"] = DataLoader(ds, cfg.batch_size_mmu, collator,
                                         num_threads=cfg.num_workers)
    return loaders


class _EvalSample:
    """The first ``n`` batches of a loader: the periodic evaluation's set
    where no eval split is configured."""

    def __init__(self, inner, n: int = 2):
        self.inner, self.n = inner, n

    def __iter__(self):
        return itertools.islice(iter(self.inner), self.n)


def main(argv: Optional[List[str]] = None):
    """Train as the arguments say; returns (state, last metrics)."""
    from omnimamba_tpu_torch.config import TrainConfig
    from omnimamba_tpu_torch.data.loader import CombinedLoader
    from omnimamba_tpu_torch.factory import build_model
    from omnimamba_tpu_torch.train.trainer import MetricsWriter, Trainer
    from omnimamba_tpu_torch.utils.checkpoint import CheckpointManager
    from omnimamba_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = TrainConfig.from_yaml(args.config) if args.config else TrainConfig()
    if args.max_steps:
        cfg.max_steps = args.max_steps
    if args.batch_t2i:
        cfg.batch_size_t2i = args.batch_t2i
    if args.batch_mmu:
        cfg.batch_size_mmu = args.batch_mmu
    if args.grad_accum:
        cfg.grad_accum = args.grad_accum
    if args.output_dir:
        cfg.output_dir = args.output_dir

    run_name = f"{cfg.omnimamba_model}_{datetime.now().strftime('%Y-%m-%d_%H-%M-%S-%f')}"
    out_dir = os.path.join(cfg.output_dir, run_name)
    os.makedirs(out_dir, exist_ok=True)

    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    model, params, uni = build_model(cfg, dtype=dtype, device=device)
    combined = CombinedLoader(build_loaders(cfg, uni, out_dir, args.synthetic_data))
    eval_loader = None
    if cfg.eval_steps:
        eval_loader = _EvalSample(combined)
        print(f"[eval] every {cfg.eval_steps} steps on {eval_loader.n} training batches "
              "(no eval split configured)")
    metrics = MetricsWriter(os.path.join(out_dir, "metrics.jsonl"))
    trainer = Trainer(model, params, cfg, combined, dtype=dtype,
                      checkpoint_manager=CheckpointManager(os.path.join(out_dir, "ckpts"),
                                                           cfg.save_total_limit),
                      metrics_writer=metrics, eval_loader=eval_loader, device=device)
    resume_step = 0
    if cfg.resume_dir:
        previous = CheckpointManager(os.path.join(cfg.resume_dir, "ckpts"))
        if previous.latest_step() is not None:
            trainer.state = previous.restore(trainer.state, None, trainer.generator)
            resume_step = trainer.state.step
            print(f"[resume] from {cfg.resume_dir} step {resume_step}")
    try:
        return trainer.train(resume_step=resume_step)
    finally:
        metrics.close()


if __name__ == "__main__":
    main()
