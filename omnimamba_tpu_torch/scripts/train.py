"""Training from the command line, on one card or across cards. Counterpart
of ``scripts/train.py``: the same config surface (stages align / finetune, the
t2i and mmu flows side by side, the mesh flags), the port's ``Trainer``
underneath.

    python -m omnimamba_tpu_torch.scripts.train --synthetic-data --max-steps 3
    python -m omnimamba_tpu_torch.scripts.train --config config/config_stage2.yaml \\
        [--batch-t2i 48] [--batch-mmu 3] [--grad-accum 1] [--device cuda]
    torchrun --nproc-per-node 8 -m omnimamba_tpu_torch.scripts.train --dp 8 ...
    torchrun --nproc-per-node 8 -m omnimamba_tpu_torch.scripts.train --fsdp 8 ...
    torchrun --nproc-per-node 8 -m omnimamba_tpu_torch.scripts.train --tp 2 --fsdp 2 ...

Without ``--config`` the config is ``TrainConfig()``, the values of
``config/config_stage2.yaml`` (reading a YAML needs PyYAML). With
``--synthetic-data`` (or where the configured COCO file is missing) the t2i
flow reads a synthetic pretokenized JSONL, and the mmu flow reads synthetic
instruction rows whose images are ``.npy`` files (reading other image files
needs PIL). The t2i flow reads through the native reader (``data/native.py``,
built with g++ at first use). A run writes ``metrics.jsonl`` and checkpoints
under ``<output_dir>/<model>_<time>/``; ``--tensorboard`` adds TensorBoard
scalars under ``tb/`` and ``--wandb`` a wandb run (each warns and drops its
metrics where its package is missing).

Under ``torchrun`` each process is one rank on ``cuda:LOCAL_RANK`` (NCCL;
gloo with ``--device cpu``) of the mesh ``--dp`` x ``--fsdp`` x ``--tp``
(``--dp 0``, the default, takes the ranks the other axes leave; without
flags a non-trivial ``mesh_shape`` of the config wins, else every rank is
dp). ``--tp N`` cuts every Mamba-2 mixer over its heads (N must divide them)
and ``project_in`` and the projector as JAX's rules do. The batch sizes are
the global batch's: each dp x fsdp rank reads and collates only its own
rows, and the tp ranks of one such rank read the same rows. Rank 0 names the
run, writes the synthetic data, prints the mesh, and writes the metrics and
the checkpoints. Without torchrun and without mesh flags the run is the
one-card run.
"""

from __future__ import annotations

import argparse
import itertools
import os
from datetime import datetime
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train OmniMamba (the PyTorch port) on one card, "
                                "or across cards under torchrun.")
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
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard scalars to <run>/tb")
    p.add_argument("--wandb", action="store_true", help="also log to wandb where it is installed")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (one rank a card, NCCL) or cpu (gloo across ranks)")
    p.add_argument("--dp", type=int, default=0, help="data-parallel ranks; 0: the ranks left over")
    p.add_argument("--fsdp", type=int, default=1, help="ranks the parameters are cut over")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks over the Mamba-2 heads (must divide them)")
    return p.parse_args(argv)


def mesh_shape(args, cfg) -> dict:
    """The mesh the flags ask for: ``--dp`` where given, ``--fsdp`` and
    ``--tp`` above 1; without flags a non-trivial ``cfg.mesh_shape``, else
    {} (every rank on dp)."""
    shape = {}
    if args.dp:
        shape["dp"] = args.dp
    if args.fsdp > 1:
        shape["fsdp"] = args.fsdp
    if args.tp > 1:
        shape["tp"] = args.tp
    if not shape:
        shape = {k: v for k, v in dict(cfg.mesh_shape or {}).items() if v > 1}
    return shape


def build_loaders(cfg, uni, out_dir: str, synthetic: bool,
                  shard: Optional[Tuple[int, int]] = None, rank: int = 0):
    """{"t2i_flow": ..., "mmu_flow": ...} for the tasks the config runs; with
    ``shard`` (rank index, ranks) each loader gives this rank's rows. Rank 0
    writes the synthetic files, the others wait for them."""
    from omnimamba_tpu_torch.data.coco import make_synthetic_coco_jsonl
    from omnimamba_tpu_torch.data.llava import get_dataset_and_collator, make_synthetic_llava_json
    from omnimamba_tpu_torch.data.loader import DataLoader
    from omnimamba_tpu_torch.data.native import NativeCocoDataset, NativeCocoLoader

    say = print if rank == 0 else (lambda *a, **k: None)
    coco = ann = None
    if cfg.t2i_task:
        coco = cfg.dataset
        if synthetic or not os.path.exists(coco):
            coco = os.path.join(out_dir, "synthetic_coco.jsonl")
            if rank == 0:
                make_synthetic_coco_jsonl(coco, n=max(cfg.batch_size_t2i * 4, 64))
            say(f"[data] synthetic t2i jsonl at {coco}")
    if cfg.mmu_task and synthetic:
        ann = os.path.join(out_dir, "synthetic_llava.json")
        if rank == 0:
            make_synthetic_llava_json(ann, n=max(cfg.batch_size_mmu * 4, 16),
                                      image_shape=(480, 640))
        say(f"[data] synthetic mmu json at {ann}")
    if dist.is_initialized():
        dist.barrier()  # the files rank 0 wrote are in place

    loaders = {}
    if cfg.t2i_task:
        loaders["t2i_flow"] = NativeCocoLoader(NativeCocoDataset(coco, uni), cfg.batch_size_t2i,
                                               shard=shard)
        say("[data] t2i via the native mmap reader (csrc/omnidata.cpp)")
    if cfg.mmu_task:
        ds, collator = get_dataset_and_collator(
            cfg.stage, uni.text_tokenizer, eot_id=uni.sptids_dict["<|eot|>"], max_length=449,
            annotation_json=ann, image_dir=os.path.dirname(ann) if ann else None)
        loaders["mmu_flow"] = DataLoader(ds, cfg.batch_size_mmu, collator,
                                         num_threads=cfg.num_workers, shard=shard)
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
    from omnimamba_tpu_torch.config import TrainConfig, check_mesh_shape
    from omnimamba_tpu_torch.data.loader import CombinedLoader
    from omnimamba_tpu_torch.factory import build_model
    from omnimamba_tpu_torch.parallel import (
        batch_sharding, create_mesh, init_distributed, shard_params)
    from omnimamba_tpu_torch.train.trainer import (
        MetricsWriter, MultiWriter, TensorBoardWriter, Trainer, WandbWriter)
    from omnimamba_tpu_torch.utils.checkpoint import CheckpointManager
    from omnimamba_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
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

    shape = mesh_shape(args, cfg)
    check_mesh_shape(shape)
    mesh, rank, shard = None, 0, None
    if "RANK" in os.environ or dist.is_initialized():  # under torchrun (or a launcher's group)
        info = init_distributed(args.device)
        device, rank = info.device, info.rank
        mesh = create_mesh(shape, device.type)
        shard = batch_sharding(mesh)
        if rank == 0:
            sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            print(f"[mesh] {sizes} over {info.world_size} ranks ({dist.get_backend()})")
    elif any(v > 1 for v in shape.values()):
        raise ValueError(f"the mesh {shape} needs that many ranks: start the run under torchrun")
    else:
        device = resolve_device(args.device)
    say = print if rank == 0 else (lambda *a, **k: None)

    names = [f"{cfg.omnimamba_model}_{datetime.now().strftime('%Y-%m-%d_%H-%M-%S-%f')}"]
    if mesh is not None:
        dist.broadcast_object_list(names, src=0)  # rank 0 names the run
    out_dir = os.path.join(cfg.output_dir, names[0])
    os.makedirs(out_dir, exist_ok=True)

    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    model, params, uni = build_model(cfg, dtype=dtype, device=device)
    if mesh is not None:
        params = shard_params(mesh, params)
    combined = CombinedLoader(build_loaders(cfg, uni, out_dir, args.synthetic_data, shard, rank))
    eval_loader = None
    if cfg.eval_steps:
        eval_loader = _EvalSample(combined)
        say(f"[eval] every {cfg.eval_steps} steps on {eval_loader.n} training batches "
            "(no eval split configured)")
    metrics = MetricsWriter(os.path.join(out_dir, "metrics.jsonl"))
    if args.tensorboard or args.wandb:
        metrics = MultiWriter(
            metrics,
            TensorBoardWriter(os.path.join(out_dir, "tb")) if args.tensorboard else None,
            WandbWriter(run_name=os.path.basename(out_dir)) if args.wandb else None)
    trainer = Trainer(model, params, cfg, combined, mesh=mesh, dtype=dtype,
                      checkpoint_manager=CheckpointManager(os.path.join(out_dir, "ckpts"),
                                                           cfg.save_total_limit),
                      metrics_writer=metrics, eval_loader=eval_loader, device=device)
    resume_step = 0
    if cfg.resume_dir:
        previous = CheckpointManager(os.path.join(cfg.resume_dir, "ckpts"))
        if previous.latest_step() is not None:
            trainer.state = previous.restore(trainer.state, None, trainer.generator)
            resume_step = trainer.state.step
            say(f"[resume] from {cfg.resume_dir} step {resume_step}")
    try:
        return trainer.train(resume_step=resume_step)
    finally:
        metrics.close()


if __name__ == "__main__":
    main()
