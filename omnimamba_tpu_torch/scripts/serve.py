"""Serving from the command line: batched text-to-image and image
understanding over HTTP. Counterpart of ``scripts/serve.py``.

    python -m omnimamba_tpu_torch.scripts.serve [--port 8000] [--t2i-batch 8] \\
        [--mmu-batch 8] [--ckpt DIR_OR_STEP.pt] [--int8] [--merge-lora-task t2i] \\
        [--continuous --slots 16 --chunk 16] [--device cuda]

Endpoints (``serve/server.py``):
    GET  /healthz
    POST /v1/t2i {"prompt": "..."}                           -> {"image_png_b64": ...}
    POST /v1/mmu {"image_png_b64": "...", "question": "..."} -> {"text": ...}

Without ``--ckpt`` the weights are random, made from ``--seed``. A task's
LoRA is merged before the int8 quantization. ``--config`` reads a YAML
train config (needs PyYAML); the default is the 1.3B model with both
384-px towers.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Serve OmniMamba (the PyTorch port) over HTTP.")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--config", default=None,
                   help="a YAML train config (needs PyYAML); default: the 1.3B model")
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint of the port (step_<n>.pt or its directory) or a .pth")
    p.add_argument("--t2i-batch", type=int, default=8)
    p.add_argument("--mmu-batch", type=int, default=8)
    p.add_argument("--mmu-max-new", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=20.0)
    p.add_argument("--int8", action="store_true", help="int8 weight-only serving")
    p.add_argument("--merge-lora-task", default=None, choices=["t2i", "mmu"],
                   help="single-task deployment: fold that task's LoRA into in_proj (the decode "
                   "step runs no LoRA product; bf16 rounding-scale differences possible); the "
                   "other task's endpoint is refused")
    p.add_argument("--bf16-state", action="store_true",
                   help="carry the decode SSM state in bf16")
    p.add_argument("--int8-state", action="store_true",
                   help="carry the decode SSM state as scaled int8 (the layer-by-layer path)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous-batching mmu lane: requests join a fixed slot pool mid-flight")
    p.add_argument("--slots", type=int, default=8, help="continuous lane slot count")
    p.add_argument("--chunk", type=int, default=16,
                   help="decode steps between two host reads in the continuous lane")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    p.add_argument("--seed", type=int, default=0, help="random weights when there is no --ckpt")
    return p.parse_args(argv)


def build_service(args: argparse.Namespace):
    """The model, merged and quantized as the flags say, in an ``OmniMambaService``."""
    from omnimamba_tpu_torch.config import TrainConfig
    from omnimamba_tpu_torch.factory import build_model
    from omnimamba_tpu_torch.ops.quant import quantize_decode_params
    from omnimamba_tpu_torch.serve.server import OmniMambaService
    from omnimamba_tpu_torch.utils.lora import merge_lora

    cfg = TrainConfig.from_yaml(args.config) if args.config else TrainConfig()
    if args.ckpt:
        cfg.omnimamba_ckpt = args.ckpt
    dtype = getattr(torch, args.dtype)
    model, params, uni = build_model(cfg, stage="inference", seed=args.seed, dtype=dtype,
                                     device=args.device)
    if args.merge_lora_task:  # before the quantization: int8 blocks would re-quantize noise
        params = merge_lora(params, args.merge_lora_task, model.cfg.lora)
        print(f"[serve] {args.merge_lora_task} LoRA merged into in_proj")
    if args.int8:
        params = quantize_decode_params(params)
        print("[serve] int8 weight-only quantization on")
    cache_dtype = "int8" if args.int8_state else torch.bfloat16 if args.bf16_state else "auto"
    return OmniMambaService(
        model, params, uni, t2i_batch=args.t2i_batch, mmu_batch=args.mmu_batch,
        mmu_max_new=args.mmu_max_new, dtype=dtype, cache_dtype=cache_dtype,
        merge_lora_task=args.merge_lora_task, device=args.device)


def main(argv: Optional[List[str]] = None) -> None:
    from omnimamba_tpu_torch.serve.server import make_server

    args = parse_args(argv)
    service = build_service(args)
    server = make_server(service, args.host, args.port, args.max_wait_ms,
                         continuous_mmu=args.continuous, continuous_slots=args.slots,
                         continuous_chunk=args.chunk)
    lane = (f"continuous mmu: {args.slots} slots x {args.chunk}-step chunks"
            if args.continuous else f"mmu batch {args.mmu_batch}")
    print(f"[serve] listening on {args.host}:{server.server_address[1]} "
          f"(t2i batch {args.t2i_batch}, {lane})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        server.stop_batchers()


if __name__ == "__main__":
    main()
