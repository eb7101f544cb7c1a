"""Text-to-image generation from the command line. Counterpart of
``scripts/inference_t2i.py``: prompt -> 72-id caption block -> 256 VQ tokens
-> VQ-16 decode -> one image (a row of images for ``--batch`` > 1).

    python -m omnimamba_tpu_torch.scripts.inference_t2i --prompt "A photo of a corgi" \\
        [--config config/config_stage2.yaml] [--ckpt DIR_OR_STEP.pt] \\
        [--cfg-scale 0] [--top-k 1] [--out generated_image.jpg] [--device cuda]

``--out`` ending in ``.npy`` saves the uint8 pixels with numpy; any other name
is written by PIL. Without ``--ckpt`` the weights are random, made from
``--seed``. The t2i LoRA is folded into in_proj (``utils/lora.merge_lora``)
unless ``--no-merge-lora`` is given.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

MAX_CAPTION_TOKENS = 68  # caption ids between <|t2i|> <|sot|> and <|eot|> <|soi|>
NULL_PROMPT = "A picture"  # the null condition of classifier-free guidance


def caption_block(uni, prompt: str) -> np.ndarray:
    """[<|t2i|> <|sot|>] ++ the caption left-padded to 68 ids ++ [<|eot|> <|soi|>]."""
    ids = np.asarray(uni.text_tokenizer(prompt)["input_ids"], np.int64)
    pad = np.full(MAX_CAPTION_TOKENS, uni.pad_id, np.int64)
    n = min(len(ids), MAX_CAPTION_TOKENS)
    if n:
        pad[-n:] = ids[:n]
    sp = uni.sptids_dict
    return np.concatenate([[sp["<|t2i|>"], sp["<|sot|>"]], pad, [sp["<|eot|>"], sp["<|soi|>"]]])


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Generate images with OmniMamba (the PyTorch port).")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--config", type=str, default=None,
                   help="a YAML train config (needs PyYAML); default: the 1.3B model")
    p.add_argument("--ckpt", type=str, default=None,
                   help="a checkpoint of the port (step_<n>.pt or its directory)")
    p.add_argument("--out", type=str, default="generated_image.jpg")
    p.add_argument("--top-k", type=int, default=1)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--cfg-scale", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0, help="sampling, and random weights")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--no-merge-lora", action="store_true",
                   help="keep LoRA unmerged (the default merges the t2i adapters into in_proj: "
                   "no LoRA product a decode step)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    args = parse_args(argv)
    from omnimamba_tpu_torch.config import TrainConfig
    from omnimamba_tpu_torch.data.transforms import from_vq_range
    from omnimamba_tpu_torch.factory import build_model
    from omnimamba_tpu_torch.models.omnimamba import t2i_generate
    from omnimamba_tpu_torch.ops.sampling import SampleParams
    from omnimamba_tpu_torch.utils.lora import merge_lora

    cfg = TrainConfig.from_yaml(args.config) if args.config else TrainConfig()
    cfg.mmu_task = False  # no towers for text-to-image
    if args.ckpt:
        cfg.omnimamba_ckpt = args.ckpt
    dtype = getattr(torch, args.dtype)
    model, params, uni = build_model(cfg, stage="inference", seed=args.seed, dtype=dtype,
                                     device=args.device)
    if not args.no_merge_lora and model.cfg.lora is not None:
        params = merge_lora(params, "t2i", model.cfg.lora)

    text_ids = np.stack([caption_block(uni, args.prompt)] * args.batch)
    cfg_scale = args.cfg_scale if args.cfg_scale > 0 else None
    if cfg_scale is not None:
        uncond = np.stack([caption_block(uni, NULL_PROMPT)] * args.batch)
        text_ids = np.concatenate([text_ids, uncond], axis=0)
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    with torch.no_grad():
        imgs, tokens = t2i_generate(
            params, model, text_ids,
            sample=SampleParams(top_k=args.top_k, top_p=args.top_p, temperature=args.temperature),
            generator=generator, cfg_scale=cfg_scale, dtype=dtype, device=args.device)
    arr = from_vq_range(imgs).cpu().numpy()  # (B, 256, 256, 3) uint8
    grid = np.concatenate(list(arr), axis=1)
    if args.out.endswith(".npy"):
        np.save(args.out, grid)
    else:
        from PIL import Image

        Image.fromarray(grid).save(args.out)
    print(f"saved {args.out} ({arr.shape[0]} image(s)); first tokens:", tokens[0, :8].tolist())
    return grid


if __name__ == "__main__":
    main()
