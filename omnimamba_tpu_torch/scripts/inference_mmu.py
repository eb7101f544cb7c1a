"""Image understanding (visual question answering) from the command line.
Counterpart of ``scripts/inference_mmu.py``: the phi1.5 conversation wrap,
the DINOv2 + SigLIP features spliced after [<|mmu|> <|soi|>], greedy decoding
to <|endoftext|>.

    python -m omnimamba_tpu_torch.scripts.inference_mmu --image_path img.npy \\
        --question "What is in this image? *** How many dogs?" \\
        [--config config/config_stage2.yaml] [--ckpt DIR_OR_STEP.pt] [--device cuda]

The image is a ``.npy`` of uint8 pixels (H, W, 3), or any file PIL reads
where PIL is installed. Without ``--ckpt`` the weights are random, made from
``--seed``. The mmu LoRA is folded into in_proj (``utils/lora.merge_lora``)
unless ``--no-merge-lora`` is given. Prints the list of answers.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def read_image(path: str) -> np.ndarray:
    """uint8 (H, W, 3) from a ``.npy`` file, or through PIL."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"{path}: expected uint8 pixels (H, W, 3), got {img.dtype} {img.shape}")
    return img


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Answer questions about an image with OmniMamba (the PyTorch port).")
    p.add_argument("--image_path", type=str, required=True,
                   help=".npy of uint8 pixels (H, W, 3), or an image file PIL reads")
    p.add_argument("--question", type=str, required=True, help="questions separated by ' *** '")
    p.add_argument("--config", type=str, default=None,
                   help="a YAML train config (needs PyYAML); default: the 1.3B model with the "
                   "dinosiglip-vit-so-384px towers")
    p.add_argument("--ckpt", type=str, default=None,
                   help="a checkpoint of the port (step_<n>.pt or its directory)")
    p.add_argument("--max-length", type=int, default=2048, help="prompt, image span and answer")
    p.add_argument("--no-merge-lora", action="store_true",
                   help="keep LoRA unmerged (the default merges the mmu adapters into in_proj: "
                   "no LoRA product a decode step)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    p.add_argument("--seed", type=int, default=0, help="random weights when there is no --ckpt")
    p.add_argument("--speculative", type=str, default=None,
                   help="greedy speculative decoding, the same stream in fp32: 'int8' (an int8 "
                   "copy drafts), 'shallow:<M>' (the first M layers draft) or 'ngram' "
                   "(prompt lookup)")
    p.add_argument("--k-draft", type=int, default=8)
    p.add_argument("--repetition-penalty", type=float, default=1.0,
                   help="CTRL penalty over the prompt's text and the answer (1.0: off)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    args = parse_args(argv)
    from omnimamba_tpu_torch.config import TrainConfig
    from omnimamba_tpu_torch.data.conversation import conv_templates
    from omnimamba_tpu_torch.data.transforms import dinosiglip_transform
    from omnimamba_tpu_torch.factory import build_model
    from omnimamba_tpu_torch.models.omnimamba import mmu_generate, mmu_image_features
    from omnimamba_tpu_torch.ops.sampling import SampleParams
    from omnimamba_tpu_torch.utils.lora import merge_lora

    cfg = TrainConfig.from_yaml(args.config) if args.config else TrainConfig()
    cfg.mmu_task = True
    if args.ckpt:
        cfg.omnimamba_ckpt = args.ckpt
    dtype = getattr(torch, args.dtype)
    model, params, uni = build_model(cfg, stage="inference", seed=args.seed, dtype=dtype,
                                     with_vq=False, device=args.device)
    if not args.no_merge_lora and model.cfg.lora is not None:
        params = merge_lora(params, "mmu", model.cfg.lora)

    raw = torch.as_tensor(read_image(args.image_path), device=args.device)[None]
    with torch.no_grad():
        feats = mmu_image_features(params, model, dinosiglip_transform(raw, model.vision_cfg))

    spec_kw = {}
    if args.speculative == "int8":
        from omnimamba_tpu_torch.ops.quant import quantize_decode_params

        spec_kw = {"draft_params": quantize_decode_params(params["mamba"]), "k_draft": args.k_draft}
    elif args.speculative and args.speculative.startswith("shallow:"):
        spec_kw = {"draft_layers": int(args.speculative.split(":")[1]), "k_draft": args.k_draft}
    elif args.speculative == "ngram":
        spec_kw = {"draft_mode": "ngram", "k_draft": args.k_draft}
    elif args.speculative:
        raise SystemExit(f"unknown --speculative mode {args.speculative!r}")

    sp = uni.sptids_dict
    tokenizer = uni.text_tokenizer
    answers = []
    for question in args.question.split(" *** "):
        conv = conv_templates["phi1.5"].copy()
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], None)
        ids = list(tokenizer(conv.get_prompt().strip())["input_ids"])
        input_ids = [[sp["<|mmu|>"], sp["<|soi|>"], sp["<|eoi|>"], sp["<|sot|>"]] + ids]
        with torch.no_grad():
            out = mmu_generate(
                params, model, input_ids, feats, max_length=args.max_length,
                sample=SampleParams(top_k=1, repetition_penalty=args.repetition_penalty),
                eos_token_id=int(tokenizer.eos_token_id), dtype=dtype, device=args.device,
                **spec_kw)
        start = len(input_ids[0]) + feats.shape[1]
        answer = out.sequences[0, start:start + int(out.num_generated)].cpu().numpy()
        answers.append(tokenizer.decode(answer, skip_special_tokens=True))
    print(answers)
    return answers


if __name__ == "__main__":
    main()
