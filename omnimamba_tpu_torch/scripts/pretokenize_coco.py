"""Build the pretokenized text-to-image corpus from raw COCO: the port's
counterpart of ``scripts/pretokenize_coco.py``.

    python -m omnimamba_tpu_torch.scripts.pretokenize_coco \\
        --image-root datasets/coco/train2014 \\
        --ann datasets/coco/annotations/captions_train2014.json \\
        --vq-ckpt vq_ds16_t2i.pt --out pretokenized_coco_train2014.jsonl \\
        [--batch 64] [--limit N] [--size 256] [--device cuda]

Each image is centre-cropped and resized to ``--size`` px
(``data/coco.MSCOCODatabase``; images other than ``.npy`` pixels need PIL),
VQ-encoded in batches on the card (``models/vq.vq_encode``), and written as
a row ``{"captions": [...], "tokens": [ids]}``, the schema ``data/coco.py``
and the native reader (``data/native.py``) read, line for line as the JAX
command line writes it. ``--vq-ckpt`` takes the published VQ state dict
(``.pt`` / ``.pth`` / ``.bin``, through ``utils/convert.convert_vq``) or a
``.npz`` of the JAX package's VQ tree (its ``/``-joined leaf names, through
``utils/bridge.from_jax_params``); without it the weights are random, from
``--seed``, and the command warns.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Raw COCO -> VQ token JSONL (the PyTorch port).")
    p.add_argument("--image-root", required=True)
    p.add_argument("--ann", required=True, help="COCO captions annotation JSON")
    p.add_argument("--vq-ckpt", default=None,
                   help=".pt/.pth/.bin VQ state dict or .npz JAX VQ tree (random if absent)")
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _npz_tree(path: str) -> Dict:
    """A ``.npz`` of ``/``-joined leaf names as a nested tree (list indices as
    ints, as ``utils/bridge`` reads them)."""
    tree: Dict = {}
    with np.load(path) as data:
        for name in data.files:
            node = tree
            parts = [int(p) if p.isdigit() else p for p in name.split("/")]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[name]
    return tree


def load_vq_params(vq_ckpt: Optional[str], vq_cfg, device, seed: int = 0) -> Dict:
    """The VQ tree of ``vq_ckpt`` on ``device`` in fp32; random weights from
    ``seed`` (with a warning) where there is none."""
    from omnimamba_tpu_torch.config import MambaConfig
    from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel
    from omnimamba_tpu_torch.models.vq import init_vq
    from omnimamba_tpu_torch.utils.bridge import from_jax_params
    from omnimamba_tpu_torch.utils.convert import convert_vq, load_torch_state_dict

    if vq_ckpt is None:
        print("[warn] no --vq-ckpt: encoding with RANDOM VQ weights", file=sys.stderr)
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_vq(gen, vq_cfg, torch.float32, device)
    if vq_ckpt.endswith(".npz"):
        model = OmniMambaModel(cfg=MambaConfig(), vq_cfg=vq_cfg, sptids={})
        return from_jax_params({"vq": _npz_tree(vq_ckpt)}, model, dtype=torch.float32,
                               device=device)["vq"]
    tree = convert_vq(load_torch_state_dict(vq_ckpt), vq_cfg)
    return _to(tree, device)


def _to(node, device):
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node.to(device=device, dtype=torch.float32)


@torch.no_grad()
def pretokenize(image_root: str, ann: str, out: str, params: Dict, vq_cfg, *, size: int = 256,
                batch: int = 64, limit: int = 0, device="cuda") -> int:
    """Encode the images of ``ann`` under ``image_root`` in batches of
    ``batch`` and write one JSONL row an image to ``out``; returns the rows
    written."""
    from omnimamba_tpu_torch.data.coco import MSCOCODatabase
    from omnimamba_tpu_torch.models.vq import vq_encode

    ds = MSCOCODatabase(image_root, ann, size=size)
    n = len(ds) if not limit else min(limit, len(ds))
    written = 0
    with open(out, "w") as f:
        for start in range(0, n, batch):
            imgs, caps = zip(*(ds[i] for i in range(start, min(start + batch, n))))
            x = torch.as_tensor(np.stack(imgs), device=device)
            tokens = vq_encode(params, x, vq_cfg).indices.cpu().numpy()
            for t, c in zip(tokens, caps):
                f.write(json.dumps({"captions": c, "tokens": t.reshape(-1).tolist()}) + "\n")
                written += 1
            print(f"\r{written}/{n}", end="", file=sys.stderr)
    print(f"\nwrote {written} rows to {out}", file=sys.stderr)
    return written


def main(argv: Optional[List[str]] = None, vq_cfg=None) -> int:
    """Run as the arguments say (``vq_cfg``: another VQ geometry than the
    published VQ-16, for a caller that is not the command line); returns the
    rows written."""
    from omnimamba_tpu_torch.config import VQConfig
    from omnimamba_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    vq_cfg = vq_cfg or VQConfig()
    params = load_vq_params(args.vq_ckpt, vq_cfg, device, args.seed)
    return pretokenize(args.image_root, args.ann, args.out, params, vq_cfg, size=args.size,
                       batch=args.batch, limit=args.limit, device=device)


if __name__ == "__main__":
    main()
