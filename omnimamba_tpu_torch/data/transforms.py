"""Image preprocessing on tensors: the port's counterpart of
``omnimamba_tpu/data/transforms.py``.

``vit_transform`` takes raw uint8 pixels to a tower's normalised input:
resize (with ``jax.image.resize``'s weights, ``ops/resize.py``) and the
tower's mean / std. It runs on the device the pixels lie on, so a loader
can ship uint8 and the card does the rest. ``host_vit_transform`` is the
PIL path, byte for byte the torchvision pipeline; it imports PIL when
called, so nothing else here needs PIL.

Also the raw COCO images' square centre crop (``center_crop_resize``, PIL
imported when called) and the [-1, 1] scaling of the VQ tokenizer's pixels.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.config import ViTConfig, VisionConfig
from omnimamba_tpu_torch.ops.resize import resize


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def _shorter_side_shape(h: int, w: int, target: int) -> tuple:
    """torchvision Resize(int): the shorter side to target, the longer
    scaled with int() truncation."""
    if h <= w:
        return target, int(target * w / h)
    return int(target * h / w), target


def _center_crop_offsets(h: int, w: int, size: int) -> tuple:
    """torchvision CenterCrop top / left: int(round((dim - size) / 2))."""
    return int(round((h - size) / 2.0)), int(round((w - size) / 2.0))


def vit_transform(raw: torch.Tensor, cfg: ViTConfig, strategy: str = "resize-naive") -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalised float32 (B, s, s, 3).

    Strategies:
    - resize-naive: an exact (s, s) resize (the shipped default);
    - resize-crop: the shorter side to floor(s / crop_pct), a centre crop
      (s, s);
    - letterbox: a symmetric pad to a square with the normalisation mean
      (as a uint8 fill, int(mean * 255)), then resize-crop.
    """
    S = cfg.img_size
    x = raw.to(torch.float32) / 255.0
    if strategy == "resize-naive":
        return normalize(resize(x, (S, S), (-3, -2), cfg.interpolation), cfg.mean, cfg.std)
    if strategy not in ("resize-crop", "letterbox"):
        raise ValueError(f"unknown resize strategy {strategy!r}")
    if strategy == "letterbox":
        h, w = x.shape[-3], x.shape[-2]
        side = max(h, w)
        ph, pw = (side - h) // 2, (side - w) // 2
        fills = [int(m * 255) / 255.0 for m in cfg.mean]
        pad = (pw, side - w - pw, ph, side - h - ph)
        x = torch.stack([F.pad(x[..., c], pad, value=fills[c]) for c in range(3)], dim=-1)
    h, w = x.shape[-3], x.shape[-2]
    nh, nw = _shorter_side_shape(h, w, int(S / cfg.crop_pct))
    x = resize(x, (nh, nw), (-3, -2), cfg.interpolation)
    top, left = _center_crop_offsets(nh, nw, S)
    return normalize(x[..., top:top + S, left:left + S, :], cfg.mean, cfg.std)


def dinosiglip_transform(
    raw: torch.Tensor, cfg: VisionConfig, strategy: "str | None" = None
) -> Dict[str, torch.Tensor]:
    """Each tower's input, {"dino": ..., "siglip": ...}; ``strategy``
    defaults to ``cfg.resize_strategy``."""
    strategy = strategy or cfg.resize_strategy
    return {
        "dino": vit_transform(raw, cfg.dino, strategy),
        "siglip": vit_transform(raw, cfg.siglip, strategy),
    }


def host_vit_transform(img: np.ndarray, cfg: ViTConfig, strategy: str = "resize-naive") -> np.ndarray:
    """PIL's resampling, as torchvision's PIL-backed pipeline: uint8
    (H, W, 3) -> float32 (s, s, 3). The parity path for fidelity work;
    ``vit_transform`` is the throughput path (the resize kernels differ in
    the last bits)."""
    from PIL import Image

    interp = {
        "bicubic": Image.BICUBIC,
        "bilinear": Image.BILINEAR,
        "lanczos": Image.LANCZOS,
        "nearest": Image.NEAREST,
    }[cfg.interpolation]
    S = cfg.img_size
    pil = Image.fromarray(img)
    if strategy == "resize-naive":
        pil = pil.resize((S, S), interp)
    elif strategy in ("resize-crop", "letterbox"):
        if strategy == "letterbox":
            w, h = pil.size
            side = max(w, h)
            fill = tuple(int(m * 255) for m in cfg.mean)
            padded = Image.new("RGB", (side, side), fill)
            padded.paste(pil, ((side - w) // 2, (side - h) // 2))
            pil = padded
        w, h = pil.size
        nh, nw = _shorter_side_shape(h, w, int(S / cfg.crop_pct))
        pil = pil.resize((nw, nh), interp)
        top, left = _center_crop_offsets(nh, nw, S)
        pil = pil.crop((left, top, left + S, top + S))
    else:
        raise ValueError(f"unknown resize strategy {strategy!r}")
    x = np.asarray(pil, np.float32) / 255.0
    return (x - np.asarray(cfg.mean, np.float32)) / np.asarray(cfg.std, np.float32)


def host_dinosiglip_transform(
    img: np.ndarray, cfg: VisionConfig, strategy: "str | None" = None
) -> Dict[str, np.ndarray]:
    strategy = strategy or cfg.resize_strategy
    return {
        "dino": host_vit_transform(img, cfg.dino, strategy),
        "siglip": host_vit_transform(img, cfg.siglip, strategy),
    }


def center_crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (size, size, 3): the central square of side
    min(H, W), resized with PIL's Lanczos filter (the T2I raw-image path)."""
    from PIL import Image

    h, w = img.shape[:2]
    crop = min(h, w)
    img = img[(h - crop) // 2:(h + crop) // 2, (w - crop) // 2:(w + crop) // 2]
    return np.asarray(Image.fromarray(img).resize((size, size), Image.LANCZOS)).astype(np.uint8)


def to_vq_range(img_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [-1, 1] float32."""
    return img_uint8.to(torch.float32) / 127.5 - 1.0


def from_vq_range(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8, clamped."""
    return torch.clamp((img.float() + 1.0) * 127.5, 0, 255).to(torch.uint8)
