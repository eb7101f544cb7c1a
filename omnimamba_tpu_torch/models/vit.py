"""Vision transformers: DINOv2-L/14 with 4 registers and SigLIP so400m/14,
both at 384 px. Counterpart of ``omnimamba_tpu/models/vit.py``.

The featurizer returns the patch tokens of the second-to-last block: blocks
0 .. depth-2 run, there is no final norm, and the prefix tokens are stripped.
The two towers' features are concatenated to (B, 729, 2176). One
implementation covers both geometries through ``ViTConfig``:

- DINOv2: a cls token and 4 register tokens before the patches, the
  position table on the patches only, LayerScale, exact GELU;
- SigLIP: no prefix tokens, tanh GELU.

Rounding points are the JAX package's: the patch embedding is a convolution
with an fp32 result, then the fp32 bias, then a cast; attention scores are
summed in fp32, the softmax is taken in fp32 and cast to x's type, and the
second product is summed in fp32 and cast. Products of bf16 values are exact
in fp32, so both products widen their bf16 operands and multiply in fp32.
These are library products (``torch.matmul``, ``F.conv2d``): the JAX package
has no Pallas kernel in the towers.

Parameters: ``patch_embed`` {kernel (d, 3, p, p) OIHW, bias}, ``pos_embed``
(1, N, d), ``cls_token`` / ``reg_tokens`` where the tower has them,
``blocks`` a list of per-block dicts (``norm1``, ``attn`` {``qkv`` fused
(d, 3d), ``proj``}, ``norm2``, ``mlp`` {``fc1``, ``fc2``}, ``ls1`` / ``ls2``),
and the unused final ``norm``, kept so a checkpoint round-trips. Linear
kernels are ``(in, out)``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.config import ViTConfig, VisionConfig
from omnimamba_tpu_torch.ops.norms import layer_norm
from omnimamba_tpu_torch.utils.device import resolve_device
from omnimamba_tpu_torch.utils.init import linear_uniform, normal


def _apply_linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def _norm_init(d, dtype, device) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def init_vit(generator: torch.Generator, cfg: ViTConfig, dtype: torch.dtype = torch.float32,
             device="cuda") -> Dict:
    """Random parameters with the JAX ``init_vit`` distributions: patch kernel
    and position table normal(0.02), zero prefix tokens and patch bias,
    linear layers U(+-1/sqrt(d_in)) (kernel and bias), unit norms, LayerScale
    gammas 1e-5. ``generator`` must live on ``device``."""
    device = resolve_device(device)
    d, p = cfg.width, cfg.patch_size
    mlp_hidden = int(round(d * cfg.mlp_ratio))
    params: Dict = {
        "patch_embed": {"kernel": normal(generator, (d, 3, p, p), 0.02, dtype, device),
                        "bias": torch.zeros((d,), dtype=dtype, device=device)},
        "pos_embed": normal(generator, (1, cfg.num_patches, d), 0.02, dtype, device),
    }
    if cfg.use_cls_token:
        params["cls_token"] = torch.zeros((1, 1, d), dtype=dtype, device=device)
    if cfg.num_reg_tokens:
        params["reg_tokens"] = torch.zeros((1, cfg.num_reg_tokens, d), dtype=dtype, device=device)
    blocks = []
    for _ in range(cfg.depth):
        blk = {
            "norm1": _norm_init(d, dtype, device),
            "attn": {"qkv": linear_uniform(generator, d, 3 * d, dtype, device),
                     "proj": linear_uniform(generator, d, d, dtype, device)},
            "norm2": _norm_init(d, dtype, device),
            "mlp": {"fc1": linear_uniform(generator, d, mlp_hidden, dtype, device),
                    "fc2": linear_uniform(generator, mlp_hidden, d, dtype, device)},
        }
        if cfg.layerscale:
            blk["ls1"] = {"gamma": torch.full((d,), 1e-5, dtype=dtype, device=device)}
            blk["ls2"] = {"gamma": torch.full((d,), 1e-5, dtype=dtype, device=device)}
        blocks.append(blk)
    params["blocks"] = blocks
    params["norm"] = _norm_init(d, dtype, device)
    return params


def _attention(p: Dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    hd = D // num_heads
    qkv = _apply_linear(p["qkv"], x).reshape(B, T, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, T, hd)
    scores = q.float() @ k.float().transpose(-1, -2)
    attn = torch.softmax(scores * (hd ** -0.5), dim=-1).to(x.dtype)
    out = (attn.float() @ v.float()).to(x.dtype)
    return _apply_linear(p["proj"], out.transpose(1, 2).reshape(B, T, D))


def _use_tanh_gelu(cfg: ViTConfig) -> bool:
    # SigLIP uses the tanh GELU, DINOv2 the exact one
    return not cfg.use_cls_token


def _block(blk: Dict, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    h = layer_norm(x, blk["norm1"]["scale"], blk["norm1"]["bias"], cfg.norm_eps)
    h = _attention(blk["attn"], h, cfg.num_heads)
    if "ls1" in blk:
        h = h * blk["ls1"]["gamma"].to(h.dtype)
    x = x + h
    h = layer_norm(x, blk["norm2"]["scale"], blk["norm2"]["bias"], cfg.norm_eps)
    h = F.gelu(_apply_linear(blk["mlp"]["fc1"], h),
               approximate="tanh" if _use_tanh_gelu(cfg) else "none")
    h = _apply_linear(blk["mlp"]["fc2"], h)
    if "ls2" in blk:
        h = h * blk["ls2"]["gamma"].to(h.dtype)
    return x + h


def vit_features(params: Dict, pixels: torch.Tensor, cfg: ViTConfig, *,
                 out_offset: int = 2) -> torch.Tensor:
    """(B, H, W, 3) normalised pixels -> (B, N, d) patch tokens of block
    depth - out_offset, prefix tokens stripped, no final norm. Runs in the
    pixels' type, on their device."""
    B = pixels.shape[0]
    d = cfg.width
    kernel = params["patch_embed"]["kernel"].to(pixels.dtype)
    x = F.conv2d(pixels.permute(0, 3, 1, 2).float(), kernel.float(), stride=cfg.patch_size)
    x = (x + params["patch_embed"]["bias"].float()[:, None, None]).to(pixels.dtype)
    x = x.flatten(2).transpose(1, 2)  # (B, N, d)
    x = x + params["pos_embed"].to(x.dtype)
    prefix = []
    if cfg.use_cls_token:
        prefix.append(params["cls_token"].to(x.dtype).expand(B, 1, d))
    if cfg.num_reg_tokens:
        prefix.append(params["reg_tokens"].to(x.dtype).expand(B, cfg.num_reg_tokens, d))
    n_prefix = sum(t.shape[1] for t in prefix)
    if prefix:
        x = torch.cat(prefix + [x], dim=1)
    for blk in params["blocks"][: cfg.depth - out_offset + 1]:
        x = _block(blk, x, cfg)
    return x[:, n_prefix:]


def dinosiglip_features(dino_params: Dict, siglip_params: Dict, pixels: Dict[str, torch.Tensor],
                        cfg: VisionConfig) -> torch.Tensor:
    """The concatenated (B, N, dino.width + siglip.width) features."""
    dino = vit_features(dino_params, pixels["dino"], cfg.dino)
    sig = vit_features(siglip_params, pixels["siglip"], cfg.siglip)
    return torch.cat([dino, sig], dim=-1)
