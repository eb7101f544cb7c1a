"""LlamaGen VQ-16 image tokenizer: the decode side (codebook lookup and
decoder) that turns generated tokens into pixels.

Counterpart of ``omnimamba_tpu/models/vq.py``. The public functions keep the
JAX package's NHWC layout for latents and images, so both packages can be
compared on the same arrays; inside, tensors are NCHW and conv kernels OIHW
as PyTorch's convolution wants them (``utils/bridge`` converts HWIO kernels).
GroupNorm statistics are fp32 with eps 1e-6 and min(32, C) groups.

An fp32 convolution on a CUDA device runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; set it so where an fp32 result
is compared on the card. The encoder waits for the slice that needs it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.config import VQConfig
from omnimamba_tpu_torch.utils.device import resolve_device
from omnimamba_tpu_torch.utils.init import uniform

# ---------------------------------------------------------------------------
# primitives (NCHW)
# ---------------------------------------------------------------------------


def _conv_init(gen, kh, kw, cin, cout, dtype, device):
    """torch Conv2d default: U(+-1/sqrt(fan_in)), fan_in = cin*kh*kw."""
    bound = 1.0 / math.sqrt(cin * kh * kw)
    return {
        "kernel": uniform(gen, (cout, cin, kh, kw), bound, dtype, device),
        "bias": uniform(gen, (cout,), bound, dtype, device),
    }


def conv2d(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 'same' convolution with an OIHW kernel."""
    k = p["kernel"].to(x.dtype)
    return F.conv2d(x, k, p["bias"].to(x.dtype), padding=(k.shape[2] // 2, k.shape[3] // 2))


def group_norm(p: Dict, x: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    C = x.shape[1]
    groups = min(groups, C)
    out = F.group_norm(x.float(), groups, p["scale"].float(), p["bias"].float(), eps)
    return out.to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x.float()).to(x.dtype)


def _gn_init(c, dtype, device):
    return {
        "scale": torch.ones((c,), dtype=dtype, device=device),
        "bias": torch.zeros((c,), dtype=dtype, device=device),
    }


def _init_resnet_block(gen, cin, cout, dtype, device):
    p = {
        "norm1": _gn_init(cin, dtype, device),
        "conv1": _conv_init(gen, 3, 3, cin, cout, dtype, device),
        "norm2": _gn_init(cout, dtype, device),
        "conv2": _conv_init(gen, 3, 3, cout, cout, dtype, device),
    }
    if cin != cout:
        p["nin_shortcut"] = _conv_init(gen, 1, 1, cin, cout, dtype, device)
    return p


def resnet_block(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv1"], swish(group_norm(p["norm1"], x)))
    h = conv2d(p["conv2"], swish(group_norm(p["norm2"], h)))
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def _init_attn_block(gen, c, dtype, device):
    return {
        "norm": _gn_init(c, dtype, device),
        "q": _conv_init(gen, 1, 1, c, c, dtype, device),
        "k": _conv_init(gen, 1, 1, c, c, dtype, device),
        "v": _conv_init(gen, 1, 1, c, c, dtype, device),
        "proj_out": _conv_init(gen, 1, 1, c, c, dtype, device),
    }


def attn_block(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Single-head full self-attention over spatial positions; scores and
    the weighted sum are taken in fp32."""
    B, C, H, W = x.shape
    h = group_norm(p["norm"], x)
    q = conv2d(p["q"], h).reshape(B, C, H * W).transpose(1, 2).float()  # (B, HW, C)
    k = conv2d(p["k"], h).reshape(B, C, H * W).float()  # (B, C, HW)
    v = conv2d(p["v"], h).reshape(B, C, H * W).transpose(1, 2)  # (B, HW, C)
    attn = torch.softmax(torch.bmm(q, k) * (C ** -0.5), dim=-1).to(x.dtype)
    out = torch.bmm(attn.float(), v.float()).to(x.dtype)  # (B, HW, C)
    out = out.transpose(1, 2).reshape(B, C, H, W)
    return x + conv2d(p["proj_out"], out)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def init_decoder(gen, cfg: VQConfig, dtype, device) -> Dict:
    ch = cfg.ch
    n_lv = len(cfg.decoder_ch_mult)
    block_in = ch * cfg.decoder_ch_mult[-1]
    p: Dict = {"conv_in": _conv_init(gen, 3, 3, cfg.z_channels, block_in, dtype, device)}
    p["mid"] = {
        "res1": _init_resnet_block(gen, block_in, block_in, dtype, device),
        "attn": _init_attn_block(gen, block_in, dtype, device),
        "res2": _init_resnet_block(gen, block_in, block_in, dtype, device),
    }
    levels = []
    c = block_in
    for i_level in reversed(range(n_lv)):
        cout = ch * cfg.decoder_ch_mult[i_level]
        lvl = {"res": [], "attn": []}
        for _ in range(cfg.num_res_blocks + 1):
            lvl["res"].append(_init_resnet_block(gen, c, cout, dtype, device))
            c = cout
            if i_level == n_lv - 1:
                lvl["attn"].append(_init_attn_block(gen, c, dtype, device))
        if i_level != 0:
            lvl["upsample"] = _conv_init(gen, 3, 3, c, c, dtype, device)
        levels.append(lvl)
    p["levels"] = levels
    p["norm_out"] = _gn_init(c, dtype, device)
    p["conv_out"] = _conv_init(gen, 3, 3, c, 3, dtype, device)
    return p


def decoder_forward(p: Dict, z: torch.Tensor, cfg: VQConfig) -> torch.Tensor:
    """z: (B, h, w, z_channels) NHWC -> image (B, 16h, 16w, 3) NHWC."""
    h = conv2d(p["conv_in"], z.permute(0, 3, 1, 2))
    h = resnet_block(p["mid"]["res1"], h)
    h = attn_block(p["mid"]["attn"], h)
    h = resnet_block(p["mid"]["res2"], h)
    n_stage = len(p["levels"])
    for s, lvl in enumerate(p["levels"]):
        for j in range(cfg.num_res_blocks + 1):
            h = resnet_block(lvl["res"][j], h)
            if lvl.get("attn"):  # only the deepest level carries attention
                h = attn_block(lvl["attn"][j], h)
        if s != n_stage - 1:
            # nearest x2 upsample + conv
            h = conv2d(lvl["upsample"], F.interpolate(h, scale_factor=2.0, mode="nearest"))
    h = conv2d(p["conv_out"], swish(group_norm(p["norm_out"], h)))
    return h.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# codebook + decode entry points
# ---------------------------------------------------------------------------


def init_vq(
    generator: torch.Generator,
    cfg: VQConfig,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Dict:
    """Decode-side parameters: codebook, post_quant_conv, decoder."""
    device = resolve_device(device)
    codebook = uniform(
        generator, (cfg.codebook_size, cfg.codebook_embed_dim),
        1.0 / cfg.codebook_size, torch.float32, device)
    if cfg.codebook_l2_norm:
        codebook = codebook / torch.linalg.norm(codebook, dim=-1, keepdim=True)
    return {
        "decoder": init_decoder(generator, cfg, dtype, device),
        "post_quant_conv": _conv_init(
            generator, 1, 1, cfg.codebook_embed_dim, cfg.z_channels, dtype, device),
        "codebook": codebook.to(dtype),
    }


def _normalized_codebook(params: Dict, cfg: VQConfig) -> torch.Tensor:
    cb = params["codebook"].float()
    if cfg.codebook_l2_norm:
        cb = cb / torch.linalg.norm(cb, dim=-1, keepdim=True)
    return cb


def quantize(params: Dict, indices: torch.Tensor, cfg: VQConfig) -> torch.Tensor:
    """Lookup side of the quantizer: token ids -> (l2-normalized) codebook
    entries in fp32. The nearest-entry search belongs to the encoder."""
    return _normalized_codebook(params, cfg)[indices]


def vq_decode(params: Dict, quant: torch.Tensor, cfg: VQConfig) -> torch.Tensor:
    """quant: (B, h, w, e_dim) NHWC latents -> image NHWC."""
    p = params["post_quant_conv"]
    h = conv2d(p, quant.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return decoder_forward(params["decoder"], h, cfg)


def vq_decode_code(
    params: Dict, indices: torch.Tensor, cfg: VQConfig,
    grid: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Token ids -> image. indices: (B, T) or (B, h, w); grid defaults to
    sqrt(T) x sqrt(T) (16 x 16 for 256 tokens). Returns (B, 16h, 16w, 3)."""
    if indices.dim() == 2:
        B, T = indices.shape
        if grid is None:
            g = math.isqrt(T)
            if g * g != T:
                raise ValueError(f"{T} tokens do not form a square grid; pass grid=")
            grid = (g, g)
        indices = indices.reshape(B, *grid)
    z_q = quantize(params, indices, cfg).to(params["post_quant_conv"]["kernel"].dtype)
    return vq_decode(params, z_q, cfg)
