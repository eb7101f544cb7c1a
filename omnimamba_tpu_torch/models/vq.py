"""LlamaGen VQ-16 image tokenizer: the encoder and the nearest-code
quantizer that turn pixels into tokens, and the decode side (codebook
lookup and decoder) that turns generated tokens into pixels.

Counterpart of ``omnimamba_tpu/models/vq.py``. The public functions keep the
JAX package's NHWC layout for latents and images, so both packages can be
compared on the same arrays; inside, tensors are NCHW and conv kernels OIHW
as PyTorch's convolution wants them (``utils/bridge`` converts HWIO kernels).
GroupNorm statistics are fp32 with eps 1e-6 and min(32, C) groups.

An fp32 convolution on a CUDA device runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False, and the code distances decide
an argmax: ``vq_encode`` turns TF32 off for its convolutions and products
while it runs, so its codes are those of fp32 arithmetic. The decoder keeps
the caller's setting; set it off where an fp32 image is compared on the card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Tuple

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


def conv2d(p: Dict, x: torch.Tensor, stride: int = 1, same: bool = True) -> torch.Tensor:
    """Convolution with an OIHW kernel: 'same' padding, or none."""
    k = p["kernel"].to(x.dtype)
    padding = (k.shape[2] // 2, k.shape[3] // 2) if same else 0
    return F.conv2d(x, k, p["bias"].to(x.dtype), stride=stride, padding=padding)


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
# encoder
# ---------------------------------------------------------------------------


def init_encoder(gen, cfg: VQConfig, dtype, device) -> Dict:
    ch = cfg.ch
    in_mult = (1,) + tuple(cfg.encoder_ch_mult)
    n_lv = len(cfg.encoder_ch_mult)
    p: Dict = {"conv_in": _conv_init(gen, 3, 3, 3, ch, dtype, device)}
    levels = []
    for i in range(n_lv):
        c, cout = ch * in_mult[i], ch * cfg.encoder_ch_mult[i]
        lvl = {"res": [], "attn": []}
        for _ in range(cfg.num_res_blocks):
            lvl["res"].append(_init_resnet_block(gen, c, cout, dtype, device))
            c = cout
            if i == n_lv - 1:
                lvl["attn"].append(_init_attn_block(gen, c, dtype, device))
        if i != n_lv - 1:
            lvl["downsample"] = _conv_init(gen, 3, 3, c, c, dtype, device)
        levels.append(lvl)
    p["levels"] = levels
    cmid = ch * cfg.encoder_ch_mult[-1]
    p["mid"] = {
        "res1": _init_resnet_block(gen, cmid, cmid, dtype, device),
        "attn": _init_attn_block(gen, cmid, dtype, device),
        "res2": _init_resnet_block(gen, cmid, cmid, dtype, device),
    }
    p["norm_out"] = _gn_init(cmid, dtype, device)
    p["conv_out"] = _conv_init(gen, 3, 3, cmid, cfg.z_channels, dtype, device)
    return p


def encoder_forward(p: Dict, x: torch.Tensor, cfg: VQConfig) -> torch.Tensor:
    """Image (B, H, W, 3) NHWC -> latents (B, H / 2^(levels - 1), ...,
    z_channels) NHWC."""
    h = conv2d(p["conv_in"], x.permute(0, 3, 1, 2))
    n_lv = len(cfg.encoder_ch_mult)
    for i, lvl in enumerate(p["levels"]):
        for j in range(cfg.num_res_blocks):
            h = resnet_block(lvl["res"][j], h)
            if lvl.get("attn"):  # only the deepest level carries attention
                h = attn_block(lvl["attn"][j], h)
        if i != n_lv - 1:
            # pad one row and one column at the far side, then a stride-2 conv
            h = conv2d(lvl["downsample"], F.pad(h, (0, 1, 0, 1)), stride=2, same=False)
    h = resnet_block(p["mid"]["res1"], h)
    h = attn_block(p["mid"]["attn"], h)
    h = resnet_block(p["mid"]["res2"], h)
    h = conv2d(p["conv_out"], swish(group_norm(p["norm_out"], h)))
    return h.permute(0, 2, 3, 1)


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
    """Every parameter: codebook, decoder and post_quant_conv (the decode
    side), encoder and quant_conv."""
    device = resolve_device(device)
    codebook = uniform(
        generator, (cfg.codebook_size, cfg.codebook_embed_dim),
        1.0 / cfg.codebook_size, torch.float32, device)
    if cfg.codebook_l2_norm:
        codebook = codebook / torch.linalg.norm(codebook, dim=-1, keepdim=True)
    params = {
        "decoder": init_decoder(generator, cfg, dtype, device),
        "post_quant_conv": _conv_init(
            generator, 1, 1, cfg.codebook_embed_dim, cfg.z_channels, dtype, device),
        "codebook": codebook.to(dtype),
    }
    params["encoder"] = init_encoder(generator, cfg, dtype, device)
    params["quant_conv"] = _conv_init(
        generator, 1, 1, cfg.z_channels, cfg.codebook_embed_dim, dtype, device)
    return params


def _normalized_codebook(params: Dict, cfg: VQConfig) -> torch.Tensor:
    cb = params["codebook"].float()
    if cfg.codebook_l2_norm:
        cb = cb / torch.linalg.norm(cb, dim=-1, keepdim=True)
    return cb


def codebook_lookup(params: Dict, indices: torch.Tensor, cfg: VQConfig) -> torch.Tensor:
    """Token ids -> (l2-normalized) codebook entries in fp32."""
    return _normalized_codebook(params, cfg)[indices]


class VQEncodeOutput(NamedTuple):
    quant: torch.Tensor  # (B, h, w, e_dim) straight-through quantized latents, z's type
    indices: torch.Tensor  # (B, h, w) int64 code ids
    vq_loss: torch.Tensor
    commit_loss: torch.Tensor
    entropy_loss: torch.Tensor


def quantize(params: Dict, z: torch.Tensor, cfg: VQConfig, training: bool = False) -> VQEncodeOutput:
    """Nearest code of each latent (B, h, w, e_dim): with the l2 norm the
    largest fp32 dot product with the normalised codebook (the smallest
    distance). ``training`` adds the codebook, commitment and entropy
    losses; the latents pass a straight-through gradient."""
    zf = z.float()
    if cfg.codebook_l2_norm:
        zf = zf / torch.linalg.norm(zf, dim=-1, keepdim=True)
    cb = _normalized_codebook(params, cfg)
    sim = torch.einsum("bhwe,ve->bhwv", zf, cb)
    indices = torch.argmax(sim, dim=-1)
    z_q = cb[indices]
    zero = torch.zeros((), dtype=torch.float32, device=z.device)
    vq_loss = commit_loss = entropy_loss = zero
    if training:
        vq_loss = torch.mean(torch.square(z_q - zf.detach()))
        commit_loss = cfg.commit_loss_beta * torch.mean(torch.square(z_q.detach() - zf))
        if cfg.entropy_loss_ratio > 0:
            d = sim.reshape(-1, cfg.codebook_size) / 0.01
            probs = torch.softmax(d, dim=-1)
            log_probs = torch.log_softmax(d + 1e-5, dim=-1)
            avg_probs = probs.mean(dim=0)
            avg_entropy = -torch.sum(avg_probs * torch.log(avg_probs + 1e-5))
            sample_entropy = -torch.mean(torch.sum(probs * log_probs, dim=-1))
            entropy_loss = cfg.entropy_loss_ratio * (sample_entropy - avg_entropy)
    z_q_st = zf + (z_q - zf).detach()
    return VQEncodeOutput(z_q_st.to(z.dtype), indices, vq_loss, commit_loss, entropy_loss)


@contextlib.contextmanager
def _no_tf32():
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def vq_encode(params: Dict, img: torch.Tensor, cfg: VQConfig, training: bool = False) -> VQEncodeOutput:
    """Image (B, H, W, 3) in [-1, 1] -> codes (B, H/16, W/16) for the
    published VQ-16 (``quantize``), TF32 off while it runs."""
    with _no_tf32():
        h = encoder_forward(params["encoder"], img, cfg)
        p = params["quant_conv"]
        h = conv2d(p, h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return quantize(params, h, cfg, training)


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
    z_q = codebook_lookup(params, indices, cfg).to(params["post_quant_conv"]["kernel"].dtype)
    return vq_decode(params, z_q, cfg)
