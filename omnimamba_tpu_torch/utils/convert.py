"""Published PyTorch checkpoints -> the port's parameter trees. Counterpart of
``omnimamba_tpu/utils/convert.py``, written straight into the port's layout:
the fused in_proj kernel ``(d, d_in_proj)`` and LoRA B ``(1, r, d_in_proj)``
in the checkpoint's own ``z | x | B | C | dt`` order, the conv taps as one
``(W, channels)`` weight, layers and tower blocks as lists of per-layer
dicts, linear kernels ``(in, out)`` and convolution kernels OIHW (the
checkpoints' own layout).

Layouts read:

- MambaLMHeadModel (``backbone.embedding.weight``, ``backbone.layers.{i}.*``
  with the LoRA-wrapped ``in_proj`` (``in_proj.{t2i,mmu}_lora_{A,B}0.weight``),
  the t2i embeddings, ``pos_embed``, ``caption_embed``, ``mmu_pos_embed``);
- the OmniMamba checkpoint (``llm_backbone.mamba.*`` and
  ``projector.projector.{0,2,4}.*``);
- LlamaGen's VQModel (``encoder.*``, ``decoder.*``, ``quant_conv``,
  ``post_quant_conv``, ``quantize.embedding.weight``; the ``codebook_used``
  buffer is dropped);
- timm ViTs (DINOv2 with cls and register tokens and LayerScale, SigLIP),
  with the position table resampled where the checkpoint's grid differs.

Every function returns CPU tensors in the checkpoint's float type (fp32 from
``load_torch_state_dict``). Values are copied, transposed or concatenated,
never computed, except two: the rows a vocabulary resize adds and the
resampled position table, both made as the JAX package makes them, so the
two packages give the same bits through ``utils/bridge``.
"""

from __future__ import annotations

import zlib
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.config import MambaConfig, Mamba2LayerConfig, ViTConfig, VQConfig
from omnimamba_tpu_torch.models.mamba2 import TASKS


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` state dict (``torch.load(weights_only=True)``) as
    fp32 CPU tensors; LlamaGen's ``{"model": state dict}`` nesting is
    unwrapped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict) and all(
            hasattr(v, "shape") for v in sd["model"].values()):
        sd = sd["model"]
    return {k: v.detach().float() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Mamba backbone
# ---------------------------------------------------------------------------


def _check_in_proj_rows(rows: int, cfg: Mamba2LayerConfig) -> None:
    want = 2 * cfg.d_inner + 2 * cfg.ngroups * cfg.d_state + cfg.nheads
    if rows != want:
        raise ValueError(f"in_proj has {rows} rows, the config wants {want} (z | x | B | C | dt)")


def _fresh_lora(prefix: str, task: str, d_model: int, r: int, rows: int):
    """The LoRA a pretrain checkpoint lacks: kaiming-uniform A, zero B, drawn
    from a seed of the layer's name (the JAX package seeds from Python's
    per-process string hash, so its draw changes from run to run)."""
    rng = np.random.default_rng(zlib.crc32(f"{prefix}/{task}".encode()))
    bound = 1.0 / np.sqrt(d_model)
    A = rng.uniform(-bound, bound, (r, d_model)).astype(np.float32)
    return torch.from_numpy(A), torch.zeros((rows, r), dtype=torch.float32)


def convert_mamba_layer(sd: Mapping, prefix: str, cfg: MambaConfig) -> Dict:
    """``{prefix}.*`` of a MambaLMHeadModel -> one layer of the port."""
    w = _t(sd[f"{prefix}.mixer.in_proj.weight"])  # (d_in_proj, d_model)
    _check_in_proj_rows(w.shape[0], cfg.mixer)
    lora = {}
    for task in TASKS:
        a_key = f"{prefix}.mixer.in_proj.{task}_lora_A0.weight"
        if a_key in sd:
            A = _t(sd[a_key])  # (r, d)
            B = _t(sd[f"{prefix}.mixer.in_proj.{task}_lora_B0.weight"])  # (d_in_proj, r)
        else:  # a pretrain checkpoint: the LoRA keeps a fresh init
            A, B = _fresh_lora(prefix, task, cfg.d_model, cfg.lora.r, w.shape[0])
        _check_in_proj_rows(B.shape[0], cfg.mixer)
        lora[f"{task}_A"] = A.T.contiguous()[None]  # (1, d, r)
        lora[f"{task}_B"] = B.T.contiguous()[None]  # (1, r, d_in_proj)
    conv_w = _t(sd[f"{prefix}.mixer.conv1d.weight"])  # (channels, 1, W)
    return {
        "norm": {"weight": _t(sd[f"{prefix}.norm.weight"])},
        "mixer": {
            "in_proj": {"kernel": w.T.contiguous()},
            "conv": {"weight": conv_w[:, 0, :].T.contiguous(),
                     "bias": _t(sd[f"{prefix}.mixer.conv1d.bias"])},
            "dt_bias": _t(sd[f"{prefix}.mixer.dt_bias"]),
            "A_log": _t(sd[f"{prefix}.mixer.A_log"]),
            "D": _t(sd[f"{prefix}.mixer.D"]),
            "norm": {"weight": _t(sd[f"{prefix}.mixer.norm.weight"])},
            "out_proj": {"kernel": _t(sd[f"{prefix}.mixer.out_proj.weight"]).T.contiguous()},
            "lora": lora,
        },
    }


def _linear(sd: Mapping, name: str, bias: bool = True) -> Dict:
    out = {"kernel": _t(sd[f"{name}.weight"]).T.contiguous()}
    if bias:
        out["bias"] = _t(sd[f"{name}.bias"])
    return out


def convert_mamba_lm(sd: Mapping, cfg: MambaConfig, strict_vocab: bool = False) -> Dict:
    """A MambaLMHeadModel state dict -> the port's backbone tree (the heads
    are tied to the tables). A table shorter than the padded vocabulary
    grows by rows drawn from N(0, 0.02) with numpy seed 0, as
    ``resize_token_embeddings`` does, unless ``strict_vocab``."""
    emb = _t(sd["backbone.embedding.weight"])
    if not strict_vocab and emb.shape[0] < cfg.padded_vocab_size:
        rows = cfg.padded_vocab_size - emb.shape[0]
        pad = np.random.default_rng(0).normal(0, 0.02, (rows, emb.shape[1]))
        emb = torch.cat([emb, torch.from_numpy(pad.astype(np.float32)).to(emb.dtype)])
    params: Dict = {"embedding": emb}
    if cfg.t2i_task and "backbone.img_embeddings.word_embeddings.weight" in sd:
        pi = "backbone.img_embeddings.project_in.projector"
        params["img_embeddings"] = {
            "word_embeddings": _t(sd["backbone.img_embeddings.word_embeddings.weight"]),
            "project_in": {f"fc{i + 1}": _linear(sd, f"{pi}.{2 * i}") for i in range(3)},
        }
        params["pos_embed"] = _t(sd["backbone.pos_embed"])
        params["caption_embed"] = {
            f"fc{i}": _linear(sd, f"backbone.caption_embed.cap_proj.fc{i}", bias=False)
            for i in (1, 2)}
    if cfg.mmu_task and "backbone.mmu_pos_embed" in sd:
        params["mmu_pos_embed"] = _t(sd["backbone.mmu_pos_embed"])
    params["layers"] = [convert_mamba_layer(sd, f"backbone.layers.{i}", cfg)
                        for i in range(cfg.n_layer)]
    params["norm_f"] = {"weight": _t(sd["backbone.norm_f.weight"])}
    return params


def convert_omnimamba_checkpoint(sd: Mapping, cfg: MambaConfig) -> Dict:
    """A flat OmniMamba state dict -> {"mamba": ..., "projector": ...}, each
    where the checkpoint holds it."""
    out: Dict = {}
    mamba_sd = {k.removeprefix("llm_backbone.mamba."): v for k, v in sd.items()
                if k.startswith("llm_backbone.mamba.")}
    if mamba_sd:
        out["mamba"] = convert_mamba_lm(mamba_sd, cfg)
    if any(k.startswith("projector.projector.") for k in sd):
        out["projector"] = {f"fc{i + 1}": _linear(sd, f"projector.projector.{2 * i}")
                            for i in range(3)}
    return out


# ---------------------------------------------------------------------------
# VQ model
# ---------------------------------------------------------------------------


def _conv(sd, name) -> Dict:
    return {"kernel": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}


def _gn(sd, name) -> Dict:
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}


def _res_block(sd, p) -> Dict:
    out = {"norm1": _gn(sd, f"{p}.norm1"), "conv1": _conv(sd, f"{p}.conv1"),
           "norm2": _gn(sd, f"{p}.norm2"), "conv2": _conv(sd, f"{p}.conv2")}
    if f"{p}.nin_shortcut.weight" in sd:
        out["nin_shortcut"] = _conv(sd, f"{p}.nin_shortcut")
    return out


def _attn_block(sd, p) -> Dict:
    return {"norm": _gn(sd, f"{p}.norm"), **{k: _conv(sd, f"{p}.{k}") for k in
                                              ("q", "k", "v", "proj_out")}}


def _levels(sd, side: str, n_levels: int, n_res: int, resample: str):
    levels = []
    for i in range(n_levels):
        p = f"{side}.conv_blocks.{i}"
        lvl = {"res": [_res_block(sd, f"{p}.res.{j}") for j in range(n_res)],
               "attn": [_attn_block(sd, f"{p}.attn.{j}") for j in range(n_res)
                        if f"{p}.attn.{j}.q.weight" in sd]}
        if f"{p}.{resample}.conv.weight" in sd:
            lvl[resample] = _conv(sd, f"{p}.{resample}.conv")
        levels.append(lvl)
    return levels


def _mid(sd, side: str) -> Dict:
    return {"res1": _res_block(sd, f"{side}.mid.0"), "attn": _attn_block(sd, f"{side}.mid.1"),
            "res2": _res_block(sd, f"{side}.mid.2")}


def convert_vq(sd: Mapping, cfg: VQConfig) -> Dict:
    """A VQModel state dict -> the port's VQ tree (``models/vq.init_vq``):
    encoder, quant_conv, codebook, post_quant_conv and decoder."""
    sd = {k: v for k, v in sd.items() if "codebook_used" not in k}
    encoder = {
        "conv_in": _conv(sd, "encoder.conv_in"),
        "levels": _levels(sd, "encoder", len(cfg.encoder_ch_mult), cfg.num_res_blocks,
                          "downsample"),
        "mid": _mid(sd, "encoder"),
        "norm_out": _gn(sd, "encoder.norm_out"),
        "conv_out": _conv(sd, "encoder.conv_out"),
    }
    decoder = {
        "conv_in": _conv(sd, "decoder.conv_in"),
        "mid": _mid(sd, "decoder"),
        "levels": _levels(sd, "decoder", len(cfg.decoder_ch_mult), cfg.num_res_blocks + 1,
                          "upsample"),
        "norm_out": _gn(sd, "decoder.norm_out"),
        "conv_out": _conv(sd, "decoder.conv_out"),
    }
    return {
        "encoder": encoder,
        "decoder": decoder,
        "quant_conv": _conv(sd, "quant_conv"),
        "post_quant_conv": _conv(sd, "post_quant_conv"),
        "codebook": _t(sd["quantize.embedding.weight"]),
    }


# ---------------------------------------------------------------------------
# timm ViT
# ---------------------------------------------------------------------------


def resample_abs_pos_embed(pos, new_grid: int) -> torch.Tensor:
    """(1, g * g, d) patch-position table -> (1, new_grid ** 2, d): fp32
    bicubic interpolation with antialias (timm's ``resample_abs_pos_embed``),
    back in the table's type."""
    pos = _t(pos)
    _, n, d = pos.shape
    g = int(np.sqrt(n))
    if g * g != n:
        raise ValueError(f"the position table is not square: {n} rows")
    if g == new_grid:
        return pos
    grid = pos.reshape(1, g, g, d).float().permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(new_grid, new_grid), mode="bicubic", antialias=True)
    return out.permute(0, 2, 3, 1).reshape(1, new_grid * new_grid, d).to(pos.dtype)


def convert_timm_vit(sd: Mapping, cfg: ViTConfig) -> Dict:
    """A timm VisionTransformer state dict -> the port's tower
    (``models/vit.init_vit``). The position table keeps the patch rows only
    (a leading cls row is dropped) and is resampled to the config's grid
    where the checkpoint's differs."""
    pos = _t(sd["pos_embed"])
    n = pos.shape[1]
    if n == cfg.num_patches + 1 or (n != cfg.num_patches and int(np.sqrt(n)) ** 2 != n):
        pos = pos[:, 1:]  # embed_class layout: the cls position leads
    if pos.shape[1] != cfg.num_patches:
        pos = resample_abs_pos_embed(pos, cfg.grid)
    p: Dict = {
        "patch_embed": {"kernel": _t(sd["patch_embed.proj.weight"]),
                        "bias": _t(sd["patch_embed.proj.bias"])},
        "pos_embed": pos.contiguous(),
    }
    if cfg.use_cls_token:
        p["cls_token"] = _t(sd["cls_token"])
    if cfg.num_reg_tokens:
        p["reg_tokens"] = _t(sd["reg_token"])
    blocks = []
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        blk = {
            "norm1": _gn(sd, f"{b}.norm1"),
            "attn": {"qkv": _linear(sd, f"{b}.attn.qkv"), "proj": _linear(sd, f"{b}.attn.proj")},
            "norm2": _gn(sd, f"{b}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{b}.mlp.fc1"), "fc2": _linear(sd, f"{b}.mlp.fc2")},
        }
        if cfg.layerscale:
            blk["ls1"] = {"gamma": _t(sd[f"{b}.ls1.gamma"])}
            blk["ls2"] = {"gamma": _t(sd[f"{b}.ls2.gamma"])}
        blocks.append(blk)
    p["blocks"] = blocks
    p["norm"] = _gn(sd, "norm")
    return p
