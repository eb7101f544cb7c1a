"""Model factory: the whole OmniMamba bundle from a ``TrainConfig``.
Counterpart of ``omnimamba_tpu/factory.py``.

The tokenizer and ``UniversalPrompting`` (the vocabulary grows 50277 ->
50287, the table pads to 50288), the model config from the registry, the
vision towers from ``VISION_BACKBONES``, a random init from ``seed``, then
the checkpoints the config names (``load_pretrained_into``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch

from omnimamba_tpu_torch.config import (
    MODEL_REGISTRY,
    VISION_BACKBONES,
    MambaConfig,
    TrainConfig,
    VisionConfig,
    VQConfig,
)
from omnimamba_tpu_torch.data.prompting import UniversalPrompting
from omnimamba_tpu_torch.data.tokenizer import load_text_tokenizer
from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel, init_omnimamba
from omnimamba_tpu_torch.train.optimizer import named_leaves
from omnimamba_tpu_torch.utils import convert
from omnimamba_tpu_torch.utils.checkpoint import load_params
from omnimamba_tpu_torch.utils.device import resolve_device


def build_model(
    train_cfg: TrainConfig,
    *,
    stage: Optional[str] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    with_vision: Optional[bool] = None,
    with_vq: Optional[bool] = None,
    device="cuda",
) -> Tuple[OmniMambaModel, Dict, UniversalPrompting]:
    """Returns (model, params, uni_prompting). ``with_vision`` / ``with_vq``
    default to the config's mmu / t2i task switches. ``stage`` is taken for
    the JAX factory's interface: every stage builds the same tree."""
    device = resolve_device(device)
    tokenizer = load_text_tokenizer()
    uni = UniversalPrompting(tokenizer)

    cfg: MambaConfig = MODEL_REGISTRY[train_cfg.omnimamba_model]()
    cfg = dataclasses.replace(cfg, t2i_task=train_cfg.t2i_task, mmu_task=train_cfg.mmu_task)
    cfg = cfg.resized(len(tokenizer))  # 50287 -> 50288
    vision_cfg = VISION_BACKBONES.get(train_cfg.image_backbone, VisionConfig)()
    model = OmniMambaModel(cfg=cfg, vq_cfg=VQConfig(), sptids=uni.sptids_dict,
                           vision_cfg=vision_cfg)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = init_omnimamba(
        generator, model, dtype, device,
        with_vision=train_cfg.mmu_task if with_vision is None else with_vision,
        with_vq=train_cfg.t2i_task if with_vq is None else with_vq)
    return model, load_pretrained_into(params, model, train_cfg), uni


def _copy_into(params, converted, what: str) -> None:
    """Copy every leaf of ``converted`` into the leaf of the same path in
    ``params``, cast to its type on its device. A converted leaf with no
    place or another shape raises; leaves the checkpoint lacks keep their
    values (the reference loads with ``strict=False``)."""
    live = dict(named_leaves(params))
    new = dict(named_leaves(converted))
    unknown = sorted(set(new) - set(live))
    if unknown:
        raise ValueError(f"{what}: {len(unknown)} leaves have no place in the model: {unknown[:8]}")
    with torch.no_grad():
        for name, t in new.items():
            if tuple(t.shape) != tuple(live[name].shape):
                raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, the model "
                                 f"{tuple(live[name].shape)}")
            live[name].copy_(t.to(live[name].dtype))


def load_pretrained_into(params: Dict, model: OmniMambaModel, train_cfg: TrainConfig) -> Dict:
    """The checkpoints the config names, in the reference's order, into
    ``params``: ``vq_ckpt`` (a LlamaGen VQModel state dict) where the tree
    has a VQ; then ``omnimamba_ckpt``, either the port's own checkpoint (a
    ``.pt`` file or its directory, ``utils/checkpoint.py``) or a published
    OmniMamba state dict (backbone and projector, where the tree has them);
    else ``mamba_pretrain`` (a MambaLMHeadModel state dict, into the
    backbone). State dicts go through ``utils/convert``."""
    if train_cfg.vq_ckpt and "vq" in params:
        sd = convert.load_torch_state_dict(train_cfg.vq_ckpt)
        _copy_into(params["vq"], convert.convert_vq(sd, model.vq_cfg), train_cfg.vq_ckpt)
    path = train_cfg.omnimamba_ckpt
    if path:
        if path.endswith(".pt") or os.path.isdir(path):
            return load_params(path, params)
        converted = convert.convert_omnimamba_checkpoint(
            convert.load_torch_state_dict(path), model.cfg)
        for key, tree in converted.items():
            if key in params:  # projector weights without the mmu task are skipped
                _copy_into(params[key], tree, path)
    elif train_cfg.mamba_pretrain:
        sd = convert.load_torch_state_dict(train_cfg.mamba_pretrain)
        _copy_into(params["mamba"], convert.convert_mamba_lm(sd, model.cfg),
                   train_cfg.mamba_pretrain)
    return params
