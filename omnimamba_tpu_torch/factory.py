"""Model factory: the whole OmniMamba bundle from a ``TrainConfig``.
Counterpart of ``omnimamba_tpu/factory.py``.

The tokenizer and ``UniversalPrompting`` (the vocabulary grows 50277 ->
50287, the table pads to 50288), the model config from the registry, the
vision towers from ``VISION_BACKBONES``, a random init from ``seed``, then
the parameters of the port's own checkpoint where ``omnimamba_ckpt`` names
one (``utils/checkpoint.py``, a ``.pt`` file or its directory). The torch
state dicts of the published checkpoints (``.pth``, ``vq_ckpt``,
``mamba_pretrain``) need ``utils/convert``, which is not ported yet.
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


def load_pretrained_into(params: Dict, model: OmniMambaModel, train_cfg: TrainConfig) -> Dict:
    """``omnimamba_ckpt`` as a checkpoint of the port (``.pt`` or a
    checkpoint directory) goes into ``params``. A torch state dict of the
    published weights raises: its converter is not ported yet."""
    for field in ("vq_ckpt", "mamba_pretrain"):
        if getattr(train_cfg, field):
            raise NotImplementedError(
                f"{field}={getattr(train_cfg, field)!r}: torch state dicts need utils/convert, "
                "which is not ported yet (ROADMAP: Q1 item 2)")
    path = train_cfg.omnimamba_ckpt
    if not path:
        return params
    if not (path.endswith(".pt") or os.path.isdir(path)):
        raise NotImplementedError(
            f"omnimamba_ckpt={path!r}: a torch state dict needs utils/convert, which is not "
            "ported yet (ROADMAP: Q1 item 2); the port loads its own checkpoints (.pt or their "
            "directory, utils/checkpoint.py)")
    return load_params(path, params)
