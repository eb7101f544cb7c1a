"""Pre-norm residual block around a Mamba-2 mixer.

Counterpart of ``omnimamba_tpu/models/blocks.py``: the order is
Add -> Norm -> Mixer, returning (mixer_out, new_residual) with the residual
kept in fp32. The attention mixer (``layer_type="mha"``) and the second
Add -> Norm -> GatedMLP sub-block (``d_intermediate > 0``) are dormant in
every shipped config and are not ported yet; asking for them raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from omnimamba_tpu_torch.config import LoraConfig, Mamba2LayerConfig
from omnimamba_tpu_torch.models.mamba2 import Mamba2Cache, mamba2_forward, mamba2_step
from omnimamba_tpu_torch.ops.norms import add_norm


def _check_supported(layer_params: Dict, layer_type: str) -> None:
    if layer_type != "mamba2":
        raise NotImplementedError(
            f"layer_type={layer_type!r}: attention layers (attn_layer_idx) arrive "
            "with ops/attention (ROADMAP: slice 6)"
        )
    if "mlp" in layer_params:
        raise NotImplementedError(
            "d_intermediate > 0: the GatedMLP sub-block arrives with ops/attention (ROADMAP: slice 6)"
        )


def block_forward(
    layer_params: Dict,
    hidden: torch.Tensor,  # (B, L, d) activation dtype
    residual: Optional[torch.Tensor],  # (B, L, d) fp32 or None (first block)
    task: Optional[str],
    cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    *,
    norm_eps: float = 1e-5,
    return_cache: bool = False,
    layer_type: str = "mamba2",
    initial_cache: Optional[Mamba2Cache] = None,
    valid_len=None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Mamba2Cache]]:
    """One block, full-sequence. ``initial_cache``/``valid_len``/``generator``:
    see ``mamba2.mamba2_forward``."""
    _check_supported(layer_params, layer_type)
    normed, new_residual = add_norm(
        hidden, residual, layer_params["norm"]["weight"], norm_eps)
    out, cache = mamba2_forward(
        layer_params["mixer"], normed, task, cfg, lora_cfg,
        return_cache=return_cache,
        initial_cache=initial_cache, valid_len=valid_len, generator=generator,
    )
    return out, new_residual, cache


def block_step(
    layer_params: Dict,
    hidden: torch.Tensor,  # (B, d)
    residual: Optional[torch.Tensor],
    cache: Mamba2Cache,
    task: Optional[str],
    cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    *,
    norm_eps: float = 1e-5,
    layer_type: str = "mamba2",
) -> Tuple[torch.Tensor, torch.Tensor, Mamba2Cache]:
    """One block, one decode token. ``cache`` is updated in place."""
    _check_supported(layer_params, layer_type)
    normed, new_residual = add_norm(
        hidden, residual, layer_params["norm"]["weight"], norm_eps)
    out, cache = mamba2_step(layer_params["mixer"], normed, cache, task, cfg, lora_cfg)
    return out, new_residual, cache
