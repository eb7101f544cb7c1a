"""Short causal depthwise conv1d in plain tensor code.

Counterpart of ``omnimamba_tpu/ops/conv.py`` (which has no kernel of its
own): the full-sequence form is a stack of shifted adds with fp32
accumulation, and the decode step updates a ``(batch, width-1, channels)``
rolling window. Layout ``(B, L, C)``, taps ``(W, C)`` with tap 0 the oldest.
The shifted-add form is kept (not ``F.conv1d``) so an fp32 run is exact fp32
on every device, with no TF32 convolution path involved.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _activate(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation == "silu":
        return F.silu(y)
    if activation is None or activation == "none":
        return y
    raise ValueError(f"unsupported activation {activation}")


def causal_conv1d(
    x: torch.Tensor,  # (B, L, C)
    weight: torch.Tensor,  # (W, C) depthwise taps, tap 0 = oldest
    bias: Optional[torch.Tensor] = None,  # (C,)
    *,
    activation: Optional[str] = "silu",
    initial_state: Optional[torch.Tensor] = None,  # (B, W-1, C) left context
) -> torch.Tensor:
    """y[t] = act(sum_k w[k] * x[t - (W-1) + k] + b), causal (left) padding.

    ``initial_state`` supplies the W-1 tokens of left context when a sequence
    continues from a cached conv state; zeros otherwise.
    """
    B, L, C = x.shape
    W = weight.shape[0]
    if initial_state is None:
        pad = x.new_zeros((B, W - 1, C))
    else:
        pad = initial_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1).float()  # (B, L+W-1, C)
    wf = weight.float()
    y = torch.zeros((B, L, C), dtype=torch.float32, device=x.device)
    for k in range(W):
        y = y + xp[:, k : k + L, :] * wf[k]
    if bias is not None:
        y = y + bias.float()
    return _activate(y, activation).to(x.dtype)


def conv_state_from_sequence(
    x: torch.Tensor, width: int, initial_state: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Final rolling conv state after consuming x: the last (width-1) inputs,
    shape (B, width-1, C). Where L < width-1 the remainder comes from
    ``initial_state`` (zeros by default)."""
    B, L, C = x.shape
    keep = width - 1
    if initial_state is None:
        initial_state = x.new_zeros((B, keep, C))
    full = torch.cat([initial_state.to(x.dtype), x], dim=1)
    return full[:, full.shape[1] - keep :, :]


def causal_conv1d_step(
    x_t: torch.Tensor,  # (B, C) new token
    conv_state: torch.Tensor,  # (B, W-1, C) previous inputs (oldest first)
    weight: torch.Tensor,  # (W, C)
    bias: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token step of the conv. Returns (y_t, new_conv_state); the new
    state is a fresh tensor, ``conv_state`` is not modified."""
    window = torch.cat([conv_state, x_t[:, None, :].to(conv_state.dtype)], dim=1)
    y = torch.sum(window.float() * weight.float()[None], dim=1)
    if bias is not None:
        y = y + bias.float()
    return _activate(y, activation).to(x_t.dtype), window[:, 1:, :]
