"""Short causal depthwise conv1d in plain tensor code.

Counterpart of ``omnimamba_tpu/ops/conv.py`` (which has no kernel of its
own): the full-sequence form is a stack of shifted adds with fp32
accumulation, and the decode step updates a ``(batch, width-1, channels)``
rolling window. Layout ``(B, L, C)``, taps ``(W, C)`` with tap 0 the oldest.
The shifted-add form is kept (not ``F.conv1d``) so an fp32 run is exact fp32
on every device, with no TF32 convolution path involved.

The training forward takes the conv + SiLU from a zero state as one
``torch.autograd.Function`` (``causal_conv1d_train``) whose backward is
written out (``causal_conv1d_bwd``): a checkpoint policy can then keep its
output and skip the whole chain in the backward's second forward
(``ops/remat.py``). It keeps only its inputs for the backward, which repeats
the pre-activation sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.ops.remat import kept


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


def causal_conv1d_bwd(g, x, weight, bias, needs=(True, True, True)):
    """Backward of ``causal_conv1d(x, weight, bias)`` with the SiLU and a zero
    initial state: (dx, dweight, dbias) in the types of the inputs, each None
    where ``needs`` says it is not asked for (dbias also without a bias). The
    pre-activation sums are repeated in fp32; every sum is in fp32."""
    L, W = x.shape[1], weight.shape[0]
    wf = weight.float()
    # u[t] = sum_k w[k] x[t - (W-1) + k] + b: tap k reaches s = W-1-k steps back
    u = x.float() * wf[W - 1]
    if bias is not None:
        u += bias.float()
    for k in range(W - 1):
        s = W - 1 - k
        if s < L:
            u[:, s:].addcmul_(x[:, : L - s], wf[k])
    gu = torch.ops.aten.silu_backward(g.float(), u)
    del u
    dx = dw = db = None
    if needs[0]:
        # x[t] feeds y[t + s] through tap k
        dx = gu * wf[W - 1]
        for k in range(W - 1):
            s = W - 1 - k
            if s < L:
                dx[:, : L - s].addcmul_(gu[:, s:], wf[k])
        dx = dx.to(x.dtype)
    if needs[1]:
        dw = torch.stack([
            (x[:, : L - (W - 1 - k)].float() * gu[:, W - 1 - k:]).sum(dim=(0, 1))
            if W - 1 - k < L else torch.zeros_like(wf[k])
            for k in range(W)]).to(weight.dtype)
    if needs[2] and bias is not None:
        db = gu.sum(dim=(0, 1)).to(bias.dtype)
    return dx, dw, db


class _CausalConv1d(torch.autograd.Function):
    """The conv + SiLU from a zero state as a named intermediate
    (``ops/remat.py``); its backward keeps only the inputs."""

    @staticmethod
    def forward(ctx, x, weight, bias, names):
        ctx.save_for_backward(x, weight, bias)
        return kept(names, lambda: causal_conv1d(x, weight, bias))

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        return (*causal_conv1d_bwd(g, x, weight, bias, ctx.needs_input_grad[:3]), None)


def causal_conv1d_train(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                        names: Tuple[str, ...]) -> torch.Tensor:
    """``causal_conv1d(x, weight, bias)`` with the SiLU from a zero state, for
    the training forward: a checkpoint policy naming any of ``names`` keeps
    its output."""
    return _CausalConv1d.apply(x, weight, bias, names)
