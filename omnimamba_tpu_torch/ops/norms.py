"""Normalization ops with fused-add-norm semantics.

Counterpart of ``omnimamba_tpu/ops/norms.py``. The numerics contract:

- the residual stream accumulates in fp32
- the norm computes its statistics in fp32
- the normalized output is cast back to the activation dtype

``add_norm_plain`` and ``gated_rms_norm_plain`` are plain tensor code and
are the plain versions of the two forward kernels in ``norms_kernel.py``;
``add_norm_bwd_plain`` and ``gated_rms_norm_bwd_plain`` are those of the two
backward kernels.
``add_norm`` and ``gated_rms_norm`` are what the model calls: they go to
the kernel wrappers, which launch the kernel for a CUDA tensor and use the
plain version for a CPU tensor. There is no size guard and no switch: a
CUDA tensor always takes the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 statistics; output in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def add_norm_plain(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    weight: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """new_residual = x + residual in fp32; normed = RMSNorm(new_residual) * w
    in x.dtype. ``residual=None`` is the first block. Returns both."""
    new_residual = x.float() if residual is None else x.float() + residual.float()
    return rms_norm(new_residual, weight, eps).to(x.dtype), new_residual


def gated_rms_norm_plain(
    y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Mamba-2's RMSNormGated with norm_before_gate=False:
    out = RMSNorm(y * silu(z)) * weight, in y.dtype."""
    u = y.float() * F.silu(z.float())
    var = torch.mean(u * u, dim=-1, keepdim=True)
    return (u * torch.rsqrt(var + eps) * weight.float()).to(y.dtype)


def add_norm_bwd_plain(
    y: torch.Tensor,  # (..., d) fp32: the saved stream x + residual
    g: torch.Tensor,  # (..., d) cotangent of the normed output, in x's type
    weight: torch.Tensor,  # (d,)
    dres: Optional[torch.Tensor],  # (..., d) fp32 cotangent of the stream, or None
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``add_norm_plain``, rstd recomputed from ``y``, fp32
    throughout: dy = w g rstd - y rstd^3/d sum(w g y) (+ dres). Returns
    (dx = dy in g's type, dy fp32: the cotangent of the incoming residual,
    dw fp32 summed over rows)."""
    d = y.shape[-1]
    yf, gf, wf = y.float(), g.float(), weight.float()
    rstd = torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    wg = wf * gf
    dot = torch.sum(wg * yf, dim=-1, keepdim=True)
    dy = wg * rstd - yf * (rstd * rstd * rstd / d) * dot
    if dres is not None:
        dy = dy + dres.float()
    dw = torch.sum((gf * yf * rstd).reshape(-1, d), dim=0)
    return dy.to(g.dtype), dy, dw


def gated_rms_norm_bwd_plain(
    y: torch.Tensor,  # (..., d)
    z: torch.Tensor,  # (..., d)
    g: torch.Tensor,  # (..., d) cotangent of the output
    weight: torch.Tensor,  # (d,)
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``gated_rms_norm_plain`` through u = y silu(z), fp32
    throughout. Returns (dy in y's type, dz in z's type, dw fp32 summed over
    rows)."""
    d = y.shape[-1]
    yf, zf, gf, wf = y.float(), z.float(), g.float(), weight.float()
    sz = torch.sigmoid(zf)
    silu = zf * sz
    u = yf * silu
    rstd = torch.rsqrt(torch.mean(u * u, dim=-1, keepdim=True) + eps)
    wg = wf * gf
    dot = torch.sum(wg * u, dim=-1, keepdim=True)
    du = wg * rstd - u * (rstd * rstd * rstd / d) * dot
    dy = du * silu
    dz = du * yf * (sz * (1.0 + zf * (1.0 - sz)))  # d silu / dz = s (1 + z (1 - s))
    dw = torch.sum((gf * u * rstd).reshape(-1, d), dim=0)
    return dy.to(y.dtype), dz.to(z.dtype), dw


def add_norm(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    weight: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused residual add + RMSNorm of a pre-norm block with an fp32 residual
    stream: returns (normed in x.dtype, new_residual fp32). The LayerNorm,
    bias and post-norm variants of the JAX ``add_norm`` belong to the ViT
    towers and arrive with them."""
    from omnimamba_tpu_torch.ops.norms_kernel import fused_add_rms_norm

    return fused_add_rms_norm(x, residual, weight, eps)


def gated_rms_norm(
    y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """RMSNorm(y * silu(z)) * weight on the mixer stream."""
    from omnimamba_tpu_torch.ops.norms_kernel import fused_gated_rms_norm

    return fused_gated_rms_norm(y, z, weight, eps)
