"""Normalization ops with fused-add-norm semantics.

Counterpart of ``omnimamba_tpu/ops/norms.py``. The numerics contract:

- the residual stream accumulates in fp32
- the norm computes its statistics in fp32
- the normalized output is cast back to the activation dtype

``add_norm_plain`` and ``gated_rms_norm_plain`` are plain tensor code and
are the plain versions of the two forward kernels in ``norms_kernel.py``;
``add_norm_bwd_plain`` and ``gated_rms_norm_bwd_plain`` are those of the two
backward kernels. Under tp (``d_inner`` cut over heads) the gated norm runs in
partial-sum form: ``gated_norm_sums_plain`` / ``gated_norm_apply_plain``
forward and ``gated_norm_bwd_sums_plain`` / ``gated_norm_bwd_finish_plain``
backward, each row's sums all-reduced over the ranks between the two.
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


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm of the ViT towers with the JAX package's rounding: fp32 mean
    and variance, ``rsqrt``, then the weight and the bias in fp32, then a
    cast back to x.dtype."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


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


def gated_norm_sums_plain(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Each row's sum of u^2 over its columns, u = y silu(z), fp32 (...,):
    the partial sum a tp rank of the gated norm contributes."""
    u = y.float() * F.silu(z.float())
    return torch.sum(u * u, dim=-1)


def gated_norm_apply_plain(
    y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, sums: torch.Tensor, d: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """u rsqrt(sums / d + eps) w in y.dtype, with each row's sum of u^2 over
    the whole width ``d`` given (``sums``, fp32 (...,)): the gated norm of
    the rank's columns of a row whose sum was all-reduced over the tp ranks."""
    u = y.float() * F.silu(z.float())
    rstd = torch.rsqrt(sums.float()[..., None] / d + eps)
    return (u * rstd * weight.float()).to(y.dtype)


def gated_norm_bwd_sums_plain(
    y: torch.Tensor, z: torch.Tensor, g: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """Each row's sum of w g u over its columns, fp32 (...,): the backward's
    partial sum of a tp rank."""
    u = y.float() * F.silu(z.float())
    return torch.sum(weight.float() * g.float() * u, dim=-1)


def gated_norm_bwd_finish_plain(
    y: torch.Tensor, z: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
    sums: torch.Tensor, dots: torch.Tensor, d: int, eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``gated_rms_norm_bwd_plain`` on the rank's columns, with each row's
    sum of u^2 and of w g u over the whole width ``d`` given (fp32 (...,)):
    (dy, dz in y's type, dw fp32 of the rank's columns, summed over rows)."""
    yf, zf, gf, wf = y.float(), z.float(), g.float(), weight.float()
    sz = torch.sigmoid(zf)
    silu = zf * sz
    u = yf * silu
    rstd = torch.rsqrt(sums.float()[..., None] / d + eps)
    du = wf * gf * rstd - u * (rstd * rstd * rstd / d) * dots.float()[..., None]
    dy = du * silu
    dz = du * yf * (sz * (1.0 + zf * (1.0 - sz)))
    dw = torch.sum((gf * u * rstd).reshape(-1, y.shape[-1]), dim=0)
    return dy.to(y.dtype), dz.to(z.dtype), dw


def add_norm(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    weight: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused residual add + RMSNorm of a pre-norm block with an fp32 residual
    stream: returns (normed in x.dtype, new_residual fp32). The towers'
    LayerNorm is ``layer_norm``; no model of the port takes the JAX
    ``add_norm``'s bias and post-norm variants."""
    from omnimamba_tpu_torch.ops.norms_kernel import fused_add_rms_norm

    return fused_add_rms_norm(x, residual, weight, eps)


def gated_rms_norm(
    y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, tp=None
) -> torch.Tensor:
    """RMSNorm(y * silu(z)) * weight on the mixer stream. ``tp``: the tp cut
    of a mixer whose ``d_inner`` is cut over heads (``parallel/tensor.py``):
    y, z and weight are then the rank's columns and the row's statistics are
    summed over the ranks (``norms_kernel.fused_gated_rms_norm_tp``)."""
    from omnimamba_tpu_torch.ops.norms_kernel import fused_gated_rms_norm, fused_gated_rms_norm_tp

    if tp is not None:
        return fused_gated_rms_norm_tp(y, z, weight, eps, tp)
    return fused_gated_rms_norm(y, z, weight, eps)
