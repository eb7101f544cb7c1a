"""Separable image resizing with the weights of ``jax.image.resize``.

``jax.image.resize`` (which the JAX package's ``vit_transform`` and the
ldpnet projector's token pooling call) builds one weight matrix a resized
axis and contracts the image with it. Its weights are not those of
``F.interpolate``: when it shrinks an axis it widens the kernel by the
shrink factor (antialiasing), and it renormalises each output's weights to
sum to one. This module builds the same matrices and applies them as
products, one axis after the other.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {
    "cubic": _keys_cubic, "bicubic": _keys_cubic,
    "linear": _triangle, "bilinear": _triangle, "triangle": _triangle,
}


def resize_weights(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """(in_size, out_size) fp32 weights: output j is the weighted sum of the
    inputs with column j. Half-centred pixels, the kernel widened by the
    shrink factor, each column normalised to sum 1, columns whose sample
    point lies outside the input zeroed."""
    if method not in _KERNELS:
        raise ValueError(f"unsupported resize method {method!r}")
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = _KERNELS[method]((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, sizes: Sequence[int], dims: Sequence[int], method: str) -> torch.Tensor:
    """Resize axes ``dims`` of ``x`` to ``sizes`` (``jax.image.resize`` with
    antialiasing); axes already at their size are left alone. The products
    run in x's type (fp32 for images)."""
    for d, n in zip(dims, sizes):
        d = d % x.dim()
        if x.shape[d] == n:
            continue
        w = resize_weights(x.shape[d], n, method, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
