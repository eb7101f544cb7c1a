"""Vision -> language-model projection adapters. Counterpart of
``omnimamba_tpu/models/projector.py``.

The shipped model uses the fused GELU MLP (2176 -> 4 x 2176 -> d_model ->
d_model, exact GELU). ``linear``, ``gelu-mlp`` and the two ldpnet variants
(an MLP, token pooling to 14 x 14, and a 3 x 3 depthwise position conv with
a residual) are kept for the arch switch. The arch is an argument, not a
parameter. Linear kernels are ``(in, out)``; the ldpnet position conv's
kernel is ``(C, 1, 3, 3)`` OIHW.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.ops.resize import resize
from omnimamba_tpu_torch.parallel.tensor import row_parallel, tp_cut, tp_enter, tp_linear_cols
from omnimamba_tpu_torch.utils.device import resolve_device
from omnimamba_tpu_torch.utils.init import linear_uniform, uniform


def _apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def canonical_arch(arch: str) -> str:
    if arch == "linear":
        return "linear"
    if arch.endswith("fused-gelu-mlp"):
        return "fused-gelu-mlp"
    if arch.endswith("gelu-mlp"):
        return "gelu-mlp"
    if arch.endswith("fused-ldpnet"):
        return "fused-ldpnet"
    if arch.endswith("ldpnet"):
        return "ldpnet"
    raise ValueError(f"unsupported projector arch {arch}")


def _square_side(T: int) -> int:
    h = math.isqrt(T)
    if h * h != T:
        raise ValueError(f"{T} tokens are not a square grid")
    return h


def _token_down(x: torch.Tensor, out_hw: int = 14) -> torch.Tensor:
    """Pool a square token grid to (out_hw, out_hw): an average over whole
    windows where the side divides, else ``jax.image.resize``'s linear
    weights (27 -> 14 at 384 px)."""
    B, T, C = x.shape
    h = _square_side(T)
    g = x.reshape(B, h, h, C)
    if h % out_hw == 0:
        k = h // out_hw
        g = g.reshape(B, out_hw, k, out_hw, k, C).mean(dim=(2, 4))
    else:
        g = resize(g, (out_hw, out_hw), (1, 2), "linear")
    return g.reshape(B, out_hw * out_hw, C)


def _pos_inject(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """3 x 3 depthwise conv with 'same' padding, fp32 result and bias, plus
    the residual."""
    B, T, C = x.shape
    h = _square_side(T)
    g = x.reshape(B, h, h, C)
    kernel = p["peg"]["kernel"].to(x.dtype).float()
    y = F.conv2d(g.permute(0, 3, 1, 2).float(), kernel, padding=1, groups=C)
    y = (y + p["peg"]["bias"].float()[:, None, None]).permute(0, 2, 3, 1)
    return (y.to(x.dtype) + g).reshape(B, T, C)


def init_projector(generator: torch.Generator, vision_dim: int, llm_dim: int,
                   arch: str = "fused-gelu-mlp", dtype: torch.dtype = torch.float32,
                   device="cuda") -> Dict:
    """Random parameters with the JAX ``init_projector`` distributions: every
    linear layer and the position conv U(+-1/sqrt(fan_in))."""
    device = resolve_device(device)
    arch = canonical_arch(arch)
    lin = lambda a, b: linear_uniform(generator, a, b, dtype, device)  # noqa: E731
    if arch == "linear":
        return {"fc1": lin(vision_dim, llm_dim)}
    if arch == "fused-gelu-mlp":
        hidden = vision_dim * 4
        return {"fc1": lin(vision_dim, hidden), "fc2": lin(hidden, llm_dim),
                "fc3": lin(llm_dim, llm_dim)}
    if arch in ("ldpnet", "fused-ldpnet"):
        hidden = vision_dim * 4 if arch == "fused-ldpnet" else llm_dim
        bound = 1.0 / math.sqrt(9)  # depthwise 3 x 3
        return {"fc1": lin(vision_dim, hidden), "fc2": lin(hidden, llm_dim),
                "peg": {"kernel": uniform(generator, (llm_dim, 1, 3, 3), bound, dtype, device),
                        "bias": uniform(generator, (llm_dim,), bound, dtype, device)}}
    return {"fc1": lin(vision_dim, llm_dim), "fc2": lin(llm_dim, llm_dim)}


def apply_projector(params: Dict, x: torch.Tensor, arch: str = "fused-gelu-mlp") -> torch.Tensor:
    """The projector of ``arch`` on the towers' features. Under tp
    (``parallel/sharding.py``: fc1 by columns, fc2's kernel by rows) fc1
    runs on the rank's columns and fc2's partial product is summed over the
    ranks in fp32 and rounded once before its bias."""
    arch = canonical_arch(arch)
    tp = tp_cut(params["fc1"]["kernel"])
    if tp is not None:
        if arch == "linear":
            raise NotImplementedError(
                "tp cuts the projector's fc1 by columns: a linear projector has no fc2 to sum "
                "them back (use a mesh without tp)")
        h = F.gelu(tp_linear_cols(params["fc1"], tp_enter(x, tp), tp))
        h = (row_parallel(h, params["fc2"]["kernel"].to(h.dtype), tp)
             + params["fc2"]["bias"].to(h.dtype))
        if arch == "fused-gelu-mlp":
            return _apply(params["fc3"], F.gelu(h))
        if arch in ("ldpnet", "fused-ldpnet"):
            return _pos_inject(params, _token_down(h))
        return h
    if arch == "linear":
        return _apply(params["fc1"], x)
    if arch == "fused-gelu-mlp":
        h = F.gelu(_apply(params["fc1"], x))
        h = F.gelu(_apply(params["fc2"], h))
        return _apply(params["fc3"], h)
    if arch in ("ldpnet", "fused-ldpnet"):
        h = F.gelu(_apply(params["fc1"], x))
        h = _token_down(_apply(params["fc2"], h))
        return _pos_inject(params, h)
    h = F.gelu(_apply(params["fc1"], x))
    return _apply(params["fc2"], h)
