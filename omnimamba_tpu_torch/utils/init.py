"""Random initialisers drawing from an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import torch


def uniform(gen, shape, bound, dtype, device) -> torch.Tensor:
    """U(-bound, bound), drawn in fp32 and cast to ``dtype``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return ((2.0 * u - 1.0) * bound).to(dtype)


def normal(gen, shape, std, dtype, device) -> torch.Tensor:
    return (std * torch.randn(shape, generator=gen, dtype=torch.float32, device=device)).to(dtype)


def trunc_normal(gen, shape, std, dtype, device) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std, by inverting the CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    u = lo + u * (1.0 - 2.0 * lo)
    x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (std * x.clamp(-2.0, 2.0)).to(dtype)


def linear_uniform(gen, d_in, d_out, dtype, device) -> dict:
    """A linear layer ``{"kernel" (d_in, d_out), "bias"}`` with both drawn from
    U(+-1/sqrt(d_in)), as the JAX package's towers and projector draw them."""
    bound = 1.0 / math.sqrt(d_in)
    return {"kernel": uniform(gen, (d_in, d_out), bound, dtype, device),
            "bias": uniform(gen, (d_out,), bound, dtype, device)}
