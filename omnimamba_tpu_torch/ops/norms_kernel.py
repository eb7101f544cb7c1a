"""The two norms of a Mamba-2 block as CUDA kernels, forward and backward.

``fused_add_rms_norm`` replaces the TPU kernels ``_fwd_kernel`` /
``_bwd_kernel`` (``fused_add_rms_norm`` and its VJP) and
``fused_gated_rms_norm`` replaces ``_gated_fwd_kernel`` /
``_gated_bwd_kernel`` of ``omnimamba_tpu/ops/norms_pallas.py``.
Source: ``csrc/norms.cu``.

What bounds them on an H100: bytes. Each is one pass over a row with one
reduction and no matrix product. The design reads every input once, keeps
the row in shared memory as fp32 between the reduction and the second pass,
and writes every output once, with 16-byte accesses where the row allows it.
Inputs go in with a row stride, so the gate z, a column slice of the in_proj
output, is read where it lies, without a copy.
The TPU kernel's row tile sized to its on-chip memory and its row padding
have no counterpart: a forward block takes one row; a backward grid is a
fixed number of blocks, each walking its rows and keeping its share of dw in
shared memory, and a second kernel sums those shares in block order (the TPU
grid is sequential and accumulates dw in one output block). No atomics: a
backward gives the same bits on every run.

At decode's few rows (bf16, width 1024 E with E <= 4, at most 256 rows)
both forwards take one kernel of their own, ``norm_rows_kernel``: a thread
for every four elements of a row, the row kept in registers, launched as a
programmatic dependent of the kernel ahead of it so that its launch and a
prefetch of its weight into L2 overlap that kernel's end. It reads every
input only after that kernel has ended, so that kernel may be the one that
wrote any of them. Its sums and products are the other kernels', so out and y
have the same bits.

The gated backward's bf16 rows of width 1024 J (J <= 4, starts on 16 bytes:
every call of the training path) take a kernel of their own: y and z kept
bf16 in a two-stage shared-memory ring that bulk copies fill, g read from
L2, the next row requested while the current one finishes, sigmoid(z)
computed once, the block's dw share in shared memory and summed by a kernel
that keeps many partial rows in flight. Four of its blocks fit on an SM, so
the grid of ``BWD_BLOCKS`` runs in one wave; its rows, sums and order are
the other kernel's, so dy, dz and dw have the same bits.

Both wrappers are differentiable: where a gradient is asked for they run
through ``torch.autograd.Function``s that save what the JAX VJPs save
(``(y, w)``; ``(y, z, w)``; rstd is recomputed) and whose backward is the
backward kernel. An absent cotangent of the residual stream is ``None``: the
kernel gets a null pointer and reads nothing in its place.

For a tensor on the CPU the wrappers use the plain versions from
``norms.py``, forward and backward; for a CUDA tensor they launch the kernel
or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from omnimamba_tpu_torch.ops import kernel_build as kb
from omnimamba_tpu_torch.ops.norms import (
    add_norm_bwd_plain,
    add_norm_plain,
    gated_rms_norm_bwd_plain,
    gated_rms_norm_plain,
)

BWD_BLOCKS = 528  # most blocks of a backward grid: four on each of an H100's 132 SMs


def _check_weight(weight: torch.Tensor, d: int, device: torch.device) -> torch.Tensor:
    if weight.shape != (d,) or weight.device != device:
        raise ValueError(f"weight must be ({d},) on {device}, got {tuple(weight.shape)} on {weight.device}")
    return weight.contiguous()


def _vectorizable(d: int, strides, tensors) -> int:
    return int(d % 4 == 0 and all(s % 4 == 0 for s in strides)
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _add_norm_forward(x, residual, weight, eps):
    """The forward kernel (plain version for a CPU tensor), outside autograd."""
    if not x.is_cuda:
        return add_norm_plain(x, residual, weight, eps)
    d = x.shape[-1]
    x2, x_rs = kb.as_rows(x, 1)
    w = _check_weight(weight, d, x.device)
    res2, res_rs = None, 0
    if residual is not None:
        if residual.dtype != torch.float32 or residual.shape != x.shape or residual.device != x.device:
            raise ValueError("residual must be float32 with x's shape and device")
        res2, res_rs = kb.as_rows(residual, 1)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    y = torch.empty_like(x, dtype=torch.float32, memory_format=torch.contiguous_format)
    rows = x.numel() // d if d else 0
    if rows:
        ptrs = [x2, w, out, y] + ([res2] if res2 is not None else [])
        err = kb.load_kernels().omt_add_rms_norm(
            x2.data_ptr(), None if res2 is None else res2.data_ptr(), w.data_ptr(),
            out.data_ptr(), y.data_ptr(), x_rs, res_rs, rows, d, float(eps),
            kb.dtype_code(x2.dtype), kb.dtype_code(w.dtype),
            _vectorizable(d, (x_rs, res_rs), ptrs), kb.current_stream(x.device),
        )
        kb.check_launch(err, "fused_add_rms_norm")
        fused_add_rms_norm.launches += 1
    return out, y


def fused_add_rms_norm_bwd(
    y: torch.Tensor,  # (..., d) float32: the forward's second output
    g: torch.Tensor,  # (..., d) cotangent of the normed output, float32 or bfloat16
    weight: torch.Tensor,  # (d,)
    dres: Optional[torch.Tensor],  # (..., d) float32 cotangent of y, or None
    eps: float = 1e-5,
    *,
    with_dy: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Backward of ``fused_add_rms_norm``: (dx in g's type, dy fp32 for the
    incoming residual or None without ``with_dy``, dw fp32). Numerics of
    ``norms.add_norm_bwd_plain``."""
    if not y.is_cuda:
        dx, dy, dw = add_norm_bwd_plain(y, g, weight, dres, eps)
        return dx, (dy if with_dy else None), dw
    d = y.shape[-1]
    if y.dtype != torch.float32 or g.shape != y.shape or g.device != y.device:
        raise ValueError("y must be float32 and g must have y's shape and device")
    y2 = y.contiguous()
    g2, g_rs = kb.as_rows(g, 1)
    w = _check_weight(weight, d, y.device)
    dres2, dres_rs = None, 0
    if dres is not None:
        if dres.dtype != torch.float32 or dres.shape != y.shape or dres.device != y.device:
            raise ValueError("dres must be float32 with y's shape and device")
        dres2, dres_rs = kb.as_rows(dres, 1)
    rows = y.numel() // d if d else 0
    blocks = max(1, min(rows, BWD_BLOCKS))
    dx = torch.empty(y.shape, dtype=g.dtype, device=y.device)
    dy = torch.empty(y.shape, dtype=torch.float32, device=y.device) if with_dy else None
    dw = torch.zeros((d,), dtype=torch.float32, device=y.device)
    if rows:
        dw_part = torch.empty((blocks, d), dtype=torch.float32, device=y.device)
        ptrs = [y2, g2, w, dx, dw_part] + [t for t in (dres2, dy) if t is not None]
        err = kb.load_kernels().omt_add_rms_norm_bwd(
            y2.data_ptr(), g2.data_ptr(), w.data_ptr(),
            None if dres2 is None else dres2.data_ptr(), dx.data_ptr(),
            None if dy is None else dy.data_ptr(), dw.data_ptr(), dw_part.data_ptr(),
            g_rs, dres_rs, rows, d, float(eps), kb.dtype_code(g2.dtype), kb.dtype_code(w.dtype),
            _vectorizable(d, (g_rs, dres_rs), ptrs), blocks, kb.current_stream(y.device),
        )
        kb.check_launch(err, "fused_add_rms_norm_bwd")
        fused_add_rms_norm_bwd.launches += 1
    return dx, dy, dw


class _AddRmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, weight, eps):
        out, y = _add_norm_forward(x, residual, weight, eps)
        ctx.eps, ctx.has_res, ctx.x_dtype = eps, residual is not None, x.dtype
        ctx.save_for_backward(y, weight)
        ctx.set_materialize_grads(False)
        return out, y

    @staticmethod
    @once_differentiable
    def backward(ctx, g, dres):
        y, weight = ctx.saved_tensors
        if g is None:  # only the stream was used downstream
            g = torch.zeros(y.shape, dtype=ctx.x_dtype, device=y.device)
        dx, dy, dw = fused_add_rms_norm_bwd(y, g, weight, dres, ctx.eps, with_dy=ctx.has_res)
        return dx, dy, dw.to(weight.dtype), None


def fused_add_rms_norm(
    x: torch.Tensor,  # (..., d) float32 or bfloat16
    residual: Optional[torch.Tensor],  # (..., d) float32, or None (first block)
    weight: torch.Tensor,  # (d,)
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + residual) -> RMSNorm; returns (normed in x.dtype, y fp32) with
    y = x + residual the new residual stream. Same numerics as
    ``norms.add_norm_plain``. Differentiable in x, residual and weight."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, residual, weight)):
        return _AddRmsNorm.apply(x, residual, weight, eps)
    return _add_norm_forward(x, residual, weight, eps)


def _gated_norm_forward(y, z, weight, eps):
    """The forward kernel (plain version for a CPU tensor), outside autograd."""
    if not y.is_cuda:
        return gated_rms_norm_plain(y, z, weight, eps)
    if z.shape != y.shape or z.dtype != y.dtype or z.device != y.device:
        raise ValueError("z must match y in shape, dtype and device")
    d = y.shape[-1]
    (y2, y_rs), (z2, z_rs) = kb.as_rows(y, 1), kb.as_rows(z, 1)
    w = _check_weight(weight, d, y.device)
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    rows = y.numel() // d if d else 0
    if rows:
        err = kb.load_kernels().omt_gated_rms_norm(
            y2.data_ptr(), z2.data_ptr(), w.data_ptr(), out.data_ptr(), y_rs, z_rs, rows, d,
            float(eps), kb.dtype_code(y2.dtype), kb.dtype_code(w.dtype),
            _vectorizable(d, (y_rs, z_rs), (y2, z2, w, out)), kb.current_stream(y.device),
        )
        kb.check_launch(err, "fused_gated_rms_norm")
        fused_gated_rms_norm.launches += 1
    return out


def fused_gated_rms_norm_bwd(
    y: torch.Tensor,  # (..., d)
    z: torch.Tensor,  # (..., d) same dtype
    g: torch.Tensor,  # (..., d) cotangent of the output, same dtype
    weight: torch.Tensor,  # (d,)
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``fused_gated_rms_norm``: (dy, dz in y's type, dw fp32).
    Numerics of ``norms.gated_rms_norm_bwd_plain``."""
    if not y.is_cuda:
        return gated_rms_norm_bwd_plain(y, z, g, weight, eps)
    for name, t in (("z", z), ("g", g)):
        if t.shape != y.shape or t.dtype != y.dtype or t.device != y.device:
            raise ValueError(f"{name} must match y in shape, dtype and device")
    d = y.shape[-1]
    (y2, y_rs), (z2, z_rs), (g2, g_rs) = kb.as_rows(y, 1), kb.as_rows(z, 1), kb.as_rows(g, 1)
    w = _check_weight(weight, d, y.device)
    rows = y.numel() // d if d else 0
    blocks = max(1, min(rows, BWD_BLOCKS))
    dy = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    dz = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    dw = torch.zeros((d,), dtype=torch.float32, device=y.device)
    if rows:
        dw_part = torch.empty((blocks, d), dtype=torch.float32, device=y.device)
        err = kb.load_kernels().omt_gated_rms_norm_bwd(
            y2.data_ptr(), z2.data_ptr(), g2.data_ptr(), w.data_ptr(), dy.data_ptr(),
            dz.data_ptr(), dw.data_ptr(), dw_part.data_ptr(), y_rs, z_rs, g_rs, rows, d,
            float(eps), kb.dtype_code(y2.dtype), kb.dtype_code(w.dtype),
            _vectorizable(d, (y_rs, z_rs, g_rs), (y2, z2, g2, w, dy, dz, dw_part)), blocks,
            kb.current_stream(y.device),
        )
        kb.check_launch(err, "fused_gated_rms_norm_bwd")
        fused_gated_rms_norm_bwd.launches += 1
    return dy, dz, dw


def gated_bwd_blocks_per_sm(y, z, g, weight) -> int:
    """Blocks per SM of the kernel ``fused_gated_rms_norm_bwd`` launches for
    these CUDA tensors: its grid of at most ``BWD_BLOCKS`` runs in one wave
    where this times the SMs reaches ``BWD_BLOCKS``."""
    if not y.is_cuda:
        raise ValueError("gated_bwd_blocks_per_sm asks the card about its kernels: give CUDA tensors")
    d = y.shape[-1]
    (y2, y_rs), (z2, z_rs), (g2, g_rs) = kb.as_rows(y, 1), kb.as_rows(z, 1), kb.as_rows(g, 1)
    w = _check_weight(weight, d, y.device)
    n = kb.load_kernels().omt_gated_rms_norm_bwd_blocks_per_sm(
        y_rs, z_rs, g_rs, d, kb.dtype_code(y2.dtype), kb.dtype_code(w.dtype),
        _vectorizable(d, (y_rs, z_rs, g_rs), (y2, z2, g2, w)))
    if n < 0:
        kb.check_launch(-n, "gated_bwd_blocks_per_sm")
    return n


class _GatedRmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, z, weight, eps):
        ctx.eps = eps
        ctx.save_for_backward(y, z, weight)
        return _gated_norm_forward(y, z, weight, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y, z, weight = ctx.saved_tensors
        dy, dz, dw = fused_gated_rms_norm_bwd(y, z, g, weight, ctx.eps)
        return dy, dz, dw.to(weight.dtype), None


def fused_gated_rms_norm(
    y: torch.Tensor,  # (..., d)
    z: torch.Tensor,  # (..., d) same dtype
    weight: torch.Tensor,  # (d,)
    eps: float = 1e-5,
) -> torch.Tensor:
    """RMSNorm(y * silu(z)) * weight in y.dtype; numerics of
    ``norms.gated_rms_norm_plain``. Differentiable in y, z and weight."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, z, weight)):
        return _GatedRmsNorm.apply(y, z, weight, eps)
    return _gated_norm_forward(y, z, weight, eps)


# kernel launches since the counter was last set to 0 (plain-version calls do not count)
fused_add_rms_norm.launches = 0
fused_gated_rms_norm.launches = 0
fused_add_rms_norm_bwd.launches = 0
fused_gated_rms_norm_bwd.launches = 0
