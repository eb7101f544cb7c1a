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

Under tp over heads (``d_inner`` cut, ``parallel/tensor.py``) the gated
norm runs in partial-sum form, K3b-tp and K6b-tp (``fused_gated_rms_norm_tp``):
the K3b and K6b kernels run twice with their row-sums switch (``RowSums`` in
``csrc/norms.cu``), first writing each row's fp32 partial sum over the
rank's columns, then, after an all-reduce of those sums over the tp ranks,
reading them in place of their own.

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
    gated_norm_apply_plain,
    gated_norm_bwd_finish_plain,
    gated_norm_bwd_sums_plain,
    gated_norm_sums_plain,
    gated_rms_norm_bwd_plain,
    gated_rms_norm_plain,
)
from omnimamba_tpu_torch.parallel.tensor import tp_all_reduce

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


def gated_bwd_kernel_of(y, z, g, weight) -> str:
    """Name of the kernel ``fused_gated_rms_norm_bwd`` launches for these CUDA
    tensors, by the test its C launcher branches on."""
    if not y.is_cuda:
        raise ValueError("gated_bwd_kernel_of asks the card's launcher: give CUDA tensors")
    d = y.shape[-1]
    (y2, y_rs), (z2, z_rs), (g2, g_rs) = kb.as_rows(y, 1), kb.as_rows(z, 1), kb.as_rows(g, 1)
    w = _check_weight(weight, d, y.device)
    row = kb.load_kernels().omt_gated_rms_norm_bwd_row_kernel_taken(
        y_rs, z_rs, g_rs, d, kb.dtype_code(y2.dtype),
        _vectorizable(d, (y_rs, z_rs, g_rs), (y2, z2, g2, w)))
    return "gated_rms_norm_bwd_row_kernel" if row else "gated_rms_norm_bwd_kernel"


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


# ---------------------------------------------------------------------------
# the gated norm in partial-sum form (tp over heads): K3b-tp and K6b-tp
# ---------------------------------------------------------------------------


def _gated_rows(y, z, weight, g=None):
    if z.shape != y.shape or z.dtype != y.dtype or z.device != y.device:
        raise ValueError("z must match y in shape, dtype and device")
    if g is not None and (g.shape != y.shape or g.dtype != y.dtype or g.device != y.device):
        raise ValueError("g must match y in shape, dtype and device")
    d = y.shape[-1]
    rows = y.numel() // d if d else 0
    return d, rows, _check_weight(weight, d, y.device)


def gated_norm_sums(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """K3b-tp's first pass: each row's fp32 sum of u^2 over the rank's
    columns, u = y silu(z), shape y.shape[:-1]. Numerics of
    ``norms.gated_norm_sums_plain``."""
    if not y.is_cuda:
        return gated_norm_sums_plain(y, z)
    if z.shape != y.shape or z.dtype != y.dtype or z.device != y.device:
        raise ValueError("z must match y in shape, dtype and device")
    d = y.shape[-1]
    rows = y.numel() // d if d else 0
    (y2, y_rs), (z2, z_rs) = kb.as_rows(y, 1), kb.as_rows(z, 1)
    sums = torch.empty(y.shape[:-1], dtype=torch.float32, device=y.device)
    if rows:
        err = kb.load_kernels().omt_gated_norm_sums(
            y2.data_ptr(), z2.data_ptr(), sums.data_ptr(), y_rs, z_rs, rows, d,
            kb.dtype_code(y2.dtype), _vectorizable(d, (y_rs, z_rs), (y2, z2)),
            kb.current_stream(y.device))
        kb.check_launch(err, "gated_norm_sums")
        gated_norm_sums.launches += 1
    return sums


def gated_norm_apply(y, z, weight, sums: torch.Tensor, d_full: int, eps: float = 1e-5):
    """K3b-tp's second pass: u rsqrt(sums / d_full + eps) w on the rank's
    columns, in y's type, with each row's sum over the whole width (fp32,
    y.shape[:-1]). Numerics of ``norms.gated_norm_apply_plain``."""
    if not y.is_cuda:
        return gated_norm_apply_plain(y, z, weight, sums, d_full, eps)
    d, rows, w = _gated_rows(y, z, weight)
    if sums.shape != y.shape[:-1] or sums.dtype != torch.float32 or not sums.is_contiguous():
        raise ValueError("sums must be a contiguous float32 tensor of y's rows")
    (y2, y_rs), (z2, z_rs) = kb.as_rows(y, 1), kb.as_rows(z, 1)
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    if rows:
        err = kb.load_kernels().omt_gated_norm_apply(
            y2.data_ptr(), z2.data_ptr(), w.data_ptr(), sums.data_ptr(), out.data_ptr(), y_rs,
            z_rs, rows, d, int(d_full), float(eps), kb.dtype_code(y2.dtype),
            kb.dtype_code(w.dtype), _vectorizable(d, (y_rs, z_rs), (y2, z2, w, out)),
            kb.current_stream(y.device))
        kb.check_launch(err, "gated_norm_apply")
        gated_norm_apply.launches += 1
    return out


def gated_norm_bwd_sums(y, z, g, weight) -> torch.Tensor:
    """K6b-tp's first pass: each row's fp32 sum of w g u over the rank's
    columns. Numerics of ``norms.gated_norm_bwd_sums_plain``."""
    if not y.is_cuda:
        return gated_norm_bwd_sums_plain(y, z, g, weight)
    d, rows, w = _gated_rows(y, z, weight, g)
    (y2, y_rs), (z2, z_rs), (g2, g_rs) = kb.as_rows(y, 1), kb.as_rows(z, 1), kb.as_rows(g, 1)
    dots = torch.empty(y.shape[:-1], dtype=torch.float32, device=y.device)
    if rows:
        err = kb.load_kernels().omt_gated_norm_bwd_sums(
            y2.data_ptr(), z2.data_ptr(), g2.data_ptr(), w.data_ptr(), dots.data_ptr(), y_rs,
            z_rs, g_rs, rows, d, kb.dtype_code(y2.dtype), kb.dtype_code(w.dtype),
            _vectorizable(d, (y_rs, z_rs, g_rs), (y2, z2, g2, w)), max(1, min(rows, BWD_BLOCKS)),
            kb.current_stream(y.device))
        kb.check_launch(err, "gated_norm_bwd_sums")
        gated_norm_bwd_sums.launches += 1
    return dots


def gated_norm_bwd_finish(y, z, g, weight, sums, dots, d_full: int, eps: float = 1e-5):
    """K6b-tp's second pass: (dy, dz in y's type, the rank's dw fp32) from
    each row's sums of u^2 and of w g u over the whole width. Numerics of
    ``norms.gated_norm_bwd_finish_plain``."""
    if not y.is_cuda:
        return gated_norm_bwd_finish_plain(y, z, g, weight, sums, dots, d_full, eps)
    d, rows, w = _gated_rows(y, z, weight, g)
    for name, t in (("sums", sums), ("dots", dots)):
        if t.shape != y.shape[:-1] or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor of y's rows")
    (y2, y_rs), (z2, z_rs), (g2, g_rs) = kb.as_rows(y, 1), kb.as_rows(z, 1), kb.as_rows(g, 1)
    blocks = max(1, min(rows, BWD_BLOCKS))
    dy = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    dz = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    dw = torch.zeros((d,), dtype=torch.float32, device=y.device)
    if rows:
        dw_part = torch.empty((blocks, d), dtype=torch.float32, device=y.device)
        err = kb.load_kernels().omt_gated_norm_bwd_finish(
            y2.data_ptr(), z2.data_ptr(), g2.data_ptr(), w.data_ptr(), sums.data_ptr(),
            dots.data_ptr(), dy.data_ptr(), dz.data_ptr(), dw.data_ptr(), dw_part.data_ptr(),
            y_rs, z_rs, g_rs, rows, d, int(d_full), float(eps), kb.dtype_code(y2.dtype),
            kb.dtype_code(w.dtype), _vectorizable(d, (y_rs, z_rs, g_rs), (y2, z2, g2, w, dy, dz, dw_part)),
            blocks, kb.current_stream(y.device))
        kb.check_launch(err, "gated_norm_bwd_finish")
        gated_norm_bwd_finish.launches += 1
    return dy, dz, dw


class _GatedRmsNormTp(torch.autograd.Function):
    """The gated norm of a rank's columns of d_inner under tp: the rows'
    sums all-reduced over the tp ranks between the two passes, forward and
    backward. Saves the all-reduced sums of u^2 for the backward."""

    @staticmethod
    def forward(ctx, y, z, weight, eps, cut):
        sums = tp_all_reduce(gated_norm_sums(y, z), cut)
        ctx.eps, ctx.cut, ctx.d_full = eps, cut, y.shape[-1] * cut.size
        ctx.save_for_backward(y, z, weight, sums)
        return gated_norm_apply(y, z, weight, sums, ctx.d_full, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y, z, weight, sums = ctx.saved_tensors
        dots = tp_all_reduce(gated_norm_bwd_sums(y, z, g, weight), ctx.cut)
        dy, dz, dw = gated_norm_bwd_finish(y, z, g, weight, sums, dots, ctx.d_full, ctx.eps)
        return dy, dz, dw.to(weight.dtype), None, None


def fused_gated_rms_norm_tp(
    y: torch.Tensor,  # (..., d) the rank's columns of d_inner
    z: torch.Tensor,  # (..., d)
    weight: torch.Tensor,  # (d,) the rank's slice of the norm's weight
    eps: float,
    cut,  # the mixer's TpCut (parallel/tensor.py)
) -> torch.Tensor:
    """RMSNorm(y * silu(z)) * weight over the whole d_inner = d x tp, of
    which this rank holds d columns: K3b-tp (sums pass, an all-reduce of the
    rows' sums over the tp ranks, apply pass); differentiable, its backward
    K6b-tp the same way. dw is the rank's own slice: no tp sum."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, z, weight)):
        return _GatedRmsNormTp.apply(y, z, weight, eps, cut)
    sums = tp_all_reduce(gated_norm_sums(y, z), cut)
    return gated_norm_apply(y, z, weight, sums, y.shape[-1] * cut.size, eps)


# kernel launches since the counter was last set to 0 (plain-version calls do not count)
fused_add_rms_norm.launches = 0
fused_gated_rms_norm.launches = 0
fused_add_rms_norm_bwd.launches = 0
fused_gated_rms_norm_bwd.launches = 0
gated_norm_sums.launches = 0
gated_norm_apply.launches = 0
gated_norm_bwd_sums.launches = 0
gated_norm_bwd_finish.launches = 0
