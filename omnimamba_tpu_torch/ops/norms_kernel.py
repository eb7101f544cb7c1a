"""The two forward norms of a Mamba-2 block as CUDA kernels.

``fused_add_rms_norm`` replaces the TPU kernel ``_fwd_kernel`` /
``fused_add_rms_norm`` and ``fused_gated_rms_norm`` replaces
``_gated_fwd_kernel`` / ``fused_gated_rms_norm`` of
``omnimamba_tpu/ops/norms_pallas.py``. Source: ``csrc/norms.cu``.

What bounds them on an H100: bytes. Each is one pass over a row with one
reduction and no matrix product. The design reads every input once, keeps
the row in shared memory as fp32 between the reduction and the scaling, and
writes every output once, with 16-byte accesses where the row allows it.
Inputs go in with a row stride, so the gate z, a column slice of the in_proj
output, is read where it lies, without a copy.
The TPU kernel's row tile sized to its on-chip memory and its row padding
have no counterpart: one thread block takes one row. At one-token decode
(a few dozen rows) the launch, not the bytes, is the cost.

For a tensor on the CPU the wrappers use the plain versions from
``norms.py``; for a CUDA tensor they launch the kernel or raise. Forward
only: the backward kernels belong to the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from omnimamba_tpu_torch.ops import kernel_build as kb
from omnimamba_tpu_torch.ops.norms import add_norm_plain, gated_rms_norm_plain


def _check_weight(weight: torch.Tensor, d: int, device: torch.device) -> torch.Tensor:
    if weight.shape != (d,) or weight.device != device:
        raise ValueError(f"weight must be ({d},) on {device}, got {tuple(weight.shape)} on {weight.device}")
    return weight.contiguous()


def _vectorizable(d: int, strides, tensors) -> int:
    return int(d % 4 == 0 and all(s % 4 == 0 for s in strides)
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def fused_add_rms_norm(
    x: torch.Tensor,  # (..., d) float32 or bfloat16
    residual: Optional[torch.Tensor],  # (..., d) float32, or None (first block)
    weight: torch.Tensor,  # (d,)
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + residual) -> RMSNorm; returns (normed in x.dtype, y fp32) with
    y = x + residual the new residual stream. Same numerics as
    ``norms.add_norm_plain``."""
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
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
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


def fused_gated_rms_norm(
    y: torch.Tensor,  # (..., d)
    z: torch.Tensor,  # (..., d) same dtype
    weight: torch.Tensor,  # (d,)
    eps: float = 1e-5,
) -> torch.Tensor:
    """RMSNorm(y * silu(z)) * weight in y.dtype; numerics of
    ``norms.gated_rms_norm_plain``."""
    if not y.is_cuda:
        return gated_rms_norm_plain(y, z, weight, eps)
    if z.shape != y.shape or z.dtype != y.dtype or z.device != y.device:
        raise ValueError("z must match y in shape, dtype and device")
    d = y.shape[-1]
    (y2, y_rs), (z2, z_rs) = kb.as_rows(y, 1), kb.as_rows(z, 1)
    w = _check_weight(weight, d, y.device)
    out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
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


# kernel launches since the counter was last set to 0 (plain-version calls do not count)
fused_add_rms_norm.launches = 0
fused_gated_rms_norm.launches = 0
