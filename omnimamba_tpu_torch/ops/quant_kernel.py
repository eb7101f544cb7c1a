"""The int8 weight-only matrix product as a CUDA kernel.

Replaces the TPU kernel ``_qmm_kernel`` / ``qmatmul_pallas`` of
``omnimamba_tpu/ops/quant_pallas.py``. Source: ``csrc/qmatmul.cu``.

    out[m, o] = (sum_k x[m, k] * q[k, o]) * s[o]      q: (K, O)
    out[m, o] = (sum_k x[m, k] * q[o, k]) * s[o]      q: (O, K), ``transpose``

with fp32 sums, the scale applied to the accumulator and the result cast to
``out_dtype`` (x's type unless asked otherwise; the weight-tied head asks
for fp32). x is float32 or bfloat16, q int8, s float32.

What bounds it on an H100: at decode (tens of rows) the weight bytes, which
int8 halves against bf16; at prefill (thousands of rows) the operations. bf16
activations on whole tiles take the tensor cores along one of two paths, by
the number of rows M:

- ``M < M_TILE`` (decode, bound by the weight bytes): a cluster of two
  blocks for each tile of 32, 64 or 128 columns (chosen from O alone) and up
  to 64 rows. The two blocks run the two k chains of the order below, each
  over all of K, and the second pushes its sums into the first through
  distributed shared memory: twice the blocks of a column tiling, no partial
  sums in device memory, one launch. A producer warp streams the int8 and
  activation tiles in with TMA copies and mbarriers; the int8 tile is widened
  to bf16 in registers, after ``ldmatrix`` of byte pairs for (K, O), for
  ``mma.sync`` m16n8k16. ``decode_plan`` reports the launch.
- ``M >= M_TILE`` (prefill, the slot engine's prefill groups): 128 rows x 128
  columns a block, so each operand byte is read from L2 by fewer blocks; the
  int8 tile of the next k step is widened during this one into a double
  buffer (one barrier a k step), and the products are ``ldmatrix`` +
  ``mma.sync`` m16n8k16 on 64 x 64 warp tiles.

Both sum in one order: for every 64-wide k tile, k in [0, 32) into one fp32
accumulator ``lo`` and [32, 64) into another ``hi``, each in k16 steps in k
order (one m16n8k16 product each), then ``(lo + hi) * scale``. So a row's
result has the same bits in any batch and through either path. The transposed
table is read as it lies, with no transposed copy. fp32 activations and shapes
that are not whole tiles take fp32 multiply-adds over shared-memory tiles,
also in an order that does not depend on M.

``qmatmul_plain`` is the plain PyTorch version. The wrapper uses it for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from omnimamba_tpu_torch.ops import kernel_build as kb

# rows from which bf16 activations take the 128-row tiles (the prefill path),
# below which the decode path; both give a row the same bits. `chip_smoke.py`'s
# `qmatmul_m_sweep` times the two over one layer's in_proj and out_proj from 1
# to 3456 rows (PERF.md)
M_TILE = 128


def qmatmul_plain(
    x: torch.Tensor,  # (..., K)
    q: torch.Tensor,  # (K, O) int8, or (O, K) with transpose
    scale: torch.Tensor,  # (O,)
    transpose: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(x @ q) * scale with fp32 operands and sums (products of bf16 and
    int8 values are exact in fp32), cast to ``out_dtype`` (default x's)."""
    qf = q.float()
    y = x.float() @ (qf.T if transpose else qf)
    return (y * scale.float()).to(out_dtype or x.dtype)


def qmatmul(
    x: torch.Tensor,
    q: torch.Tensor,
    scale: torch.Tensor,
    transpose: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``qmatmul_plain``'s contract through the kernel for CUDA tensors. Any
    leading shape of x (flattened to rows)."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return qmatmul_plain(x, q, scale, transpose, out_dtype)
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"q must be a 2-D int8 tensor, got {q.dtype} {tuple(q.shape)}")
    O, K = (q.shape[0], q.shape[1]) if transpose else (q.shape[1], q.shape[0])
    if x.shape[-1] != K:
        raise ValueError(f"x has {x.shape[-1]} columns, the weight contracts {K}")
    if scale.shape != (O,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be a float32 ({O},) tensor, got {scale.dtype} {tuple(scale.shape)}")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead = x.shape[:-1]
    M = math.prod(lead)
    x2 = x.reshape(M, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    out = torch.empty((M, O), dtype=out_dtype, device=x.device)
    if M and O:
        err = kb.load_kernels().omt_qmatmul(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, O,
            int(transpose), kb.dtype_code(x2.dtype), kb.dtype_code(out_dtype), M_TILE,
            kb.current_stream(x.device),
        )
        kb.check_launch(err, "qmatmul")
        qmatmul.launches += 1
    return out.reshape(*lead, O)


def decode_plan(M: int, O: int, transpose: bool = False) -> dict:
    """The launch of the decode path (bf16 activations on whole tiles, fewer
    than ``M_TILE`` rows) for M rows and O columns, as the library makes it."""
    plan = (ctypes.c_int * 7)()
    kb.check_launch(kb.load_kernels().omt_qmatmul_pair_plan(M, O, int(transpose), plan),
                    "qmatmul decode_plan")
    keys = ("cluster_blocks", "columns", "rows", "threads", "stage_tiles", "stages", "shared_bytes")
    return dict(zip(keys, plan))


# kernel launches since the counter was last set to 0 (plain-version calls do not count)
qmatmul.launches = 0
