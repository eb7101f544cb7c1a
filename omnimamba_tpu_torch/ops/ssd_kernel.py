"""The chunked SSD forward of prefill as a CUDA kernel.

Replaces the TPU kernel ``_ssd_kernel`` / ``ssd_pallas`` of
``omnimamba_tpu/ops/ssd_pallas.py``. Source: ``csrc/ssd_scan.cu``.

Same contract: zero initial state in, ``(y (B,L,H,P) in x.dtype,
final_state (B,H,P,N) fp32)`` out. One thread block per (batch, head) loops
over chunks inside the block and carries the fp32 (P, N) state in shared
memory for the whole sequence; the cumulative sum of dt*A is computed in the
kernel, and the ragged last chunk is masked, not padded in device memory.
dt = 0 at a position is an exact no-op for the state, which is how padded
rows of a ragged batch are handled by the caller.

What bounds it on an H100: bytes, at prefill shapes (x read and y written
once, the final state written once). What the TPU kernel did for its own
hardware is gone: the time-on-lanes transposed layout with its two copies of
the cumulative sum, the 128-wide sub-tiles, the chunk rounded up to the lane
width, the padding of L to a whole chunk in device memory and the sequential
grid. The chunk length is a constant of the source chosen by shared memory;
the model's ``chunk_size`` does not reach the kernel because chunking does
not change the result. x, B and C go in with a row stride, so the column
slices of the fused conv output are read where they lie. Products are fp32 multiply-adds for fp32 and bf16
inputs alike, so fp32 inputs are exact.

The plain version is ``ssd_chunked`` with a zero initial state, which repeats
the kernel's chunked arithmetic in tensor code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from omnimamba_tpu_torch.ops import kernel_build as kb
from omnimamba_tpu_torch.ops.ssd_chunked import ssd_chunked

PLAIN_CHUNK = 16  # chunk of the plain version; equals kChunk of csrc/ssd_scan.cu


def ssd_fused_plain(x, dt, A, Bmat, Cmat, D=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain tensor version of the kernel: chunked SSD from a zero state."""
    return ssd_chunked(x, dt, A, Bmat, Cmat, D, chunk_size=PLAIN_CHUNK)


def ssd_fused(
    x: torch.Tensor,  # (B, L, H, P) float32 or bfloat16
    dt: torch.Tensor,  # (B, L, H) softplus'ed
    A: torch.Tensor,  # (H,) negative
    Bmat: torch.Tensor,  # (B, L, G, N) in x.dtype
    Cmat: torch.Tensor,  # (B, L, G, N) in x.dtype
    D: Optional[torch.Tensor] = None,  # (H,)
    *,
    return_chunk_states: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,L,H,P) in x.dtype, final_state (B,H,P,N) fp32)."""
    if return_chunk_states:
        raise NotImplementedError(
            "chunk-entry states are the input of the SSD backward kernel and "
            "arrive with the training slice (ROADMAP Q2 K5)"
        )
    if not x.is_cuda:
        return ssd_fused_plain(x, dt, A, Bmat, Cmat, D)

    Bsz, L, H, P = x.shape
    if Bmat.dim() != 4 or Bmat.shape[:2] != (Bsz, L):
        raise ValueError(f"Bmat must be (B, L, G, N), got {tuple(Bmat.shape)}")
    G, N = Bmat.shape[2], Bmat.shape[3]
    if H % G != 0:
        raise ValueError(f"heads {H} must be a multiple of groups {G}")
    if N % 4 != 0:
        raise ValueError(f"d_state {N} must be a multiple of 4")
    if Cmat.shape != Bmat.shape or dt.shape != (Bsz, L, H) or A.shape != (H,):
        raise ValueError("Cmat, dt or A has the wrong shape")
    if Bmat.dtype != x.dtype or Cmat.dtype != x.dtype:
        raise TypeError("Bmat and Cmat must have x's dtype")
    for name, t in (("dt", dt), ("A", A), ("Bmat", Bmat), ("Cmat", Cmat)):
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")

    (x_c, x_rs), (B_c, b_rs), (C_c, c_rs) = (kb.as_rows(t, 2) for t in (x, Bmat, Cmat))
    dt_c = dt.to(torch.float32).contiguous()
    A_c = A.to(torch.float32).contiguous()
    D_c = None if D is None else D.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty((Bsz, L, H, P), dtype=x.dtype, device=x.device)
    alloc = torch.empty if x_c.numel() else torch.zeros  # the kernel writes every element
    final_state = alloc((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if x_c.numel():
        err = kb.load_kernels().omt_ssd_scan(
            x_c.data_ptr(), dt_c.data_ptr(), A_c.data_ptr(), B_c.data_ptr(), C_c.data_ptr(),
            None if D_c is None else D_c.data_ptr(), y.data_ptr(), final_state.data_ptr(),
            x_rs, b_rs, c_rs, Bsz, L, H, P, G, N, kb.dtype_code(x_c.dtype), kb.current_stream(x.device),
        )
        kb.check_launch(err, "ssd_fused")
        ssd_fused.launches += 1
    return y, final_state


# kernel launches since the counter was last set to 0 (plain-version calls do not count)
ssd_fused.launches = 0
