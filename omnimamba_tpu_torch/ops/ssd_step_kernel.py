"""The one-token SSM update of the decode loop as a CUDA kernel.

Replaces the TPU kernel ``_step_kernel`` / ``ssd_step_pallas`` of
``omnimamba_tpu/ops/ssd_step_pallas.py``. Source: ``csrc/ssd_step.cu``.

    new_state = state * exp(dt*A) + (dt*x) outer B
    y         = sum_n new_state * C + D * x

What bounds it on an H100: bytes. The (B, H, P, N) state is read once and
written once and nothing else is of any size. The design therefore reads
each state element once and writes it once with 16-byte accesses (8-byte
for a bf16 state), reduces over N inside a warp, and computes the decay,
dt*x, the group-to-head mapping and D*x in the kernel, so no broadcast
helper array is built in device memory as the TPU wrapper did. x, B and C go
in with a row stride, so the column slices of the fused conv output that the
mixer hands over are read where they lie, without a copy. A bf16 state
halves the bytes; the product is still taken in fp32 and y comes from the
unrounded new state.

**The state is updated in place.** The TPU kernel aliased its state operand
to its output; here the caller's ``state`` tensor holds the new state when
the call returns, on the CPU as on the card, and the same tensor is
returned.

A scaled-int8 state ``{"q": (B, H, P, N) int8, "scale": (B, H, P) fp32}``
(``ops/quant.quantize_ssm_state``) takes the kernel's int8 branch: the TPU
side computes it in XLA code (``ssd_reference.py:118-147``), here it is a
kernel too, a warp per (b, h, p) row of N values in registers that
dequantizes, updates, sums y from the unrounded new state, and requantizes
with round-half-to-even; q and scale are updated in place. Bytes a row: N
int8 and one fp32 scale, against 2N for a bf16 state. With P a multiple of 8
up to 64 and N a multiple of 4 up to 128 (``q8_tile_fits``: every shipped
config) it runs ``ssd_step_q8_tile_kernel``, which is bound by the
instructions it issues, about 24 an element, not by bytes: every row of a
warp loaded at once, no conversion instruction, the division as the fast
path of ``div.rn.f32`` with the reciprocal once a row; it gives the row
kernel's q, scale and y bit for bit, and that kernel keeps the other shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from omnimamba_tpu_torch.ops import kernel_build as kb
from omnimamba_tpu_torch.ops.ssd_reference import ssd_step as ssd_step_plain


def ssd_step_fused(
    x_t: torch.Tensor,  # (B, H, P) float32 or bfloat16
    dt_t: torch.Tensor,  # (B, H) softplus'ed
    A: torch.Tensor,  # (H,) negative
    B_t: torch.Tensor,  # (B, G, N) in x_t.dtype
    C_t: torch.Tensor,  # (B, G, N) in x_t.dtype
    D: Optional[torch.Tensor],  # (H,) or None
    state,  # (B, H, P, N) float32 or bfloat16, or int8 {"q", "scale"}: UPDATED IN PLACE
) -> Tuple[torch.Tensor, object]:
    """Same contract as ``ssd_reference.ssd_step`` except that ``state`` is
    overwritten with the new state: returns (y_t (B,H,P) in x_t.dtype, state).
    """
    quantized = isinstance(state, dict)
    if not x_t.is_cuda:
        y, new_state = ssd_step_plain(x_t, dt_t, A, B_t, C_t, D, state)
        if quantized:
            state["q"].copy_(new_state["q"])
            state["scale"].copy_(new_state["scale"])
        else:
            state.copy_(new_state)
        return y, state

    Bsz, H, P = x_t.shape
    if B_t.dim() != 3 or B_t.shape[0] != Bsz:
        raise ValueError(f"B_t must be (B, G, N), got {tuple(B_t.shape)}")
    G, N = B_t.shape[1], B_t.shape[2]
    if H % G != 0:
        raise ValueError(f"heads {H} must be a multiple of groups {G}")
    if N % 4 != 0:
        raise ValueError(f"d_state {N} must be a multiple of 4")
    if C_t.shape != B_t.shape or dt_t.shape != (Bsz, H) or A.shape != (H,):
        raise ValueError("C_t, dt_t or A has the wrong shape")
    if quantized:
        q, scale = state["q"], state["scale"]
        if (q.shape != (Bsz, H, P, N) or q.dtype != torch.int8 or not q.is_contiguous()
                or q.data_ptr() % 4 != 0):
            raise ValueError("state['q'] must be a contiguous, 4-byte aligned (B, H, P, N) int8 tensor")
        if scale.shape != (Bsz, H, P) or scale.dtype != torch.float32 or not scale.is_contiguous():
            raise ValueError("state['scale'] must be a contiguous (B, H, P) float32 tensor")
        if N > 512:
            raise ValueError(f"the int8-state step holds a row in registers: d_state {N} > 512")
        tensors = (("q", q), ("scale", scale))
    else:
        if state.shape != (Bsz, H, P, N) or not state.is_contiguous():
            raise ValueError("state must be a contiguous (B, H, P, N) tensor")
        if state.data_ptr() % 16 != 0:
            raise ValueError("state must be 16-byte aligned")
        tensors = (("state", state),)
    if B_t.dtype != x_t.dtype or C_t.dtype != x_t.dtype:
        raise TypeError("B_t and C_t must have x_t's dtype")
    for name, t in (("dt_t", dt_t), ("A", A), ("B_t", B_t), ("C_t", C_t), *tensors):
        if t.device != x_t.device:
            raise ValueError(f"{name} lies on {t.device}, x_t on {x_t.device}")

    (x_c, x_rs), (B_c, b_rs), (C_c, c_rs) = (kb.as_rows(t, 2) for t in (x_t, B_t, C_t))
    dt_c = dt_t.to(torch.float32).contiguous()
    A_c = A.to(torch.float32).contiguous()
    D_c = None if D is None else D.to(device=x_t.device, dtype=torch.float32).contiguous()
    y = torch.empty((Bsz, H, P), dtype=x_t.dtype, device=x_t.device)
    if quantized:
        if x_c.numel():
            err = kb.load_kernels().omt_ssd_step_q8(
                x_c.data_ptr(), dt_c.data_ptr(), A_c.data_ptr(), B_c.data_ptr(), C_c.data_ptr(),
                None if D_c is None else D_c.data_ptr(), q.data_ptr(), scale.data_ptr(),
                y.data_ptr(), x_rs, b_rs, c_rs, Bsz, H, P, G, N, kb.dtype_code(x_c.dtype),
                kb.current_stream(x_t.device),
            )
            kb.check_launch(err, "ssd_step_fused (int8 state)")
            ssd_step_fused.int8_launches += 1
        return y, state
    if x_c.numel():
        err = kb.load_kernels().omt_ssd_step(
            x_c.data_ptr(), dt_c.data_ptr(), A_c.data_ptr(), B_c.data_ptr(), C_c.data_ptr(),
            None if D_c is None else D_c.data_ptr(), state.data_ptr(), y.data_ptr(),
            x_rs, b_rs, c_rs, Bsz, H, P, G, N, kb.dtype_code(x_c.dtype), kb.dtype_code(state.dtype),
            kb.current_stream(x_t.device),
        )
        kb.check_launch(err, "ssd_step_fused")
        ssd_step_fused.launches += 1
    return y, state


# kernel launches since the counter was last set to 0 (plain-version calls do not count):
# `launches` of the float-state kernel, `int8_launches` of the int8-state kernel
ssd_step_fused.launches = 0
ssd_step_fused.int8_launches = 0
