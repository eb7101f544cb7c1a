"""Sequential Mamba-2 SSD recurrence: the correctness oracle, and the plain
one-token step.

Per head h with scalar decay A_h and per-step dt:

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t + D_h * x_t

Counterpart of ``omnimamba_tpu/ops/ssd_reference.py``. ``ssd_scan_reference``
is the ground truth for ``ssd_chunked`` and for the scan kernel
(``ssd_kernel.py``); ``ssd_step`` is the plain version of the decode-step
kernel (``ssd_step_kernel.py``). State is fp32 unless the caller carries it
in another dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from omnimamba_tpu_torch.ops.quant import dequantize_ssm_state, quantize_ssm_state


def ssd_scan_reference(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) already softplus'ed, includes dt_bias
    A: torch.Tensor,  # (H,) negative decay rates (-exp(A_log))
    Bmat: torch.Tensor,  # (B, L, G, N)
    Cmat: torch.Tensor,  # (B, L, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
    *,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,L,H,P) in x.dtype, final_state (B,H,P,N) fp32)."""
    Bsz, L, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    if H % G != 0:
        raise ValueError(f"heads {H} must be a multiple of groups {G}")
    rep = H // G

    xf = x.float()
    dtf = dt.float()
    Bf = Bmat.float().repeat_interleave(rep, dim=2)  # (B, L, H, N)
    Cf = Cmat.float().repeat_interleave(rep, dim=2)
    Af = A.float()

    if initial_state is None:
        h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    else:
        h = initial_state.float()

    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * Af)  # (B, H)
        dBx = torch.einsum("bhp,bhn->bhpn", dtf[:, t, :, None] * xf[:, t], Bf[:, t])
        h = h * decay[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1)  # (B, L, H, P)
    if D is not None:
        y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_step(
    x_t: torch.Tensor,  # (B, H, P)
    dt_t: torch.Tensor,  # (B, H) softplus'ed
    A: torch.Tensor,  # (H,)
    B_t: torch.Tensor,  # (B, G, N)
    C_t: torch.Tensor,  # (B, G, N)
    D: Optional[torch.Tensor],  # (H,)
    state,  # (B, H, P, N) fp32 or bf16, or scaled int8 {"q", "scale"}
) -> Tuple[torch.Tensor, object]:
    """O(1) recurrent decode step in plain tensor code.

    Returns (y_t (B,H,P) in x_t.dtype, new_state in state.dtype); ``state``
    itself is left untouched. One form for every batch size:

        new_state = state * exp(dt*A) + (dt*x) outer B
        y         = sum_n new_state * C + D * x

    The JAX function switches to an algebraically equal distributed form at
    batch >= 16; ``new_state`` is identical between the two and ``y`` differs
    by summation order only.

    A scaled-int8 state (``ops/quant.quantize_ssm_state``: q (B, H, P, N)
    int8, scale (B, H, P) fp32) is dequantized, updated, y taken from the
    unrounded new state, and the new state requantized: a new dict is
    returned.
    """
    H = x_t.shape[1]
    rep = H // B_t.shape[1]
    Bf = B_t.float().repeat_interleave(rep, dim=1)  # (B, H, N)
    Cf = C_t.float().repeat_interleave(rep, dim=1)
    dtf = dt_t.float()
    xf = x_t.float()

    decay = torch.exp(dtf * A.float())  # (B, H)
    dtx = dtf[..., None] * xf  # (B, H, P)
    new_state = dequantize_ssm_state(state) * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", dtx, Bf
    )
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cf)
    if D is not None:
        y = y + xf * D.float()[None, :, None]
    if isinstance(state, dict):
        return y.to(x_t.dtype), quantize_ssm_state(new_state)
    return y.to(x_t.dtype), new_state.to(state.dtype)
