"""Chunked Mamba-2 SSD in plain tensor code.

State-space duality: inside a chunk of Q tokens the recurrence is a masked,
attention-like matrix product; across chunks a short loop passes the
(H, P, N) state. Counterpart of ``omnimamba_tpu/ops/ssd_chunked.py``. In the
port it serves two purposes: it is the scan for continuation windows (it
takes an ``initial_state``, the kernel does not), and with a zero initial
state it is the plain version of the scan kernel in ``ssd_kernel.py``.

Numerics: exponentials, cumulative sums, products and the carried state are
all fp32; the output is cast to ``x.dtype``. With ``round_operands`` the
operands of the products are rounded to ``x.dtype`` first, where the Pallas
kernel rounds them (its ``mxu_dtype``); the sums and the state stay fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) softplus'ed (includes dt_bias)
    A: torch.Tensor,  # (H,) negative
    Bmat: torch.Tensor,  # (B, L, G, N)
    Cmat: torch.Tensor,  # (B, L, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
    *,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N) fp32
    chunk_size: int = 256,
    return_chunk_states: bool = False,
    round_operands: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Returns (y (B,L,H,P) in x.dtype, final_state (B,H,P,N) fp32).

    With ``return_chunk_states`` a third output follows: the fp32 state
    entering each chunk, (B, C, H, P, N) with C = ceil(L / chunk_size), which
    is what the SSD backward starts every chunk from.

    Matches ``ssd_reference.ssd_scan_reference`` to fp32 accuracy.

    ``round_operands``: every product takes operands rounded to ``x.dtype``
    (a no-op for fp32 x), at the points of the small-chunk path of
    ``omnimamba_tpu/ops/ssd_pallas.py``'s ``_ssd_kernel`` (``mxu_dtype``):
    B and C as given; the masked scores ``C_t . B_j`` and the decay
    ``e^{s_t - s_j}`` each rounded, then their product (``:125``,
    ``:170-171``); ``x dt`` (``:132``, ``:173``); the state entering the
    chunk, for ``C_t . state`` (``:179``); ``(x dt) e^{tot - s}``, for the
    update (``:188-190``). y is summed in fp32 and rounded once.
    """
    Bsz, L, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    Q = chunk_size
    pad = (-L) % Q
    C = (L + pad) // Q
    rep = H // G

    if round_operands and x.dtype != torch.float32:
        def mx(t):  # an operand of a product, rounded to x's type
            return t.to(x.dtype).float()
    else:
        def mx(t):
            return t

    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bmat.float(), Cmat.float()
    if pad:
        # dt=0 at padded positions => decay 1 and zero contribution:
        # the carried state passes through unchanged.
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))

    xc = xf.reshape(Bsz, C, Q, H, P)
    dtc = dtf.reshape(Bsz, C, Q, H)
    Bc = Bf.reshape(Bsz, C, Q, G, N)
    Cc = Cf.reshape(Bsz, C, Q, G, N)

    a = dtc * A.float()[None, None, None, :]  # (B,C,Q,H) <= 0
    s = torch.cumsum(a, dim=2)  # inclusive
    total = s[:, :, -1, :]  # (B,C,H)

    # --- intra-chunk (quadratic form): scores[b,c,g,i,j] = C_i . B_j --------
    scores = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    # decay[b,c,h,i,j] = exp(s_i - s_j) for j<=i else 0; masked before the
    # exp so the discarded upper triangle cannot overflow
    diff = (s[:, :, :, None, :] - s[:, :, None, :, :]).permute(0, 1, 4, 2, 3)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(diff.masked_fill(~mask, 0.0)).masked_fill(~mask, 0.0)
    attn = mx(mx(scores.repeat_interleave(rep, dim=2)) * mx(decay))  # (B,C,H,Q,Q)
    dtx = dtc[..., None] * xc  # (B,C,Q,H,P)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", attn, mx(dtx))

    # --- chunk states: S[b,c,h,p,n] = sum_j exp(total - s_j) dt_j x_j B_j ---
    state_decay = torch.exp(total[:, :, None, :] - s)  # (B,C,Q,H)
    Bh = Bc.repeat_interleave(rep, dim=3)  # (B,C,Q,H,N)
    chunk_states = torch.einsum("bcqhp,bcqhn->bchpn", mx(dtx * state_decay[..., None]), Bh)

    # --- inter-chunk state passing (sequential over the C chunks) -----------
    if initial_state is None:
        h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    else:
        h = initial_state.float()
    entering = []
    for c in range(C):
        entering.append(h)
        h = h * torch.exp(total[:, c])[..., None, None] + chunk_states[:, c]
    h_prev = torch.stack(entering, dim=1)  # (B,C,H,P,N) state entering chunk c

    # --- inter-chunk output --------------------------------------------------
    Ch = Cc.repeat_interleave(rep, dim=3)  # (B,C,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch, mx(h_prev)) * torch.exp(s)[..., None]

    y = y_intra + y_inter
    if D is not None:
        y = y + xc * D.float()[None, None, None, :, None]
    y = y.reshape(Bsz, L + pad, H, P)[:, :L]
    if return_chunk_states:
        return y.to(x.dtype), h, h_prev
    return y.to(x.dtype), h
