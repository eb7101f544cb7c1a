"""The chunked SSD scan of prefill and training as CUDA kernels, forward and
backward.

Forward: replaces the TPU kernel ``_ssd_kernel`` / ``ssd_pallas`` of
``omnimamba_tpu/ops/ssd_pallas.py``. Source: ``csrc/ssd_scan.cu``.
Backward: replaces ``_ssd_bwd_kernel`` / ``ssd_pallas_ad`` of
``omnimamba_tpu/ops/ssd_pallas_bwd.py``. Source: ``csrc/ssd_scan_bwd.cu``.

Forward contract: zero initial state in, ``(y (B,L,H,P) in x.dtype,
final_state (B,H,P,N) fp32)`` out. One thread block per (batch, head) loops
over chunks inside the block and carries the fp32 (P, N) state for the whole
sequence; the cumulative sum of dt*A is computed in the kernel, and the
ragged last chunk is masked, not padded in device memory. Like the JAX
kernel, the forward has two operand types: for fp32 inputs a kernel of fp32
multiply-adds with the state in shared memory; for bf16 inputs a tensor-core
kernel (bf16 operands rounded where the JAX kernel rounds them, fp32 sums)
with the state in registers, one block per (batch, head).
dt = 0 at a position is an exact no-op for the state, which is how padded
rows of a ragged batch are handled by the caller. With
``return_chunk_states`` the kernel also writes the fp32 state entering every
chunk, (B, C, H, P, N), the residual the backward starts each chunk from.

``ssd_fused`` is differentiable: where a gradient is asked for it runs
through ``torch.autograd.Function`` around the two kernels, whose outputs a
checkpoint policy can keep (``ops/remat.py``): the backward then feeds K5
the kept chunk states without launching K1 again. The backward
walks the chunks of one sequence in reverse and carries the (P, N) adjoint
of the state as the forward carries the state; the decay matrix of a chunk
is rebuilt there and never stored. Its derivation is the one of
``ssd_pallas_bwd.py`` (the decay cotangent folded into dB and dC) and
``ssd_bwd_plain`` repeats it in tensor code. Like the JAX kernel, the
backward has two operand types: for fp32 inputs a kernel of fp32
multiply-adds with the adjoint in shared memory; for bf16 inputs a
tensor-core kernel (bf16 operands rounded where the JAX kernel rounds them,
fp32 sums) with the adjoint in registers, one block per (batch, head) and
one cluster of blocks per head tile. bf16 inputs whose head and state sizes
(P, N) fit none of the tensor-core kernels' tiles, (64, 128), (128, 128) and
(64, 256), take the multiply-add kernels, which then round at the same points.

What bounds them on an H100: bytes by the roofline rule (x read and y
written once; the backward reads the chunk states once). The fp32 kernels
do their products as fp32 multiply-adds out of shared memory and are held
back by those; the bf16 kernels by the latency of their serial walk over
chunks. What the TPU kernels did for their own hardware is
gone: the time-on-lanes transposed layouts with two copies of the cumulative
sum, the 128-wide causal sub-tiles, the hi/lo bf16 split of the suffix sum,
the chunk rounded up to the lane width, the padding of L and the sequential
grid. The chunk length is a constant of the sources chosen by shared memory;
the model's ``chunk_size`` does not reach the kernels because chunking does
not change the result. x, B, C and gy go in with a row stride, so the column
slices of the fused conv output are read where they lie. fp32 inputs are
exact to summation order.

Sums across blocks are taken in a fixed order, without atomics: the heads of
a tile of one group add their dB / dC into the tile's own fp32 partial (in
turn in one fp32 block; across the cluster's shared memory in rank order for
bf16); a second kernel sums the partials of a group's tiles, and dA and dD
over the batch, in index order. A backward gives the same bits on every run.

The plain versions are ``ssd_chunked`` with a zero initial state and
``ssd_bwd_plain``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from omnimamba_tpu_torch.ops import kernel_build as kb
from omnimamba_tpu_torch.ops.remat import kept
from omnimamba_tpu_torch.ops.ssd_chunked import ssd_chunked

PLAIN_CHUNK = 16  # chunk of the plain versions; equals kChunk of csrc/ssd_scan.cu
# heads of one `tile` (the argument of omt_ssd_scan_bwd): one fp32 backward block
# walks them in turn; the bf16 backward runs them as one cluster of blocks, one
# head a block (the cluster size is timed by tools/ablation.py k5)
BWD_HEAD_TILE, BWD_BF16_CLUSTER = 8, 4


def ssd_fused_plain(x, dt, A, Bmat, Cmat, D=None, *, return_chunk_states: bool = False):
    """Plain tensor version of the forward kernel: chunked SSD from a zero
    state. The operands of its products follow x's type, as
    ``_ssd_kernel``'s ``mxu_dtype`` does (``ssd_pallas.py:305``): fp32 x is
    ``ssd_chunked`` on fp32 operands; bf16 x rounds them to bf16 where the
    JAX kernel does at a chunk of ``PLAIN_CHUNK`` tokens (``ssd_chunked``'s
    ``round_operands`` lists the points), with fp32 sums and an fp32 state."""
    return ssd_chunked(x, dt, A, Bmat, Cmat, D, chunk_size=PLAIN_CHUNK,
                       return_chunk_states=return_chunk_states, round_operands=True)


def ssd_bwd_plain(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H)
    A: torch.Tensor,  # (H,)
    Bmat: torch.Tensor,  # (B, L, G, N)
    Cmat: torch.Tensor,  # (B, L, G, N)
    D: Optional[torch.Tensor],  # (H,) or None
    chunk_states: torch.Tensor,  # (B, C, H, P, N) fp32, state entering each chunk
    gy: torch.Tensor,  # (B, L, H, P) cotangent of y
    gstate: Optional[torch.Tensor] = None,  # (B, H, P, N) cotangent of the final state
):
    """Plain tensor version of the backward kernel: chunks in reverse, the
    (P, N) adjoint of the state carried from chunk to chunk, sums in fp32.
    Returns (dx, ddt, dA, dB, dC, dD) in the types of x, dt, A, Bmat, Cmat, D
    (dD is None without D).

    The operands of the products follow x's type, as ``_ssd_bwd_kernel``'s
    ``mxu_dtype`` does (``ssd_pallas_bwd.py:385``). For fp32 x every operand
    is fp32. For bf16 x each product takes bf16 operands, summed in fp32,
    rounded where the JAX kernel rounds them: g, B and C as given; ``h_in``
    and ``adj`` (``:157``, ``:159``); ``xd = x dt``, ``ge = g e^{s}`` and
    ``xc = x (dt e^{tot - s})`` (``:177-179``); ``(Gxd * w)`` and
    ``(scores * w)`` (``:234-235``). The products are the scores ``C B^T``,
    ``Gxd = g xd^T``, ``dC1``, ``dB1``, ``K1``, ``ge h_in``, ``xc adj``,
    ``adj B^T`` and the adjoint update ``ge^T C`` (``:237-288``). The
    element-wise sums (r, chi, ``<h_in, adj>``, the suffix sum of r) stay
    fp32 on unrounded values (``:270-276``); the hi/lo bf16 split of the
    suffix sum (``:297-305``), a device for the TPU's matrix unit, is not
    carried over: the suffix sum is an fp32 sum here. dx is rounded once,
    after ``dt K + D g``."""
    Bsz, L, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    Q = PLAIN_CHUNK
    pad = (-L) % Q
    C = (L + pad) // Q
    rep = H // G
    dev = x.device

    def padded(t):
        t = t.float()
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t

    xf, gf, dtf, Bf, Cf = (padded(t) for t in (x, gy.to(x.dtype), dt, Bmat, Cmat))
    if x.dtype == torch.bfloat16:
        def mx(t):  # an operand of a product, rounded to bf16
            return t.to(torch.bfloat16).float()
    else:
        def mx(t):  # fp32 operands
            return t
    Af = A.float()
    adj = (gstate.float().clone() if gstate is not None
           else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev))
    dx = torch.zeros_like(xf)
    ddt = torch.zeros_like(dtf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA = torch.zeros((H,), dtype=torch.float32, device=dev)
    dD = torch.zeros((H,), dtype=torch.float32, device=dev)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))[None, :, :, None]

    for c in reversed(range(C)):
        sl = slice(c * Q, (c + 1) * Q)
        xc, gc, dtc = xf[:, sl], gf[:, sl], dtf[:, sl]  # (B,Q,H,P) (B,Q,H,P) (B,Q,H)
        Bc = Bf[:, sl].repeat_interleave(rep, dim=2)  # (B,Q,H,N)
        Cc = Cf[:, sl].repeat_interleave(rep, dim=2)
        hin = chunk_states[:, c].float()  # (B,H,P,N)
        s = torch.cumsum(dtc * Af, dim=1)  # (B,Q,H), every term <= 0
        tot = s[:, -1]  # (B,H)
        es, carry, etot = torch.exp(s), torch.exp(tot[:, None] - s), torch.exp(tot)
        diff = s[:, :, None, :] - s[:, None, :, :]  # (B,t,j,H)
        w = torch.exp(diff.masked_fill(~mask, 0.0)).masked_fill(~mask, 0.0)
        scores = torch.einsum("bthn,bjhn->btjh", Cc, Bc)
        xd = mx(xc * dtc[..., None])  # x_j dt_j
        ge = mx(gc * es[..., None])  # g_t e^{s_t}
        xcar = mx(xc * (dtc * carry)[..., None])  # x_j dt_j e^{tot - s_j}
        m1 = mx(torch.einsum("bthp,bjhp->btjh", gc, xd) * w)  # (g_t . x_j dt_j) e^{s_t - s_j}
        m2 = mx(scores * w)  # (C_t . B_j) e^{s_t - s_j}
        dC2 = torch.einsum("bthp,bhpn->bthn", ge, mx(hin))
        adj_op = mx(adj)
        dB2 = torch.einsum("bjhp,bhpn->bjhn", xcar, adj_op)
        update = torch.einsum("bthp,bthn->bhpn", ge, Cc)

        dC_h = torch.einsum("btjh,bjhn->bthn", m1, Bc) + dC2
        dB_h = torch.einsum("btjh,bthn->bjhn", m1, Cc) + dB2
        K = torch.einsum("btjh,bthp->bjhp", m2, gc) + carry[..., None] * torch.einsum(
            "bhpn,bjhn->bjhp", adj_op, Bc)
        dx[:, sl] = dtc[..., None] * K
        # the decay cotangent, folded into dC and dB: dL/ds_t = C_t.dC_t - B_t.dB_t,
        # dL/dtotal = sum_j B_j.dB2_j + e^{total} <h_in, adj>
        r = (Cc * dC_h).sum(-1) - (Bc * dB_h).sum(-1)  # (B,Q,H)
        bias = (Bc * dB2).sum(dim=(1, 3)) + etot * (hin * adj).sum(dim=(2, 3))  # (B,H)
        da = torch.flip(torch.cumsum(torch.flip(r, (1,)), dim=1), (1,)) + bias[:, None]
        ddt[:, sl] = Af * da + (xc * K).sum(-1)
        dA += (dtc * da).sum(dim=(0, 1))
        dD += (gc * xc).sum(dim=(0, 1, 3))
        adj = etot[..., None, None] * adj + update
        dB[:, sl] = dB_h.reshape(Bsz, Q, G, rep, N).sum(3)
        dC[:, sl] = dC_h.reshape(Bsz, Q, G, rep, N).sum(3)

    if D is not None:
        dx = dx + gf * D.float()[None, None, :, None]
    return (
        dx[:, :L].to(x.dtype), ddt[:, :L].to(dt.dtype), dA.to(A.dtype),
        dB[:, :L].to(Bmat.dtype), dC[:, :L].to(Cmat.dtype),
        None if D is None else dD.to(D.dtype),
    )


def _check_scan_inputs(x, dt, A, Bmat, Cmat):
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
    return G, N


def _rows_of_four(t: torch.Tensor, rs: int) -> Tuple[torch.Tensor, int]:
    """(t, rs) unless its start or row stride would split a piece of four
    bf16; then a dense copy and its row stride."""
    if t.data_ptr() % 8 == 0 and rs % 4 == 0:
        return t, rs
    return t.clone(memory_format=torch.contiguous_format), t.shape[-1] * t.shape[-2]


def _fp32(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().to(device=device, dtype=torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _scan_forward(x, dt, A, Bmat, Cmat, D, return_chunk_states):
    """The forward kernel (or, for CPU tensors, its plain version), outside
    autograd. Returns (y, final_state[, chunk_states])."""
    if not x.is_cuda:
        return ssd_fused_plain(x, dt, A, Bmat, Cmat, D, return_chunk_states=return_chunk_states)
    Bsz, L, H, P = x.shape
    G, N = _check_scan_inputs(x, dt, A, Bmat, Cmat)
    (x_c, x_rs), (B_c, b_rs), (C_c, c_rs) = (kb.as_rows(t, 2) for t in (x, Bmat, Cmat))
    if x.dtype == torch.bfloat16 and kb.load_kernels().omt_ssd_scan_bf16_smem_bytes(P, N):
        # the tensor-core kernel copies rows in pieces of four bf16: 8-byte aligned rows
        (x_c, x_rs), (B_c, b_rs), (C_c, c_rs) = (
            _rows_of_four(t, rs) for t, rs in ((x_c, x_rs), (B_c, b_rs), (C_c, c_rs)))
    dt_c, A_c, D_c = _fp32(dt, x.device), _fp32(A, x.device), _fp32(D, x.device)
    y = torch.empty((Bsz, L, H, P), dtype=x.dtype, device=x.device)
    alloc = torch.empty if x_c.numel() else torch.zeros  # the kernel writes every element
    final_state = alloc((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    chunks = -(-L // PLAIN_CHUNK)
    states = (torch.empty((Bsz, chunks, H, P, N), dtype=torch.float32, device=x.device)
              if return_chunk_states else None)
    if x_c.numel():
        err = kb.load_kernels().omt_ssd_scan(
            x_c.data_ptr(), dt_c.data_ptr(), A_c.data_ptr(), B_c.data_ptr(), C_c.data_ptr(),
            _ptr(D_c), y.data_ptr(), final_state.data_ptr(), _ptr(states),
            x_rs, b_rs, c_rs, Bsz, L, H, P, G, N, kb.dtype_code(x_c.dtype), kb.current_stream(x.device),
        )
        kb.check_launch(err, "ssd_fused")
        ssd_fused.launches += 1
    return (y, final_state, states) if return_chunk_states else (y, final_state)


def ssd_fused_bwd(
    x: torch.Tensor,  # (B, L, H, P) float32 or bfloat16
    dt: torch.Tensor,  # (B, L, H)
    A: torch.Tensor,  # (H,)
    Bmat: torch.Tensor,  # (B, L, G, N) in x.dtype
    Cmat: torch.Tensor,  # (B, L, G, N) in x.dtype
    D: Optional[torch.Tensor],  # (H,) or None
    chunk_states: torch.Tensor,  # (B, C, H, P, N) fp32 from the forward kernel
    gy: torch.Tensor,  # (B, L, H, P) in x.dtype
    gstate: Optional[torch.Tensor] = None,  # (B, H, P, N) or None: no cotangent
):
    """Backward of ``ssd_fused``: (dx, ddt, dA, dB, dC, dD) in the types of
    x, dt, A, Bmat, Cmat, D. An absent ``gstate`` is a null pointer for the
    kernel, not a tensor of zeros."""
    if not x.is_cuda:
        return ssd_bwd_plain(x, dt, A, Bmat, Cmat, D, chunk_states, gy, gstate)
    Bsz, L, H, P = x.shape
    G, N = _check_scan_inputs(x, dt, A, Bmat, Cmat)
    chunks = -(-L // PLAIN_CHUNK)
    if chunk_states.shape != (Bsz, chunks, H, P, N) or chunk_states.dtype != torch.float32:
        raise ValueError(
            f"chunk_states must be float32 {(Bsz, chunks, H, P, N)}, got "
            f"{chunk_states.dtype} {tuple(chunk_states.shape)}")
    if gy.shape != x.shape or gy.device != x.device:
        raise ValueError("gy must have x's shape and device")
    if gstate is not None and (gstate.shape != (Bsz, H, P, N) or gstate.device != x.device):
        raise ValueError("gstate must be (B, H, P, N) on x's device")
    dev = x.device
    (x_c, x_rs), (B_c, b_rs), (C_c, c_rs) = (kb.as_rows(t, 2) for t in (x, Bmat, Cmat))
    g_c, g_rs = kb.as_rows(gy.to(x.dtype), 2)
    if x.dtype == torch.bfloat16 and kb.load_kernels().omt_ssd_scan_bwd_bf16_smem_bytes(P, N):
        # the tensor-core kernel copies rows in pieces of four bf16: 8-byte aligned rows
        (x_c, x_rs), (B_c, b_rs), (C_c, c_rs), (g_c, g_rs) = (
            _rows_of_four(t, rs) for t, rs in ((x_c, x_rs), (B_c, b_rs), (C_c, c_rs), (g_c, g_rs)))
    dt_c, A_c, D_c, gs_c = _fp32(dt, dev), _fp32(A, dev), _fp32(D, dev), _fp32(gstate, dev)
    hin = chunk_states.contiguous()

    rep = H // G
    first = BWD_BF16_CLUSTER if x.dtype == torch.bfloat16 else BWD_HEAD_TILE
    tile = next(t for t in (first, 4, 2, 1) if t <= first and rep % t == 0)
    tiles = H // tile  # blocks per batch row; each tile lies inside one group
    alloc = torch.empty if x_c.numel() else torch.zeros
    dx = alloc((Bsz, L, H, P), dtype=x.dtype, device=dev)
    ddt = alloc((Bsz, L, H), dtype=torch.float32, device=dev)
    dB = alloc((Bsz, L, G, N), dtype=x.dtype, device=dev)
    dC = alloc((Bsz, L, G, N), dtype=x.dtype, device=dev)
    dA = alloc((H,), dtype=torch.float32, device=dev)
    dD = alloc((H,), dtype=torch.float32, device=dev)
    # per-block partials, summed in index order by the second kernel
    dBC_part = torch.empty((2, Bsz, L, tiles, N), dtype=torch.float32, device=dev)
    dAD_part = torch.empty((2, Bsz, H), dtype=torch.float32, device=dev)
    if x_c.numel():
        err = kb.load_kernels().omt_ssd_scan_bwd(
            x_c.data_ptr(), dt_c.data_ptr(), A_c.data_ptr(), B_c.data_ptr(), C_c.data_ptr(),
            _ptr(D_c), hin.data_ptr(), g_c.data_ptr(), _ptr(gs_c),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dD.data_ptr(), dBC_part.data_ptr(), dAD_part.data_ptr(),
            x_rs, b_rs, c_rs, g_rs, Bsz, L, H, P, G, N, tile,
            kb.dtype_code(x_c.dtype), kb.current_stream(dev),
        )
        kb.check_launch(err, "ssd_fused_bwd")
        ssd_fused_bwd.launches += 1
    return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC,
            None if D is None else dD.to(D.dtype))


class _SSDFunction(torch.autograd.Function):
    """Forward kernel with chunk states kept, backward kernel (plain versions
    for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, D):
        # a policy that keeps K1's outputs hands them back in the backward's
        # second forward, and the kernel does not run again (ops/remat.py)
        y, final_state, states = kept(
            ("ssd_out", "ssd_resid"), lambda: _scan_forward(x, dt, A, Bmat, Cmat, D, True))
        ctx.has_D = D is not None
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, states, *([D] if ctx.has_D else []))
        ctx.set_materialize_grads(False)
        return y, final_state

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gstate):
        x, dt, A, Bmat, Cmat, states, *rest = ctx.saved_tensors
        D = rest[0] if ctx.has_D else None
        if gy is None:  # only the final state was used downstream
            gy = torch.zeros_like(x)
        return ssd_fused_bwd(x, dt, A, Bmat, Cmat, D, states, gy, gstate)


def ssd_fused(
    x: torch.Tensor,  # (B, L, H, P) float32 or bfloat16
    dt: torch.Tensor,  # (B, L, H) softplus'ed
    A: torch.Tensor,  # (H,) negative
    Bmat: torch.Tensor,  # (B, L, G, N) in x.dtype
    Cmat: torch.Tensor,  # (B, L, G, N) in x.dtype
    D: Optional[torch.Tensor] = None,  # (H,)
    *,
    return_chunk_states: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Returns (y (B,L,H,P) in x.dtype, final_state (B,H,P,N) fp32) and, with
    ``return_chunk_states``, the fp32 states entering each chunk of
    ``PLAIN_CHUNK`` tokens, (B, C, H, P, N); that form is not differentiable.
    Differentiable otherwise: a gradient runs the backward kernel."""
    if return_chunk_states:
        return _scan_forward(x, dt, A, Bmat, Cmat, D, True)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, dt, A, Bmat, Cmat, D))
    if needs_grad:
        return _SSDFunction.apply(x, dt, A, Bmat, Cmat, D)
    return _scan_forward(x, dt, A, Bmat, Cmat, D, False)


# kernel launches since the counter was last set to 0 (plain-version calls do not count)
ssd_fused.launches = 0
ssd_fused_bwd.launches = 0
