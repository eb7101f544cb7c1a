"""Mamba-2 mixer: counterpart of ``omnimamba_tpu/models/mamba2.py``.

    in_proj (+ task LoRA)                        -> [z | x | B | C | dt]
    depthwise causal conv + SiLU on [x|B|C]      -> x, B, C
    SSD scan (h_t = e^{dt A} h + dt B x)         -> y
    gated RMSNorm(y, z), out_proj                -> (B, L, d_model)

Prefill and training run the scan kernel (``ops/ssd_kernel.py``), or the
chunked tensor code when the sequence continues from a cached state; decode
is the O(1) recurrent ``mamba2_step`` on the step kernel
(``ops/ssd_step_kernel.py``). The full-sequence forward is differentiable:
the scan and the gated norm bring their own backward kernels, the rest is
tensor code that writes nothing in place.

Parameter layout (one layer; a plain dict of tensors, kernels stored
``(in, out)`` and applied as ``x @ W``):

    in_proj.kernel   (d, 2*d_inner + 2*G*N + H)   columns z | x | bc | dt
    conv.weight      (W, d_inner + 2*G*N)         taps oldest first, x | bc
    conv.bias        (d_inner + 2*G*N,)
    dt_bias, A_log, D  (H,)
    norm.weight      (d_inner,)
    out_proj.kernel  (d_inner, d)
    lora.{task}_A    (n, d, r)
    lora.{task}_B    (n, r, 2*d_inner + 2*G*N + H)  columns as in_proj

The JAX package stores in_proj, the LoRA B factors and the conv taps as
column slices so that a mesh can shard them; one card needs one product, so
the port stores them fused in the same column order
(``utils/bridge.from_jax_params`` concatenates the slices).

For serving, in_proj and out_proj may be int8 ``{"kernel": {"q", "scale"}}``
entries (``ops/quant.quantize_decode_params``); every product goes through
``ops/quant.matmul_any``, which takes either form, and the SSM state of a
decode cache may be scaled int8 (``ops/quant.quantize_ssm_state``).

Under head-parallel tp (``parallel/sharding.py``) a rank's mixer holds its
H / tp heads: in_proj ``z_r | x_r | bc | dt`` (bc and dt whole), the conv's
``x_r | bc`` channels, ``d_inner / tp`` entries of the norm's weight and
rows of out_proj. Every function here reads the cut from its leaves
(``parallel/tensor.mixer_tp``) and runs on the rank's heads: the stream
enters through ``tp_enter``, dt is computed for every head and the rank
takes its own (as dt_bias, A_log and D), the scan and the step run on the
rank's heads, the gated norm takes its partial-sum form, and out_proj's
partial product is summed over the ranks in fp32 (``row_parallel``). A decode cache
holds the rank's heads and channels.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.config import LoraConfig, Mamba2LayerConfig
from omnimamba_tpu_torch.ops.conv import (
    causal_conv1d,
    causal_conv1d_step,
    causal_conv1d_train,
    conv_state_from_sequence,
)
from omnimamba_tpu_torch.ops.norms import gated_rms_norm
from omnimamba_tpu_torch.ops.quant import dequantize_ssm_state, matmul_any
from omnimamba_tpu_torch.ops.remat import keeps, kept_product
from omnimamba_tpu_torch.ops.ssd_chunked import ssd_chunked
from omnimamba_tpu_torch.ops.ssd_kernel import ssd_fused
from omnimamba_tpu_torch.ops.ssd_step_kernel import ssd_step_fused
from omnimamba_tpu_torch.parallel.sequence import halo_left, ssd_sp_local
from omnimamba_tpu_torch.parallel.tensor import row_parallel, tp_enter, tp_heads
from omnimamba_tpu_torch.utils.init import uniform

TASKS = ("t2i", "mmu")


class Mamba2Cache(NamedTuple):
    """Per-layer recurrent decode state (constant memory, no KV cache).
    conv_state covers the concatenated [x|B|C] channels."""

    conv_state: torch.Tensor  # (B, W-1, d_conv_in) activation dtype
    ssm_state: object  # (B, H, P, N) fp32 (or the carried cache dtype), or int8 {"q", "scale"}


def init_mamba2(
    generator: torch.Generator,
    cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    n_layer: int,
    dtype: torch.dtype,
    device: torch.device,
) -> Dict:
    """One mixer's params with the reference distributions: kaiming-uniform
    projections, 1/sqrt(n_layer) rescale on out_proj, Mamba-2's A/dt/D init.
    LoRA B factors start at zero."""
    d_model, d_inner, H, W = cfg.d_model, cfg.d_inner, cfg.nheads, cfg.d_conv
    bound_c = 1.0 / math.sqrt(W)

    # dt_bias = softplus^-1(dt), dt ~ exp(U(log dt_min, log dt_max))
    u = torch.rand((H,), generator=generator, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min)) + math.log(cfg.dt_min))
    dt = torch.clamp(dt, min=cfg.dt_init_floor)
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a = torch.rand((H,), generator=generator, dtype=torch.float32, device=device)
    A_log = torch.log(cfg.a_init_min + a * (cfg.a_init_max - cfg.a_init_min))

    params = {
        "in_proj": {"kernel": uniform(
            generator, (d_model, cfg.d_in_proj), 1.0 / math.sqrt(d_model), dtype, device)},
        "conv": {
            "weight": uniform(generator, (W, cfg.d_conv_in), bound_c, dtype, device),
            "bias": uniform(generator, (cfg.d_conv_in,), bound_c, dtype, device),
        },
        "dt_bias": dt_bias.to(dtype),
        "A_log": A_log.to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=device),
        "norm": {"weight": torch.ones((d_inner,), dtype=dtype, device=device)},
        "out_proj": {"kernel": uniform(
            generator, (d_inner, d_model), 1.0 / math.sqrt(d_inner), dtype, device)
            / math.sqrt(n_layer)},
    }
    if lora_cfg is not None:
        lora = {}
        for task in TASKS:
            lora[f"{task}_A"] = uniform(
                generator, (lora_cfg.lora_nums, d_model, lora_cfg.r),
                1.0 / math.sqrt(d_model), dtype, device)
            lora[f"{task}_B"] = torch.zeros(
                (lora_cfg.lora_nums, lora_cfg.r, cfg.d_in_proj), dtype=dtype, device=device)
        params["lora"] = lora
    return params


def _product(train: bool, name: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w``; in the training forward, the named intermediate ``name``."""
    return kept_product((name,), a, w) if train else a @ w


def _project_parts(
    params: Dict,
    x: torch.Tensor,  # (..., d_model)
    task: Optional[str],
    cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    generator: Optional[torch.Generator] = None,
    split_z: bool = False,
    di: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """in_proj (+ task LoRA) split into the {z, x, bc, dt} column slices. One
    product, or with ``split_z`` (the training forward) two: z and x | bc |
    dt, as the JAX forward computes them, named ``in_proj_z_out`` and
    ``in_proj_out`` for the checkpoint policies (``ops/remat.py``), as are the
    LoRA products (``lora_a_out``, ``lora_b_out``). The two give the one
    product's bits on the CPU and, on an H100, in bf16 at 2,624 and 29,520
    rows and in fp32 at 29,520; in fp32 at 2,624 rows cuBLAS sums the
    narrower product in another order (1.1e-5 off on values up to 5.5:
    ``chip_smoke.py``'s ``remat_policies``). Every checkpoint choice runs
    the same two. With a ``generator`` the LoRA branch sees ``x`` after
    dropout (keep probability ``1 - lora_cfg.dropout``, kept values scaled
    up); ``generator=None`` means no dropout. ``di``: the width of z and x
    in these columns (a tp rank's ``d_inner / tp``; the whole by default)."""
    di = cfg.d_inner if di is None else di
    gn2 = 2 * cfg.ngroups * cfg.d_state
    kernel = params["in_proj"]["kernel"]
    if split_z:
        outs = [kept_product(("in_proj_z_out",), x, kernel[:, :di]),
                kept_product(("in_proj_out",), x, kernel[:, di:])]
        cols = [slice(0, di), slice(di, None)]
    else:
        outs, cols = [matmul_any(x, kernel)], [slice(None)]
    if task is not None and "lora" in params and lora_cfg is not None:
        lp = params["lora"]
        xl = x
        if generator is not None and lora_cfg.dropout > 0.0:
            keep_p = 1.0 - lora_cfg.dropout
            keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_p
            xl = torch.where(keep, x / keep_p, torch.zeros((), dtype=x.dtype, device=x.device))
        for i in range(lora_cfg.lora_nums):
            h = _product(split_z, "lora_a_out", xl, lp[f"{task}_A"][i])  # (..., r)
            b = lp[f"{task}_B"][i]
            outs = [torch.add(o, _product(split_z, "lora_b_out", h, b[:, c]),
                              alpha=lora_cfg.scaling) for o, c in zip(outs, cols)]
    if split_z:
        z, xbd = outs
        return {"z": z, "xbc": xbd[..., : di + gn2], "dt": xbd[..., di + gn2 :]}
    full = outs[0]
    return {
        "z": full[..., :di],
        "xbc": full[..., di : 2 * di + gn2],
        "dt": full[..., 2 * di + gn2 :],
    }


def _records_grad(params: Dict, x: torch.Tensor) -> bool:
    """Whether autograd records this forward: grad mode is on and ``x`` or a
    parameter of the mixer requires a gradient."""
    if not torch.is_grad_enabled():
        return False

    def any_grad(node):
        if isinstance(node, dict):
            return any(any_grad(v) for v in node.values())
        return isinstance(node, torch.Tensor) and node.requires_grad

    return x.requires_grad or any_grad(params)


def _dt_activation(dt_raw: torch.Tensor, dt_bias: torch.Tensor, cfg: Mamba2LayerConfig):
    # F.softplus is linear above its threshold of 20, where log1p(exp(x)) - x
    # is below 2.1e-9: under fp32 resolution at that magnitude
    dt = F.softplus(dt_raw.float() + dt_bias.float())
    lo, hi = cfg.dt_limit
    if lo > 0.0 or hi < float("inf"):
        dt = torch.clamp(dt, lo, hi)
    return dt


def _split_xbc(xbc: torch.Tensor, cfg: Mamba2LayerConfig, di: Optional[int] = None):
    di = cfg.d_inner if di is None else di
    gn = cfg.ngroups * cfg.d_state
    return xbc[..., :di], xbc[..., di : di + gn], xbc[..., di + gn :]


class _Heads(NamedTuple):
    """The heads a mixer runs on: all, or a tp rank's ``count`` from ``first``."""

    tp: object  # the mixer's TpCut, or None
    first: int
    count: int
    di: int  # count * headdim


def _heads(params: Dict, cfg: Mamba2LayerConfig) -> _Heads:
    tp, first, count = tp_heads(params, cfg.nheads)
    return _Heads(tp, first, count, count * cfg.headdim)


def _out_proj(y: torch.Tensor, w, tp, train: bool) -> torch.Tensor:
    """out_proj of the gated y: one card's product in y's type (named for
    the checkpoint policies in the training forward). Under tp the rank's
    rows give a partial product in fp32, summed over the ranks and rounded
    to y's type once, as one card's product rounds its fp32 sums once."""
    if tp is None:
        return kept_product(("out_proj_out",), y, w) if train else matmul_any(y, w)
    return row_parallel(y, w, tp, ("out_proj_out",) if train else ())


def _own(v: torch.Tensor, heads: _Heads) -> torch.Tensor:
    """The rank's heads of a per-head vector (..., H)."""
    return v if heads.tp is None else v[..., heads.first:heads.first + heads.count]


def mamba2_forward(
    params: Dict,
    x: torch.Tensor,  # (B, L, d_model)
    task: Optional[str],
    cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig] = None,
    *,
    return_cache: bool = False,
    initial_cache: Optional[Mamba2Cache] = None,
    valid_len: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[Mamba2Cache]]:
    """Full-sequence forward (prefill and training).

    ``generator``: LoRA dropout for training (see ``_project_parts``); None
    means no dropout. Where autograd records the forward (from a zero state),
    in_proj is two products and the conv one autograd Function (two, x and
    bc apart, where a policy keeps x's), each named for the checkpoint
    policies (``ops/remat.py``); every policy gives the same values.

    With ``return_cache=True`` also returns the final (conv, ssm) state so a
    decode loop can continue.

    ``initial_cache`` continues from an existing decode state: the conv
    window becomes left context and the scan starts from its state. The scan
    kernel starts from zero, so such a window takes the chunked tensor code.

    ``valid_len`` (scalar or (B,) int tensor) marks positions >= valid_len as
    padding: their dt is zeroed, an exact no-op for the SSM state, and the
    returned conv window ends at each row's last real input. Outputs at
    padded positions are garbage; callers mask.
    """
    B, L, _ = x.shape
    heads = _heads(params, cfg)
    H, P, G, N = heads.count, cfg.headdim, cfg.ngroups, cfg.d_state
    x = tp_enter(x, heads.tp)

    # the training forward takes the operators a checkpoint policy can name
    train = initial_cache is None and _records_grad(params, x)
    parts = _project_parts(params, x, task, cfg, lora_cfg, generator, split_z=train, di=heads.di)
    z, xbc_raw = parts["z"], parts["xbc"]
    conv = params["conv"]
    halo = initial_cache.conv_state if initial_cache is not None else None
    if train and keeps("conv_out"):
        # the policy keeps the conv of x alone, as JAX names it: x and bc apart
        di, w, b = heads.di, conv["weight"], conv["bias"]
        xs = causal_conv1d_train(xbc_raw[..., :di], w[:, :di], b[:di], ("conv_out",))
        bc = causal_conv1d_train(xbc_raw[..., di:], w[:, di:], b[di:], ("conv_bc_out",))
        gn = cfg.ngroups * cfg.d_state
        Bm, Cm = bc[..., :gn], bc[..., gn:]
    elif train:
        # one call: the conv is per channel, so x's columns come out as above
        xbc = causal_conv1d_train(xbc_raw, conv["weight"], conv["bias"], ())
        xs, Bm, Cm = _split_xbc(xbc, cfg, heads.di)
    else:
        xbc = causal_conv1d(xbc_raw, conv["weight"], conv["bias"], initial_state=halo)
        xs, Bm, Cm = _split_xbc(xbc, cfg, heads.di)
    dt = _own(_dt_activation(parts["dt"], params["dt_bias"], cfg), heads)
    if valid_len is not None:
        v = torch.as_tensor(valid_len, device=x.device).reshape(-1, 1, 1)
        keep = torch.arange(L, device=x.device)[None, :, None] < v
        dt = torch.where(keep, dt, torch.zeros_like(dt))
    A = _own(-torch.exp(params["A_log"].float()), heads)
    D = _own(params["D"], heads)

    xh = xs.reshape(B, L, H, P)
    Bh = Bm.reshape(B, L, G, N)
    Ch = Cm.reshape(B, L, G, N)

    init_state = initial_cache.ssm_state if initial_cache is not None else None
    if isinstance(init_state, dict):  # continuing from a scaled-int8 decode state
        init_state = dequantize_ssm_state(init_state)
    if init_state is None:
        y, final_state = ssd_fused(xh, dt, A, Bh, Ch, D)
    else:
        q = cfg.chunk_size
        if L < q:
            # a matched power-of-two chunk avoids padding the quadratic
            # intra-chunk block of a short window to the full chunk width
            q = max(16, 1 << (L - 1).bit_length())
        y, final_state = ssd_chunked(
            xh, dt, A, Bh, Ch, D, chunk_size=q, initial_state=init_state
        )

    y = y.reshape(B, L, heads.di)
    y = gated_rms_norm(y, z, params["norm"]["weight"], cfg.norm_eps, tp=heads.tp)
    out = _out_proj(y, params["out_proj"]["kernel"], heads.tp, train)

    cache = None
    if return_cache:
        if valid_len is None:
            conv_state = conv_state_from_sequence(xbc_raw, cfg.d_conv, initial_state=halo)
        else:
            # window ending at the last REAL token per row: full[v : v+W-1]
            W1 = cfg.d_conv - 1
            left = halo.to(xbc_raw.dtype) if halo is not None else xbc_raw.new_zeros(
                (B, W1, xbc_raw.shape[-1]))
            full = torch.cat([left, xbc_raw], dim=1)
            starts = torch.as_tensor(valid_len, device=x.device).reshape(-1).expand(B)
            idx = starts[:, None] + torch.arange(W1, device=x.device)[None, :]  # (B, W1)
            conv_state = torch.gather(
                full, 1, idx[:, :, None].expand(B, W1, full.shape[-1]))
        cache = Mamba2Cache(conv_state=conv_state.contiguous(), ssm_state=final_state)
    return out, cache


def mamba2_forward_sp_local(
    params: Dict,
    x: torch.Tensor,  # (B, Lloc, d_model): this rank's slice of the sequence
    task: Optional[str],
    cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig] = None,
    *,
    group=None,
) -> torch.Tensor:
    """The mixer's prefill on one rank's slice of a sequence cut over the
    ranks of ``group`` (``parallel/sequence.py``): the conv takes the
    previous rank's last W-1 inputs as its left context (``halo_left``, x
    and bc in one gather: the conv is per channel), the scan passes states
    across ranks (``ssd_sp_local``: K1 from a zero state, then the
    correction), then K3b and out_proj. Without a gradient, as prefill runs.
    Under tp as well, on the rank's heads (the module's docstring)."""
    B, L, _ = x.shape
    heads = _heads(params, cfg)
    H, P, G, N = heads.count, cfg.headdim, cfg.ngroups, cfg.d_state
    parts = _project_parts(params, x, task, cfg, lora_cfg, di=heads.di)
    conv = params["conv"]
    halo = halo_left(parts["xbc"], cfg.d_conv - 1, group)
    xbc = causal_conv1d(parts["xbc"], conv["weight"], conv["bias"], initial_state=halo)
    xs, Bm, Cm = _split_xbc(xbc, cfg, heads.di)
    dt = _own(_dt_activation(parts["dt"], params["dt_bias"], cfg), heads)
    A = _own(-torch.exp(params["A_log"].float()), heads)
    y, _ = ssd_sp_local(xs.reshape(B, L, H, P), dt, A, Bm.reshape(B, L, G, N),
                        Cm.reshape(B, L, G, N), _own(params["D"], heads), group=group)
    y = gated_rms_norm(y.reshape(B, L, heads.di), parts["z"], params["norm"]["weight"],
                       cfg.norm_eps, tp=heads.tp)
    return _out_proj(y, params["out_proj"]["kernel"], heads.tp, False)


def init_cache(
    batch: int, cfg: Mamba2LayerConfig, dtype: torch.dtype, device: torch.device
) -> Mamba2Cache:
    """Empty decode state."""
    return Mamba2Cache(
        conv_state=torch.zeros((batch, cfg.d_conv - 1, cfg.d_conv_in), dtype=dtype, device=device),
        ssm_state=torch.zeros(
            (batch, cfg.nheads, cfg.headdim, cfg.d_state), dtype=torch.float32, device=device),
    )


def mamba2_step(
    params: Dict,
    x_t: torch.Tensor,  # (B, d_model)
    cache: Mamba2Cache,
    task: Optional[str],
    cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig] = None,
) -> Tuple[torch.Tensor, Mamba2Cache]:
    """O(1) single-token decode step.

    **Updates ``cache`` in place** (the conv window rolls, the step kernel
    overwrites the SSM state) and returns it; the JAX function returns a new
    cache and leaves its argument alone."""
    B = x_t.shape[0]
    heads = _heads(params, cfg)
    H, P, G, N = heads.count, cfg.headdim, cfg.ngroups, cfg.d_state

    parts = _project_parts(params, x_t, task, cfg, lora_cfg, di=heads.di)
    conv = params["conv"]
    xbc, new_conv = causal_conv1d_step(
        parts["xbc"], cache.conv_state, conv["weight"], conv["bias"])
    cache.conv_state.copy_(new_conv)
    xs, Bm, Cm = _split_xbc(xbc, cfg, heads.di)
    dt = _own(_dt_activation(parts["dt"], params["dt_bias"], cfg), heads)  # (B, H)
    A = _own(-torch.exp(params["A_log"].float()), heads)

    y, _ = ssd_step_fused(
        xs.reshape(B, H, P), dt, A, Bm.reshape(B, G, N), Cm.reshape(B, G, N),
        _own(params["D"], heads), cache.ssm_state,
    )
    y = gated_rms_norm(y.reshape(B, heads.di), parts["z"], params["norm"]["weight"], cfg.norm_eps,
                       tp=heads.tp)
    return _out_proj(y, params["out_proj"]["kernel"], heads.tp, False), cache
