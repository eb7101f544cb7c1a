"""One decode token through the whole Mamba-2 stack as one CUDA call.

Replaces the TPU kernel ``_fused_decode_kernel`` / ``fused_decode_step`` of
``omnimamba_tpu/ops/decode_fused.py``. Source: ``csrc/decode_fused.cu``.

Per layer: fp32 residual add + RMSNorm, in_proj with the task's LoRA, the
conv shift-register step + SiLU, softplus(dt), the SSM update, and the gated
RMSNorm folded into out_proj. The conv windows and SSM states of the stacked
``BackboneCache`` are **updated in place**; the hidden and residual streams
and every intermediate stay out of the caller's sight in a small scratch.

What bounds it on an H100: the step must move every layer's weights once
and its state twice, so by bytes it is a bandwidth pump like the TPU kernel.
The design differs because the machine does: the TPU kernel walks a
sequential (layer, head tile) grid on one core; here one C function enqueues
four small kernels per layer on the current stream (stream order separates
the phases), all 132 SMs share each layer's weights and state, and the host
makes one call per token instead of a Python loop over the layers. The two
products are written by hand: for bf16 activations and weights the weight
tiles stream into warp-level tensor-core products, so the weight bytes are
the cost (the in_proj through TMA copies, two blocks of a cluster per column
tile, the copies of its weights started while the pre-norm still runs; the
out_proj the same way per column tile and K split, its weights asked for
while the SSM update ends; both read their weights and activations through
tensor maps that ``prepare_fused_decode`` encodes once); the
other case (fp32 activations and weights, and any shape that is not whole
tiles) takes fp32 multiply-adds over shared-memory tiles, which are bound by
operations (see the note in the source). Activations and weights of two
different types are refused, as the model's own projections refuse them.
The SSM update asks for a whole (row, head) tile of state at once, while the
in_proj still runs; the bf16 pre-norm asks for its weights while the out_proj
still runs.

int8 ``{q, scale}`` in_proj and out_proj (``ops/quant.quantize_decode_params``;
the other weights stay in the activation type) take the same kernels with the
weight tiles landing as int8, half the bytes: the clusters of both products
widen each tile to bf16 in registers before the product (their tensor maps
are encoded for int8), and the multiply-add kernels widen it on the way into
shared memory. The column
scale multiplies the fp32 product in the epilogue, before in_proj's LoRA term
is added (JAX ``_mm`` then ``+ lora_scale * ...``), and each fp32 K-split
partial of out_proj. Two table rows carry the scale pointers. The SSM state
stays fp32 or bf16: an int8 state rides the layer-by-layer path, as in JAX.

Differences from the JAX module, all deliberate:

- no ``FusedDecodeCache`` / ``to_fused_cache``: the kernel takes the
  ``BackboneCache`` tensors with a layer stride, the x|B|C conv window stays
  fused, and the batch is not padded (any B >= 1);
- the per-layer weights are not stacked or copied: ``prepare_fused_decode``
  builds one table of device pointers per operand and keeps the tensors
  alive beside it. Build it inside the call that uses it (``generate`` does):
  a table that outlives its parameters points at freed memory.

``fused_decode_step_plain`` is the plain PyTorch version. It repeats the
kernel's arithmetic and rounding points (which are the TPU kernel's, not
``block_step``'s): the normed hidden state is rounded to the io dtype once;
z, x, B, C and dt come out of in_proj in fp32 and are not rounded (an int8
product is ``(hn @ q) * scale`` in fp32); the conv
step and the SSM update run in fp32 and round only what they store; the
gated ``yf * w`` is rounded to the io dtype before out_proj and the row's
``rsqrt(mean(yf^2) + eps)`` is applied to the fp32 product afterwards.
For a tensor on the CPU the wrapper uses it; for a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.config import LoraConfig, Mamba2LayerConfig
from omnimamba_tpu_torch.ops import kernel_build as kb
from omnimamba_tpu_torch.ops.quant import is_quantized

# rows of the pointer table, in the order of omt::K4Op in csrc/decode_fused.cu;
# the two scale rows are read only for int8 projections
OPERANDS = ("norm_w", "in_proj", "lora_A", "lora_B", "conv_w", "conv_b", "dt_bias", "A_log",
            "D", "gn_w", "out_proj", "in_scale", "out_scale")
MAX_KSPLIT = 8
TC_TILE = 64  # the products take the tensor cores on dims that are multiples of this
TENSOR_MAP_BYTES = 128  # sizeof(CUtensorMap)


def _has_lora(layers: Sequence[Dict], task: Optional[str], lora_cfg: Optional[LoraConfig]) -> bool:
    return task is not None and lora_cfg is not None and "lora" in layers[0]["mixer"]


def fused_decode_limits(
    layers: Sequence[Dict],
    mixer_cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    io_dtype: Optional[torch.dtype] = None,
) -> Optional[Exception]:
    """The exception ``fused_decode_step`` raises for this model (and, when
    given, this activation dtype), or None when the kernel takes it. Depends
    on the model and the types only, never on the device."""
    if mixer_cfg.ngroups != 1:
        return ValueError(
            f"fused decode supports ngroups=1 (every shipped config), not {mixer_cfg.ngroups}")
    if lora_cfg is not None and lora_cfg.lora_nums != 1 and "lora" in layers[0]["mixer"]:
        return ValueError(f"fused decode supports lora_nums=1, not {lora_cfg.lora_nums}")
    lo, hi = mixer_cfg.dt_limit
    if lo > 0.0 or hi < float("inf"):
        return ValueError(f"fused decode has no dt clamp: dt_limit={mixer_cfg.dt_limit}")
    if mixer_cfg.d_state % 4 != 0:
        return ValueError(f"fused decode needs d_state to be a multiple of 4, not {mixer_cfg.d_state}")
    quant = _int8_projections(layers[0])
    for layer in layers:
        mixer = layer["mixer"]
        if {is_quantized(mixer["in_proj"]["kernel"]),
                is_quantized(mixer["out_proj"]["kernel"])} != {quant}:
            return ValueError(
                "fused decode takes in_proj and out_proj of every layer both int8 or both dense")
    w_dtype = layers[0]["norm"]["weight"].dtype
    if io_dtype is not None and io_dtype != w_dtype:
        return ValueError(
            f"fused decode takes activations of the weights' type, not {io_dtype} on {w_dtype}")
    return None


def _int8_projections(layer: Dict) -> bool:
    return is_quantized(layer["mixer"]["in_proj"]["kernel"])


def _operands(layer: Dict, task: Optional[str], lora: bool) -> List[Optional[torch.Tensor]]:
    """The layer's tensors in the order of OPERANDS: an int8 projection gives
    its q in the weight row and its scale in the scale row."""
    mixer = layer["mixer"]
    lp = mixer["lora"] if lora else None
    w_in, w_out = mixer["in_proj"]["kernel"], mixer["out_proj"]["kernel"]
    quant = is_quantized(w_in)
    return [
        layer["norm"]["weight"], w_in["q"] if quant else w_in,
        lp[f"{task}_A"][0] if lora else None, lp[f"{task}_B"][0] if lora else None,
        mixer["conv"]["weight"], mixer["conv"]["bias"], mixer["dt_bias"], mixer["A_log"],
        mixer["D"], mixer["norm"]["weight"], w_out["q"] if quant else w_out,
        w_in["scale"] if quant else None, w_out["scale"] if quant else None,
    ]


@dataclasses.dataclass(frozen=True)
class FusedDecodePlan:
    """What the C function reads, prepared once per ``generate`` call."""

    tables: torch.Tensor  # (len(OPERANDS), n_layer) int64 on the card: device pointers
    keep: Tuple[torch.Tensor, ...]  # the tensors the tables point at, kept alive
    scratch: Dict[str, torch.Tensor]
    batch: int
    rank: int  # LoRA rank, 0 = no LoRA branch
    ksplit: int  # K splits of out_proj
    aligned16: bool  # every tensor of the tables and of the scratch is 16-byte aligned
    io_dtype: torch.dtype
    w_dtype: torch.dtype
    proj_dtype: torch.dtype  # w_dtype, or int8 for {q, scale} projections
    # (n_layer + 1) tensor maps in host memory, W_in of each layer then hn, for
    # a bf16 or int8 in_proj of bf16 activations on whole tiles
    # (omt_fused_decode_in_maps): each launch of that phase takes its two as
    # parameters; else None
    in_maps: Optional[torch.Tensor] = None
    # the same for the out_proj (bf16 or int8) on whole tiles: W_out of each layer then ya
    out_maps: Optional[torch.Tensor] = None


def prepare_fused_decode(
    layers: Sequence[Dict],
    task: Optional[str],
    mixer_cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    batch: int,
    dtype: torch.dtype,
) -> FusedDecodePlan:
    """Pointer tables and scratch for ``fused_decode_step`` on the card the
    parameters lie on. Checks the kernel's limits and every layer's tensors
    (device, one float32 or bfloat16 element type, or int8 projections with
    float32 scales, shape, contiguity); copies none of them."""
    limit = fused_decode_limits(layers, mixer_cfg, lora_cfg, dtype)
    if limit is not None:
        raise limit
    lora = _has_lora(layers, task, lora_cfg)
    d, di, H, N, W = (mixer_cfg.d_model, mixer_cfg.d_inner, mixer_cfg.nheads, mixer_cfg.d_state,
                      mixer_cfg.d_conv)
    r = lora_cfg.r if lora else 0
    shapes = [(d,), (d, mixer_cfg.d_in_proj), (d, r), (r, mixer_cfg.d_in_proj),
              (W, mixer_cfg.d_conv_in), (mixer_cfg.d_conv_in,), (H,), (H,), (H,), (di,), (di, d),
              (mixer_cfg.d_in_proj,), (d,)]
    ref = layers[0]["norm"]["weight"]
    if not ref.is_cuda:
        raise ValueError("prepare_fused_decode is for parameters on a CUDA device")
    kb.dtype_code(ref.dtype)
    proj_dtype = torch.int8 if _int8_projections(layers[0]) else ref.dtype
    dtypes = dict.fromkeys(OPERANDS, ref.dtype)
    dtypes.update(in_proj=proj_dtype, out_proj=proj_dtype, in_scale=torch.float32,
                  out_scale=torch.float32)
    keep, ptrs = [], []
    for i, layer in enumerate(layers):
        row = []
        for name, shape, t in zip(OPERANDS, shapes, _operands(layer, task, lora)):
            if t is None:
                row.append(0)
                continue
            if tuple(t.shape) != shape or t.dtype != dtypes[name] or t.device != ref.device:
                raise ValueError(
                    f"layer {i} {name}: expected {shape} {dtypes[name]} on {ref.device}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"layer {i} {name} must be contiguous")
            keep.append(t)
            row.append(t.data_ptr())
        ptrs.append(row)
    tables = torch.tensor(ptrs, dtype=torch.int64).T.contiguous().to(ref.device)
    ksplit = min(MAX_KSPLIT, max(1, math.ceil(di / 1024)))

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=ref.device)

    scratch = {
        "hn": torch.empty((batch, d), dtype=dtype, device=ref.device),
        "hA": f32(batch, max(r, 1)), "z": f32(batch, di), "xbc": f32(batch, mixer_cfg.d_conv_in),
        "dt": f32(batch, H), "ya": torch.empty((batch, di), dtype=dtype, device=ref.device),
        "sumsq": f32(batch, H), "part": f32(ksplit, batch, d),
    }
    aligned16 = all(t.data_ptr() % 16 == 0 for t in keep + list(scratch.values()))

    proj_code = kb.I8 if proj_dtype == torch.int8 else kb.dtype_code(proj_dtype)

    def tensor_maps(operand, k, n, x):
        # (len(layers) + 1) maps: the (k, n) weight `operand` of each layer, then x (batch, k)
        w = torch.tensor([row[OPERANDS.index(operand)] for row in ptrs], dtype=torch.int64)
        maps = torch.empty(((len(layers) + 1) * TENSOR_MAP_BYTES,), dtype=torch.uint8)
        kb.check_launch(kb.load_kernels().omt_fused_decode_in_maps(
            w.data_ptr(), len(layers), batch, k, n, proj_code, x.data_ptr(),
            maps.data_ptr()), f"prepare_fused_decode: the {operand}'s tensor maps")
        return maps

    # the two-block clusters of both products take bf16 or int8 weights
    in_maps = out_maps = None
    if (dtype == torch.bfloat16 and aligned16
            and d % TC_TILE == 0 and mixer_cfg.d_in_proj % TC_TILE == 0):
        in_maps = tensor_maps("in_proj", d, mixer_cfg.d_in_proj, scratch["hn"])
        if di % TC_TILE == 0:
            out_maps = tensor_maps("out_proj", di, d, scratch["ya"])
    return FusedDecodePlan(tables, tuple(keep), scratch, batch, r, ksplit, aligned16, dtype,
                           ref.dtype, proj_dtype, in_maps, out_maps)


def fused_decode_step_plain(
    layers: Sequence[Dict],
    h: torch.Tensor,  # (B, d) embedded token, io dtype
    residual: Optional[torch.Tensor],  # (B, d) fp32, or None (= zeros)
    cache,  # BackboneCache: conv_state (L,B,W-1,C), ssm_state (L,B,H,P,N); UPDATED IN PLACE
    task: Optional[str],
    mixer_cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    norm_eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, object]:
    """Plain tensor version of the kernel, with its rounding points. Returns
    (h_out (B, d) io dtype, residual_out fp32, cache)."""
    io = h.dtype
    B = h.shape[0]
    di, H, P, N, W = (mixer_cfg.d_inner, mixer_cfg.nheads, mixer_cfg.headdim, mixer_cfg.d_state,
                      mixer_cfg.d_conv)
    lora = _has_lora(layers, task, lora_cfg)
    res = None if residual is None else residual.float()
    for l, layer in enumerate(layers):
        (norm_w, w_in, lora_a, lora_b, conv_w, conv_b, dt_bias, a_log, d_skip, gn_w,
         w_out, s_in, s_out) = _operands(layer, task, lora)
        res = h.float() if res is None else h.float() + res
        var = torch.mean(res * res, dim=-1, keepdim=True)
        hn = (res * torch.rsqrt(var + norm_eps) * norm_w.float()).to(io).float()
        full = hn @ w_in.float()
        if s_in is not None:
            full = full * s_in
        if lora:
            full = full + lora_cfg.scaling * ((hn @ lora_a.float()) @ lora_b.float())
        z, raw, dt_raw = full[:, :di], full[:, di : 2 * di + 2 * N], full[:, 2 * di + 2 * N :]

        window = cache.conv_state[l]  # (B, W-1, C)
        taps, wf = window.float(), conv_w.float()
        y = raw * wf[W - 1]
        for t in range(W - 1):
            y = y + taps[:, t] * wf[t]
        xbc = F.silu(y + conv_b.float())
        window.copy_(torch.cat([taps[:, 1:], raw[:, None]], dim=1))
        x, Bv, Cv = xbc[:, :di].reshape(B, H, P), xbc[:, di : di + N], xbc[:, di + N :]

        dt = F.softplus(dt_raw + dt_bias.float())  # (B, H)
        decay = torch.exp(dt * -torch.exp(a_log.float()))
        state = cache.ssm_state[l]
        new = (state.float() * decay[:, :, None, None]
               + (dt[:, :, None] * x)[..., None] * Bv[:, None, None, :])
        state.copy_(new)
        y = (new * Cv[:, None, None, :]).sum(-1) + x * d_skip.float()[None, :, None]

        yf = y.reshape(B, di) * F.silu(z)
        out = (yf * gn_w.float()).to(io).float() @ w_out.float()
        if s_out is not None:
            out = out * s_out
        rstd = torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + mixer_cfg.norm_eps)
        h = (out * rstd).to(io)
    return h, res, cache


def fused_decode_step(
    layers: Sequence[Dict],
    h: torch.Tensor,  # (B, d) embedded token, float32 or bfloat16
    residual: Optional[torch.Tensor],  # (B, d) fp32, or None (= zeros)
    cache,  # BackboneCache, UPDATED IN PLACE
    task: Optional[str],
    mixer_cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    norm_eps: float = 1e-5,
    *,
    plan: Optional[FusedDecodePlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, object]:
    """One token through all layers: (h_out (B, d), residual_out fp32, cache).
    ``cache`` holds the new conv windows and SSM states when the call returns.
    ``plan``: what ``prepare_fused_decode`` returned for these layers, task,
    batch and dtype (its limits were checked there); without one it is built
    for this call alone."""
    if isinstance(cache.ssm_state, dict):
        raise ValueError("fused decode takes an fp32 or bf16 SSM state; an int8 state rides "
                         "the layer-by-layer path")
    if not h.is_cuda:
        limit = fused_decode_limits(layers, mixer_cfg, lora_cfg, h.dtype)
        if limit is not None:
            raise limit
        return fused_decode_step_plain(
            layers, h, residual, cache, task, mixer_cfg, lora_cfg, norm_eps)

    if plan is None:
        plan = prepare_fused_decode(layers, task, mixer_cfg, lora_cfg, h.shape[0], h.dtype)
    h_out, res_out = _launch(layers, h, residual, cache, task, mixer_cfg, lora_cfg, norm_eps, plan,
                             -1, 0)
    if plan.proj_dtype == torch.int8:
        fused_decode_step.int8_launches += 1
    else:
        fused_decode_step.launches += 1
    return h_out, res_out, cache


def fused_decode_prenorm(
    layers: Sequence[Dict],
    h: torch.Tensor,
    residual: torch.Tensor,
    cache,
    task: Optional[str],
    mixer_cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    norm_eps: float = 1e-5,
    *,
    plan: FusedDecodePlan,
    layer: int,
) -> None:
    """The pre-norm phase of ``layer`` alone, on the card, as
    ``fused_decode_step`` launches it with these arguments: a measurement of
    one phase. Layer 0 reads ``h`` and ``residual``; a later layer reads the
    out_proj's partial sums and the gated norm's sums of squares as the
    plan's scratch holds them (from the last step). ``residual`` is the
    running fp32 residual, which the step keeps in its residual output: it is
    updated in place. Writes the scratch's normed hidden state and its LoRA
    product. Counts no launch."""
    if not 0 <= layer < len(layers):
        raise ValueError(f"layer {layer} of {len(layers)}")
    if residual is None:
        raise ValueError("the pre-norm phase updates a running residual: give one")
    _launch(layers, h, residual, cache, task, mixer_cfg, lora_cfg, norm_eps, plan, layer,
            _PHASE_PRENORM, res_out=residual)


def fused_decode_in_proj(
    layers: Sequence[Dict],
    h: torch.Tensor,
    residual: Optional[torch.Tensor],
    cache,
    task: Optional[str],
    mixer_cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    norm_eps: float = 1e-5,
    *,
    plan: FusedDecodePlan,
    layer: int,
) -> None:
    """The in_proj phase of ``layer`` alone, on the card, as ``fused_decode_step``
    launches it with these arguments: a measurement of one phase. It reads the
    normed hidden state and its LoRA product as the plan's scratch holds them
    (from the last step) and rolls the layer's conv window in place. Counts no
    launch."""
    if not 0 <= layer < len(layers):
        raise ValueError(f"layer {layer} of {len(layers)}")
    _launch(layers, h, residual, cache, task, mixer_cfg, lora_cfg, norm_eps, plan, layer,
            _PHASE_IN_PROJ)


def fused_decode_ssm(
    layers: Sequence[Dict],
    h: torch.Tensor,
    residual: Optional[torch.Tensor],
    cache,
    task: Optional[str],
    mixer_cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    norm_eps: float = 1e-5,
    *,
    plan: FusedDecodePlan,
    layer: int,
) -> None:
    """The SSM-update phase of ``layer`` alone, on the card, as
    ``fused_decode_step`` launches it with these arguments: a measurement of
    one phase. It reads z, x|B|C and dt as the plan's scratch holds them (from
    the last step), updates the layer's SSM state in place and writes the
    scratch's gated output and sums of squares. Counts no launch."""
    if not 0 <= layer < len(layers):
        raise ValueError(f"layer {layer} of {len(layers)}")
    _launch(layers, h, residual, cache, task, mixer_cfg, lora_cfg, norm_eps, plan, layer,
            _PHASE_SSM)


def fused_decode_out_proj(
    layers: Sequence[Dict],
    h: torch.Tensor,
    residual: Optional[torch.Tensor],
    cache,
    task: Optional[str],
    mixer_cfg: Mamba2LayerConfig,
    lora_cfg: Optional[LoraConfig],
    norm_eps: float = 1e-5,
    *,
    plan: FusedDecodePlan,
    layer: int,
) -> None:
    """The out_proj phase of ``layer`` alone, on the card, as
    ``fused_decode_step`` launches it with these arguments: a measurement of
    one phase. It reads the gated, weighted yf as the plan's scratch holds it
    (from the last step) and writes the scratch's fp32 K-split partials.
    Counts no launch."""
    if not 0 <= layer < len(layers):
        raise ValueError(f"layer {layer} of {len(layers)}")
    _launch(layers, h, residual, cache, task, mixer_cfg, lora_cfg, norm_eps, plan, layer,
            _PHASE_OUT_PROJ)


# phases the C function launches alone (omt::K4Phase in csrc/decode_fused.cu)
_PHASE_PRENORM, _PHASE_IN_PROJ, _PHASE_SSM, _PHASE_OUT_PROJ = 1, 2, 3, 4


def _launch(layers, h, residual, cache, task, mixer_cfg, lora_cfg, norm_eps, plan, layer_only,
            phase_only, res_out=None):
    """Checks the arguments and enqueues the C function: the whole step
    (``layer_only`` -1) or phase ``phase_only`` of one layer. The running
    residual goes to ``res_out``, a new tensor if None. Returns (h_out,
    res_out)."""
    L, B, d = len(layers), h.shape[0], mixer_cfg.d_model
    di, H, P, N, W = (mixer_cfg.d_inner, mixer_cfg.nheads, mixer_cfg.headdim, mixer_cfg.d_state,
                      mixer_cfg.d_conv)
    if (plan.batch, plan.io_dtype) != (B, h.dtype) or plan.tables.shape != (len(OPERANDS), L) \
            or plan.tables.device != h.device:
        raise ValueError("the plan was prepared for another batch, dtype, depth or device")
    if h.shape != (B, d) or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous (B, {d}) tensor, got {tuple(h.shape)}")
    if residual is not None and (residual.shape != h.shape or residual.dtype != torch.float32
                                 or residual.device != h.device or not residual.is_contiguous()):
        raise ValueError("residual must be a contiguous float32 tensor of h's shape and device")
    conv, ssm = cache.conv_state, cache.ssm_state
    if (conv.shape != (L, B, W - 1, mixer_cfg.d_conv_in) or conv.dtype != h.dtype
            or conv.device != h.device or not conv.is_contiguous()):
        raise ValueError(
            f"cache.conv_state must be a contiguous {(L, B, W - 1, mixer_cfg.d_conv_in)} "
            f"{h.dtype} tensor on {h.device}, got {tuple(conv.shape)} {conv.dtype} on {conv.device}")
    if ssm.shape != (L, B, H, P, N) or ssm.device != h.device or not ssm.is_contiguous():
        raise ValueError(
            f"cache.ssm_state must be a contiguous {(L, B, H, P, N)} tensor on {h.device}, "
            f"got {tuple(ssm.shape)} on {ssm.device}")
    if ssm.data_ptr() % 16 != 0:
        raise ValueError("cache.ssm_state must be 16-byte aligned")

    h_out = torch.empty_like(h)
    if res_out is None:
        res_out = torch.empty((B, d), dtype=torch.float32, device=h.device)
    s = plan.scratch
    lora_scale = lora_cfg.scaling if plan.rank else 0.0
    err = kb.load_kernels().omt_fused_decode_step(
        plan.tables.data_ptr(), L, B, d, di, H, P, N, W, plan.rank, plan.ksplit,
        float(lora_scale), float(norm_eps), float(mixer_cfg.norm_eps),
        conv.data_ptr(), ssm.data_ptr(), h.data_ptr(),
        None if residual is None else residual.data_ptr(), h_out.data_ptr(), res_out.data_ptr(),
        s["hn"].data_ptr(), s["hA"].data_ptr(), s["z"].data_ptr(), s["xbc"].data_ptr(),
        s["dt"].data_ptr(), s["ya"].data_ptr(), s["sumsq"].data_ptr(), s["part"].data_ptr(),
        kb.dtype_code(h.dtype), kb.dtype_code(plan.w_dtype), kb.dtype_code(ssm.dtype),
        int(plan.aligned16 and conv.data_ptr() % 16 == 0),
        kb.I8 if plan.proj_dtype == torch.int8 else kb.dtype_code(plan.proj_dtype),
        None if plan.in_maps is None else plan.in_maps.data_ptr(),
        None if plan.out_maps is None else plan.out_maps.data_ptr(), layer_only, phase_only,
        kb.current_stream(h.device),
    )
    kb.check_launch(err, "fused_decode_step")
    return h_out, res_out


# token steps that went through the kernel since the counter was last set to 0:
# one per call, whatever the C function launches inside (plain-version calls do not
# count); `launches` with float projections, `int8_launches` with int8 ones
fused_decode_step.launches = 0
fused_decode_step.int8_launches = 0
