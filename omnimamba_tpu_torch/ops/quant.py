"""Weight-only int8 quantization for serving, and the scaled-int8 SSM state.

Counterpart of ``omnimamba_tpu/ops/quant.py``. A quantized entry replaces a
dense kernel ``w`` by ``{"q": int8, "scale": float32}`` with one symmetric
scale per output channel (per row of an embedding table); the scale lands on
the product's fp32 accumulator, so the only approximation is the 8-bit
rounding of the weights. ``matmul_any`` and ``lookup_any`` take either form,
so the model code serves both.

Rounding points are the JAX package's: ``round`` is half-to-even
(``torch.round``, as ``jnp.round``), a weight scale is ``max(amax, 1e-8) /
127``, a state scale ``amax / 127 + 1e-20``, stored squeezed as ``(..., P)``.

Differences from the JAX module, all deliberate:

- a CUDA int8 product always takes the int8 matmul kernel (``quant_kernel``,
  any leading shape, flattened to rows): there is no opt-in switch and no
  batch gate;
- no ``fuse_in_proj``: the port stores in_proj fused already, and
  quantizing the fused kernel per column gives, bit for bit, the JAX parts'
  ``q`` and ``scale`` side by side.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def quantize_linear(w: torch.Tensor, reduce_axes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Symmetric int8 with one scale per kept (output) channel.
    ``reduce_axes``: the contraction axes ((0,) for an (in, out) kernel, (1,)
    for a (rows, d) table quantized per row)."""
    axes = tuple(reduce_axes)
    w32 = w.float()
    amax = torch.amax(w32.abs(), dim=axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    for ax in sorted(axes, reverse=True):
        scale = scale.squeeze(ax)
    return {"q": q.contiguous(), "scale": scale.contiguous()}


def is_quantized(entry) -> bool:
    return isinstance(entry, dict) and "q" in entry


def _unwrap(entry):
    if isinstance(entry, dict) and "kernel" in entry:
        return entry["kernel"]
    return entry


def matmul_any(x: torch.Tensor, entry, *, transpose: bool = False, out_dtype=None) -> torch.Tensor:
    """``x @ kernel`` (``x @ kernel.T`` with ``transpose``), dense or int8.

    ``entry``: a tensor, ``{"kernel": tensor | {"q", "scale"}}`` or
    ``{"q", "scale"}``. An int8 entry goes through ``qmatmul`` (the kernel
    for a CUDA tensor, its plain version on the CPU); the weight is never
    widened in device memory. A dense entry is one ``torch.matmul`` in x's
    type, or in fp32 operands when ``out_dtype`` asks for another type (the
    head: the products of bf16 values are exact in fp32)."""
    entry = _unwrap(entry)
    if is_quantized(entry):
        # imported here so that the plain modules reaching this one for the
        # state helpers (ssd_reference) do not depend on the kernel chain
        from omnimamba_tpu_torch.ops.quant_kernel import qmatmul

        return qmatmul(x, entry["q"], entry["scale"], transpose=transpose, out_dtype=out_dtype)
    w = entry.T if transpose else entry
    if out_dtype is None or out_dtype == x.dtype:
        return x @ w
    return (x.float() @ w.float()).to(out_dtype)


def lookup_any(entry, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding-table row lookup, dense or per-row int8 (plain gather code:
    the JAX package has no kernel here either)."""
    if is_quantized(entry):
        rows = entry["q"][ids].to(dtype)
        return rows * entry["scale"][ids][..., None].to(dtype)
    return _unwrap(entry)[ids].to(dtype)


# ---------------------------------------------------------------------------
# whole-model quantization for decode
# ---------------------------------------------------------------------------

# the JAX rules (quant.py:99-153) on the port's tree: per-layer entries (no
# stacked layer axis, so the contraction axis of a layer kernel is 0), the
# path written without list indices
_QUANT_RULES = [
    ("layers/mixer/in_proj/", (0,)),
    ("layers/mixer/out_proj/kernel", (0,)),
]
_QUANT_TABLES = ["mamba/embedding", "img_embeddings/word_embeddings"]
_QUANT_MLPS = [
    "img_embeddings/project_in/fc1/kernel",
    "img_embeddings/project_in/fc2/kernel",
    "img_embeddings/project_in/fc3/kernel",
]


def _maybe_quant_leaf(path: str, leaf: torch.Tensor):
    for pat, axes in _QUANT_RULES:
        if pat in path:
            return quantize_linear(leaf, axes)
    for pat in _QUANT_TABLES:
        if path.startswith(pat) or path.endswith(pat.split("/")[-1]):
            if path.endswith("embedding") or "word_embeddings" in path:
                return quantize_linear(leaf, (1,))  # (V, d): per row
    for pat in _QUANT_MLPS:
        if pat in path:
            return quantize_linear(leaf, (0,))
    return leaf


def quantize_decode_params(params: Dict) -> Dict:
    """``params`` with the decode-dominant kernels int8-quantized: the fused
    in_proj (per output column: ``{"kernel": {"q", "scale"}}``), out_proj,
    the two embedding tables (per row) and ``project_in`` fc1-fc3. The
    structure is kept; a quantized leaf becomes a ``{"q", "scale"}`` dict at
    the same place. Takes the ``{"mamba": ...}`` tree or the backbone alone;
    returns a new tree and leaves ``params`` untouched (the leaves that are
    not quantized are shared)."""

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, prefix) for v in node)  # no index in the path
        if isinstance(node, torch.Tensor):
            return _maybe_quant_leaf(prefix, node)
        return node

    return walk(params, "")


def quantize_ssm_state(state: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Scaled-int8 SSM decode state: one symmetric scale per (..., P) row over
    the d_state axis, stored squeezed."""
    sf = state.float()
    scale = torch.amax(sf.abs(), dim=-1) / 127.0 + 1e-20
    q = torch.round(sf / scale[..., None]).to(torch.int8)
    return {"q": q.contiguous(), "scale": scale.contiguous()}


def quantize_ssm_state_by_layer(state: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``quantize_ssm_state`` of a stacked (n_layer, ..., P, N) state, one
    layer at a time into q and scale allocated once: the same bits, with
    temporaries the size of one layer's state in place of several the size of
    the whole stack's."""
    q = torch.empty(state.shape, dtype=torch.int8, device=state.device)
    scale = torch.empty(state.shape[:-1], dtype=torch.float32, device=state.device)
    for i in range(state.shape[0]):
        layer = quantize_ssm_state(state[i])
        q[i].copy_(layer["q"])
        scale[i].copy_(layer["scale"])
    return {"q": q, "scale": scale}


def dequantize_ssm_state(state) -> torch.Tensor:
    """fp32 view of an SSM state in either representation."""
    if isinstance(state, dict):
        return state["q"].float() * state["scale"][..., None]
    return state.float()
