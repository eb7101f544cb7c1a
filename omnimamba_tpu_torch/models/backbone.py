"""Mamba backbone: embeddings + 48 blocks + final norm + dual vocab heads.

Counterpart of ``omnimamba_tpu/models/backbone.py``:

- the layers are a Python list of per-layer dicts driven by a Python loop
  (the JAX package stacks them on a leading axis for ``lax.scan``);
- the task is an argument selecting the LoRA branch and the head;
- heads are weight-tied to their embedding tables and computed with fp32
  operands and an fp32 result, so greedy argmax is stable in bf16.

Embedding extras:
- t2i: ``img_embeddings`` = 16384-row table + FusedMLP ``project_in``,
  learned ``pos_embed`` (1, 256+73, d), ``caption_embed`` MLP;
- mmu: ``mmu_pos_embed`` (1, 1500, d);
- text ``embedding`` (padded vocab).

Linear kernels are stored ``(in, out)`` and applied as ``x @ W``. For
serving, the tables, ``project_in`` and the mixers' projections may be int8
``{"q", "scale"}`` entries (``ops/quant.quantize_decode_params``); lookups and
products go through ``lookup_any`` / ``matmul_any``, which take either form.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.config import MambaConfig
from omnimamba_tpu_torch.models.blocks import block_forward, block_step
from omnimamba_tpu_torch.models.mamba2 import Mamba2Cache, init_mamba2
from omnimamba_tpu_torch.ops.decode_fused import FusedDecodePlan, fused_decode_step
from omnimamba_tpu_torch.ops.norms import rms_norm
from omnimamba_tpu_torch.ops.quant import is_quantized, lookup_any, matmul_any
from omnimamba_tpu_torch.utils.device import resolve_device
from omnimamba_tpu_torch.utils.init import normal, trunc_normal, uniform


def check_supported(cfg: MambaConfig) -> None:
    """Raise for config options whose modules are not ported yet."""
    if cfg.attn_layer_idx:
        raise NotImplementedError(
            "attn_layer_idx != (): attention layers arrive with ops/attention (ROADMAP: slice 6)"
        )
    if cfg.d_intermediate > 0:
        raise NotImplementedError(
            "d_intermediate > 0: the GatedMLP sub-block arrives with ops/attention (ROADMAP: slice 6)"
        )


def _linear_init(gen, d_in, d_out, dtype, device, scale=1.0, bias=True):
    w = uniform(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), torch.float32, device) * scale
    out = {"kernel": w.to(dtype)}
    if bias:
        out["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return out


def init_backbone(
    generator: torch.Generator,
    cfg: MambaConfig,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> Dict:
    """Full parameter dict with the reference init distributions (embeddings
    normal(0.02), linear biases zero, out_proj and the caption MLP's fc2
    rescaled 1/sqrt(n_layer)). ``generator`` must live on ``device``."""
    check_supported(cfg)
    device = resolve_device(device)
    d = cfg.d_model
    params: Dict = {
        "embedding": normal(generator, (cfg.padded_vocab_size, d), 0.02, dtype, device)
    }
    if cfg.t2i_task:
        params["img_embeddings"] = {
            "word_embeddings": normal(generator, (cfg.vqvae_vocab_size, d), 0.02, dtype, device),
            # FusedMLPProjector(d, d): d -> 4d -> d -> d, GELU between
            "project_in": {
                "fc1": _linear_init(generator, d, 4 * d, dtype, device),
                "fc2": _linear_init(generator, 4 * d, d, dtype, device),
                "fc3": _linear_init(generator, d, d, dtype, device),
            },
        }
        params["pos_embed"] = trunc_normal(generator, (1, cfg.t2i_pos_len, d), 0.02, dtype, device)
        params["caption_embed"] = {
            "fc1": _linear_init(generator, d, d, dtype, device, bias=False),
            "fc2": _linear_init(
                generator, d, d, dtype, device, scale=1.0 / math.sqrt(cfg.n_layer), bias=False),
        }
    if cfg.mmu_task:
        params["mmu_pos_embed"] = trunc_normal(
            generator, (1, cfg.mmu_pos_len, d), 0.02, dtype, device)
    params["layers"] = [
        {
            "norm": {"weight": torch.ones((d,), dtype=dtype, device=device)},
            "mixer": init_mamba2(generator, cfg.mixer, cfg.lora, cfg.n_layer, dtype, device),
        }
        for _ in range(cfg.n_layer)
    ]
    params["norm_f"] = {"weight": torch.ones((d,), dtype=dtype, device=device)}
    return params


# ---------------------------------------------------------------------------
# embedding helpers
# ---------------------------------------------------------------------------


def _linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The product rounds to x's type, then the bias is added (the JAX
    rounding points)."""
    return matmul_any(x, p["kernel"]) + p["bias"].to(x.dtype)


def _fused_mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """FusedMLPProjector forward: Lin-GELU-Lin-GELU-Lin, exact (erf) GELU."""
    h = F.gelu(_linear(p["fc1"], x))
    h = F.gelu(_linear(p["fc2"], h))
    return _linear(p["fc3"], h)


def embed_text(params: Dict, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return lookup_any(params["embedding"], ids, dtype)


def embed_image_tokens(params: Dict, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """img_embeddings: table lookup + FusedMLP project_in."""
    e = lookup_any(params["img_embeddings"]["word_embeddings"], ids, dtype)
    return _fused_mlp(params["img_embeddings"]["project_in"], e)


def caption_embed(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """CaptionEmbedder MLP: no biases, tanh-approximated GELU."""
    p = params["caption_embed"]
    h = F.gelu(x @ p["fc1"]["kernel"].to(x.dtype), approximate="tanh")
    return h @ p["fc2"]["kernel"].to(x.dtype)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


class BackboneCache(NamedTuple):
    """Stacked per-layer decode state: leading axis = layer. The SSM state
    may be scaled int8 (``ops/quant.quantize_ssm_state``): a dict with q
    (n_layer, B, H, P, N) int8 and scale (n_layer, B, H, P) fp32."""

    conv_state: torch.Tensor  # (n_layer, B, W-1, d_conv_in)
    ssm_state: object  # (n_layer, B, H, P, N) fp32 or the cache dtype, or int8 {"q", "scale"}


def layer_state(state, i: int):
    """Layer ``i`` of a stacked SSM state in either representation (views:
    an update of the layer's state lands in the stack)."""
    if isinstance(state, dict):
        return {k: v[i] for k, v in state.items()}
    return state[i]


def _final_norm(params, h, residual, eps, dtype):
    return rms_norm(h.float() + residual, params["norm_f"]["weight"], eps).to(dtype)


def check_remat(remat) -> bool:
    """``remat`` as a bool. The JAX package's selective checkpoint policies
    (save only named intermediates of a block) have no counterpart yet."""
    if remat is True or remat is False:
        return remat
    raise NotImplementedError(
        f"remat={remat!r}: the port checkpoints whole blocks (True) or nothing (False); the "
        "selective policies 'proj_xbd', 'proj_ssd', 'proj_conv_ssd' and 'dots' are not ported "
        "yet (ROADMAP: selective checkpoint policies)"
    )


def _checkpointed(run, generator: Optional[torch.Generator], *args):
    """``run(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): only the
    arguments are kept and the block runs again in the backward. The
    recompute starts from the generator state the first run started from, so
    it draws the same dropout masks, and leaves the generator where it found
    it."""
    from torch.utils.checkpoint import checkpoint

    if generator is None:
        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    entry = generator.get_state()
    first = [True]

    def replay(*a):
        if first[0]:
            first[0] = False
            return run(*a)
        now = generator.get_state()
        generator.set_state(entry)
        try:
            return run(*a)
        finally:
            generator.set_state(now)

    return checkpoint(replay, *args, use_reentrant=False, preserve_rng_state=False)


def backbone_forward(
    params: Dict,
    embeddings: torch.Tensor,  # (B, L, d)
    task: str,
    cfg: MambaConfig,
    *,
    add_mmu_pos: bool = True,
    return_cache: bool = False,
    initial_cache: Optional[BackboneCache] = None,
    valid_len: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[BackboneCache]]:
    """Full-sequence forward over all layers -> final-normed hidden states.

    Training arguments: ``generator`` draws the LoRA dropout masks (None: no
    dropout; it takes the place of the JAX ``dropout_key``), ``remat=True``
    checkpoints every block (``torch.utils.checkpoint``; only a block's inputs
    stay alive and its forward runs again in the backward, with the same
    masks), ``remat=False`` keeps every activation.

    mmu adds ``mmu_pos_embed[:, :L]``; t2i positions were already added by the
    caller. ``initial_cache``/``valid_len``: continuation prefill from an
    existing decode state (see ``mamba2.mamba2_forward``); callers embed
    positions themselves (``add_mmu_pos=False`` for mmu windows).
    """
    check_supported(cfg)
    remat = check_remat(remat) and torch.is_grad_enabled()
    B, L, d = embeddings.shape
    h = embeddings
    if task == "mmu" and add_mmu_pos:
        pe = params["mmu_pos_embed"][:, :L].to(h.dtype)
        if pe.shape[1] < L:
            # beyond the table the positions carry no learned signal: zeros
            pe = F.pad(pe, (0, 0, 0, L - pe.shape[1]))
        h = h + pe

    # the first block has no incoming residual: x + 0 is x
    residual = None
    caches = []
    for i, layer in enumerate(params["layers"]):
        icache = None
        if initial_cache is not None:
            icache = Mamba2Cache(initial_cache.conv_state[i],
                                 layer_state(initial_cache.ssm_state, i))
        def run(h, residual, layer=layer, icache=icache):
            return block_forward(
                layer, h, residual, task, cfg.mixer, cfg.lora,
                norm_eps=cfg.norm_eps, return_cache=return_cache,
                initial_cache=icache, valid_len=valid_len, generator=generator,
            )

        h, residual, cache = _checkpointed(run, generator, h, residual) if remat else run(h, residual)
        caches.append(cache)
    final = _final_norm(params, h, residual, cfg.norm_eps, embeddings.dtype)

    out_cache = None
    if return_cache:
        out_cache = BackboneCache(
            conv_state=torch.stack([c.conv_state for c in caches]),
            ssm_state=torch.stack([c.ssm_state for c in caches]),
        )
    return final, out_cache


def _decode_embed(params, token_ids, pos, task, cfg, dtype):
    """Per-task next-token embedding + positional gather. ``pos`` is an int
    (all rows at the same position) or a (B,) tensor (ragged batches)."""
    if isinstance(pos, torch.Tensor):
        pos_v = pos.to(token_ids.device).long().expand(token_ids.shape[0])
    else:
        pos_v = torch.full((token_ids.shape[0],), int(pos), dtype=torch.long, device=token_ids.device)
    if task == "t2i":
        h = embed_image_tokens(params, token_ids, dtype)
        return h + params["pos_embed"][0][pos_v].to(dtype)
    if task == "mmu":
        h = embed_text(params, token_ids, dtype)
        pe = params["mmu_pos_embed"][0][torch.clamp(pos_v, max=cfg.mmu_pos_len - 1)]
        return h + pe.to(dtype)
    raise ValueError(task)


def embed_decode_window(
    params: Dict,
    token_ids: torch.Tensor,  # (B, K)
    pos0: int,  # absolute position of token_ids[:, 0]
    task: str,
    cfg: MambaConfig,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Decode-style embeddings (B, K, d) of a K-token window at positions
    pos0 .. pos0 + K - 1: the batched ``_decode_embed``. Feed them to
    ``backbone_forward(..., add_mmu_pos=False, initial_cache=...)`` for a
    continuation prefill (the verify pass of speculative decoding)."""
    B, K = token_ids.shape
    pos = (int(pos0) + torch.arange(K, device=token_ids.device)).repeat(B)
    emb = _decode_embed(params, token_ids.reshape(B * K), pos, task, cfg, dtype)
    return emb.reshape(B, K, -1)


def backbone_step(
    params: Dict,
    token_ids: torch.Tensor,  # (B,) next-token ids
    pos,  # int or (B,) tensor: current position
    cache: BackboneCache,
    task: str,
    cfg: MambaConfig,
    *,
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, BackboneCache]:
    """One decode token through all layers: per-task embedding + positional
    gather, then each layer advances its conv window and SSM state.
    ``cache`` is updated in place and returned."""
    check_supported(cfg)
    h = _decode_embed(params, token_ids, pos, task, cfg, dtype)
    residual = None
    for i, layer in enumerate(params["layers"]):
        h, residual, _ = block_step(
            layer, h, residual, Mamba2Cache(cache.conv_state[i], layer_state(cache.ssm_state, i)),
            task, cfg.mixer, cfg.lora, norm_eps=cfg.norm_eps,
        )
    return _final_norm(params, h, residual, cfg.norm_eps, dtype), cache


def backbone_step_fused(
    params: Dict,
    token_ids: torch.Tensor,  # (B,) next-token ids
    pos,  # int or (B,) tensor: current position
    cache: BackboneCache,
    task: str,
    cfg: MambaConfig,
    *,
    dtype=torch.bfloat16,
    plan: Optional[FusedDecodePlan] = None,
) -> Tuple[torch.Tensor, BackboneCache]:
    """``backbone_step`` through the whole-model decode kernel
    (``ops/decode_fused.py``): the embedding, one call for all layers, the
    final norm. Same semantics; ``cache`` is updated in place and returned.
    ``plan``: the kernel's pointer tables and scratch from
    ``prepare_fused_decode``, built once per generation; without one the
    wrapper builds them for this step alone."""
    check_supported(cfg)
    h = _decode_embed(params, token_ids, pos, task, cfg, dtype)
    h, residual, _ = fused_decode_step(
        params["layers"], h.contiguous(), None, cache, task, cfg.mixer, cfg.lora,
        cfg.norm_eps, plan=plan)
    return _final_norm(params, h, residual, cfg.norm_eps, dtype), cache


def apply_head(params: Dict, hidden: torch.Tensor, task: str) -> torch.Tensor:
    """Task-routed weight-tied head (img head for t2i, lm head for mmu) with
    an fp32 result. Both operands are widened to fp32 before the product: the
    products of bf16 values are exact in fp32 and the sum is taken in fp32,
    which is what fp32 accumulation of bf16 operands computes; a bf16 result
    would round the logits and could flip a greedy argmax. An int8 table
    goes through the int8 product in its transposed layout with an fp32
    result."""
    if task == "t2i":
        table = params["img_embeddings"]["word_embeddings"]
    elif task == "mmu":
        table = params["embedding"]
    else:
        raise ValueError(task)
    if is_quantized(table):
        return matmul_any(hidden, table, transpose=True, out_dtype=torch.float32)
    return hidden.float() @ table.float().T
