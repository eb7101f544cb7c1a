"""Autoregressive decode engine: counterpart of
``omnimamba_tpu/models/generation.py``.

Prefill is one full-sequence forward returning the recurrent cache; the token
loop is a Python loop whose body samples, embeds, runs the 48-layer recurrent
step (one call of the whole-model decode kernel, or a Python loop over the
layers: ``decode_impl``) and applies the tied head in fp32. Constant-memory
state, no KV cache.

Semantics kept from the JAX engine:
- the first sampled token comes from the prefill logits
- decode-step position id = prompt length + tokens sampled so far
- early stop when *all* current tokens equal eos
- ``teacher_outputs`` overrides sampling for full-sequence replay
- classifier-free guidance: pack [cond; uncond] along batch, pass
  ``cfg_scale``; logits combine as uncond + s*(cond-uncond) and both halves
  consume the cond half's token
- ragged batches through ``prompt_lengths``

Everything stays on the device inside the loop; the host reads a value only
for the eos test (when ``eos_token_id`` is given) and for ``token_callback``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from omnimamba_tpu_torch.config import MambaConfig
from omnimamba_tpu_torch.models.backbone import (
    apply_head,
    backbone_forward,
    backbone_step,
    backbone_step_fused,
)
from omnimamba_tpu_torch.ops.decode_fused import fused_decode_limits, prepare_fused_decode
from omnimamba_tpu_torch.ops.quant import quantize_ssm_state_by_layer
from omnimamba_tpu_torch.ops.sampling import (
    SampleParams,
    apply_repetition_penalty,
    sample_token,
)
from omnimamba_tpu_torch.utils.device import require_on, resolve_device


class GenerateOutput(NamedTuple):
    sequences: torch.Tensor  # (B, L0 + new) int64: prompt ids ++ generated
    num_generated: int  # valid generated count
    logits: Optional[List[torch.Tensor]] = None  # per step (B, V) fp32, on request


def generate(
    params: Dict,
    cfg: MambaConfig,
    *,
    input_ids: torch.Tensor,  # (B, L0)
    input_embeddings: torch.Tensor,  # (B, L0, d), positions already applied per task
    task: str,
    max_length: int,
    sample: SampleParams = SampleParams(),
    eos_token_id: Optional[int] = None,
    teacher_outputs: Optional[torch.Tensor] = None,  # (B, >=max_length) full-seq ids
    generator: Optional[torch.Generator] = None,
    cfg_scale: Optional[float] = None,
    cache_dtype="auto",
    decode_impl: str = "auto",  # auto | fused | scan
    token_callback: Optional[Callable[[np.ndarray], None]] = None,
    prompt_lengths: Optional[torch.Tensor] = None,  # (B,) ragged true lengths
    return_logits: bool = False,
    device="cuda",
) -> GenerateOutput:
    """``token_callback(tokens (B,) np.int32)``: host-side streaming hook,
    called once per sampled token (each call waits for the device).

    ``cache_dtype``: carry the SSM state in this dtype during decode. The
    state's read and write is the dominant memory traffic of batched decode;
    "auto" carries it in bf16 at B >= 16 and in fp32 below, None forces fp32,
    ``torch.bfloat16`` forces bf16, ``"int8"`` (or ``torch.int8``) the
    scaled-int8 state of ``ops/quant.quantize_ssm_state``, which rides the
    layer-by-layer path ("auto" then takes "scan"; "fused" raises
    ``ValueError``).

    ``decode_impl``: "fused" takes each token through all layers in one call
    of the whole-model decode kernel (``backbone_step_fused``); "scan" loops
    over the layers in Python (``backbone_step``), a few dozen launches per
    layer. "auto" takes "fused" wherever the kernel's limits are met (one
    group, ``lora_nums == 1``, no ``dt_limit``, float32 or bfloat16 weights
    and embeddings of the same type) and "scan" elsewhere; the choice depends
    on the model and its types, never on the device. "fused" raises where a
    limit is not met. int8 ``{q, scale}`` weights
    (``ops/quant.quantize_decode_params``) take either path.

    ``prompt_lengths`` (B,): ragged batching. ``input_ids``/embeddings are
    right-padded to L0; row i's true prompt is its first prompt_lengths[i]
    tokens. Padded positions are exact SSM no-ops, each row samples its first
    token from its own last real position, and decode positions advance per
    row, so every row's stream equals running it alone at B=1.

    ``return_logits``: also return the fp32 logits each token was sampled
    from (after the guidance mix), one (B, V) tensor per step.
    """
    device = resolve_device(device)
    require_on(device, input_ids=input_ids, input_embeddings=input_embeddings)
    if decode_impl not in ("auto", "fused", "scan"):
        raise ValueError(f"unknown decode_impl {decode_impl}")
    int8_state = isinstance(cache_dtype, (str, torch.dtype)) and cache_dtype in ("int8", torch.int8)
    if int8_state:
        if decode_impl == "fused":
            raise ValueError("cache_dtype='int8' rides the scan path, not decode_impl='fused'")
        decode_impl = "scan"
    limit = None if decode_impl == "scan" else fused_decode_limits(
        params["layers"], cfg.mixer, cfg.lora, input_embeddings.dtype)
    if decode_impl == "fused" and limit is not None:
        raise limit
    use_fused = decode_impl != "scan" and limit is None
    B, L0 = input_ids.shape
    T_new = max_length - L0
    if T_new <= 0:
        raise ValueError("max_length must exceed prompt length")
    if prompt_lengths is not None:
        if teacher_outputs is not None or cfg_scale is not None:
            raise ValueError("ragged batching composes with plain sampling only")
        prompt_lengths = torch.as_tensor(prompt_lengths, device=device).long()
    input_ids = input_ids.long()

    # ---- prefill ----------------------------------------------------------
    hidden, cache = backbone_forward(
        params, input_embeddings, task, cfg,
        return_cache=True, valid_len=prompt_lengths,
    )
    if isinstance(cache_dtype, str) and cache_dtype == "auto":
        cache_dtype = torch.bfloat16 if B >= 16 else None
    if int8_state:
        cache = cache._replace(ssm_state=quantize_ssm_state_by_layer(cache.ssm_state))
    elif cache_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported cache_dtype {cache_dtype}")
    elif cache_dtype is not None:
        cache = cache._replace(ssm_state=cache.ssm_state.to(cache_dtype))

    step, step_kw = backbone_step, {}
    if use_fused:
        # pointer tables and scratch live as long as this call: a table that
        # outlived the parameters would point at freed memory
        plan = None
        if device.type == "cuda":
            plan = prepare_fused_decode(
                params["layers"], task, cfg.mixer, cfg.lora, B, input_embeddings.dtype)
        step, step_kw = backbone_step_fused, {"plan": plan}

    if prompt_lengths is not None:
        # each row's next-token logits come from its own last REAL position
        h_last = hidden[torch.arange(B, device=device), prompt_lengths - 1]
    else:
        h_last = hidden[:, -1]

    def combine_cfg(logits):
        if cfg_scale is None:
            return logits
        cond, uncond = logits[: B // 2], logits[B // 2 :]
        mixed = uncond + cfg_scale * (cond - uncond)
        return torch.cat([mixed, mixed], dim=0)

    logits = combine_cfg(apply_head(params, h_last, task))  # (B, V) fp32
    tokens = torch.zeros((B, T_new), dtype=torch.long, device=device)
    kept_logits: Optional[List[torch.Tensor]] = [] if return_logits else None
    pmask = None
    if sample.repetition_penalty != 1.0 and prompt_lengths is not None:
        # ragged rows: right-pad tokens must not enter the penalty set
        pmask = torch.arange(L0, device=device)[None, :] < prompt_lengths[:, None]

    n = 0
    while n < T_new:
        if kept_logits is not None:
            kept_logits.append(logits)
        logits_s = logits
        if sample.repetition_penalty != 1.0:
            # the penalty covers the whole sequence so far (prompt + generated)
            prev = torch.cat([input_ids, tokens[:, :n]], dim=1)
            mask = None
            if pmask is not None:
                mask = torch.cat(
                    [pmask, torch.ones((B, n), dtype=torch.bool, device=device)], dim=1)
            logits_s = apply_repetition_penalty(
                logits_s, prev, sample.repetition_penalty, mask)
        tok = sample_token(generator, logits_s, sample)  # (B,)
        if cfg_scale is not None:
            # one draw per image: both halves consume the cond half's token
            tok = torch.cat([tok[: B // 2], tok[: B // 2]])
        if teacher_outputs is not None:
            # teacher indexed by absolute position L0+n
            tok = teacher_outputs[:, L0 + n].to(device=device, dtype=torch.long)
        if token_callback is not None:
            token_callback(tok.cpu().numpy().astype(np.int32))
        tokens[:, n] = tok
        n += 1
        if eos_token_id is not None and bool((tok == eos_token_id).all()):
            break
        if n == T_new:
            break  # the last token needs no further logits
        # next logits: position id = prompt length + tokens sampled before this one
        pos = (L0 + n - 1) if prompt_lengths is None else prompt_lengths + (n - 1)
        hidden, cache = step(
            params, tok, pos, cache, task, cfg, dtype=input_embeddings.dtype, **step_kw)
        logits = combine_cfg(apply_head(params, hidden, task))

    return GenerateOutput(
        sequences=torch.cat([input_ids, tokens], dim=1), num_generated=n, logits=kept_logits)
