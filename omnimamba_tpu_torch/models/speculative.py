"""Speculative greedy decoding for single-stream latency (B=1).

Counterpart of ``omnimamba_tpu/models/speculative.py``. A cheap DRAFT
proposes K tokens one at a time; the TARGET then scores the whole window in
one pass (a continuation prefill, ``backbone_forward(initial_cache=...)``),
accepts the longest draft prefix that matches its own greedy choices, and
adds one correction / bonus token from its logits. In fp32 the stream is the
one plain greedy decoding gives and the draft decides only the speed. In bf16
the verify pass scores a window where plain decoding takes one step a token,
so the two sum and round in other orders: at 1.3B the streams part where the
top-2 logit margin is tiny (on an H100, all three drafts left plain greedy at
the same token, at a margin of 0.0026).

State bookkeeping needs no per-position rollback: the verify pass masks
padded positions to dt = 0, which makes them exact no-ops for the SSM state,
so one fixed window of W = 2K + 2 positions consumes any 1..W real tokens.
The target cache advances only when a window was FULLY accepted (its final
state is then exact); on a partial accept it stays put and the next window
re-consumes the committed tokens it has not consumed yet. When that backlog
fills the window the round only consumes, and always advances.

Draft sources: int8 weights (``ops/quant.quantize_decode_params``), a
shallow prefix of the stack (``draft_layers=M``, ``shallow_draft``), any
model with the same vocabulary, or no model at all (``draft_mode="ngram"``:
prompt-lookup drafts copied from the context).

The loop is host Python, one round a verify pass, with ONE host read a round
(the drafts and the target's argmax chain together); the committed sequence
lives on the host. The draft's steps run through the whole-model decode
kernel wherever its limits are met, as ``generate``'s "auto" does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from omnimamba_tpu_torch.config import MambaConfig
from omnimamba_tpu_torch.models.backbone import (
    BackboneCache,
    apply_head,
    backbone_forward,
    backbone_step,
    backbone_step_fused,
    embed_decode_window,
)
from omnimamba_tpu_torch.ops.decode_fused import fused_decode_limits, prepare_fused_decode
from omnimamba_tpu_torch.utils.device import require_on, resolve_device


class SpecDecodeOutput(NamedTuple):
    sequences: torch.Tensor  # (1, max_length) prompt ++ generated (0-padded)
    num_generated: int
    rounds: int  # verify rounds run
    drafted: int  # draft tokens proposed
    accepted: int  # draft tokens accepted


def shallow_draft(params: Dict, cfg: MambaConfig, m_layers: int):
    """Layer-skip draft: the first ``m_layers`` layers with the same final
    norm, embeddings and tied head. Shares every tensor with ``params``."""
    draft = dict(params)
    draft["layers"] = params["layers"][:m_layers]
    return draft, dataclasses.replace(cfg, n_layer=m_layers)


def _clone_cache(cache: BackboneCache) -> BackboneCache:
    return BackboneCache(cache.conv_state.clone(), cache.ssm_state.clone())


def speculative_generate(
    params: Dict,
    cfg: MambaConfig,
    *,
    input_ids: torch.Tensor,  # (1, L0)
    input_embeddings: torch.Tensor,  # (1, L0, d)
    task: str,
    max_length: int,
    draft_params: Optional[Dict] = None,
    draft_cfg: Optional[MambaConfig] = None,
    draft_layers: Optional[int] = None,
    k_draft: int = 8,
    eos_token_id: Optional[int] = None,
    cache_dtype=None,
    draft_mode: str = "model",  # model | ngram
    ngram: int = 3,
    device="cuda",
) -> SpecDecodeOutput:
    """Greedy speculative decode; returns the stream of
    ``generate(..., sample=SampleParams(top_k=1))``.

    ``draft_params`` defaults to ``params`` (then set ``draft_layers``, else
    the draft is the target itself). ``draft_mode="ngram"`` needs no draft
    model: the drafts are copied from the most recent context position whose
    preceding ``ngram`` tokens match the current tail.
    """
    device = resolve_device(device)
    require_on(device, input_ids=input_ids, input_embeddings=input_embeddings)
    B, L0 = input_ids.shape
    if B != 1:
        raise ValueError("speculative decode is the single-stream path (B=1)")
    if cache_dtype == "auto":
        cache_dtype = None  # B=1: the state's traffic is not the bottleneck
    if cache_dtype in ("int8", torch.int8):
        raise ValueError("the scaled-int8 state targets batched decode; speculative is B=1")
    if draft_mode not in ("model", "ngram"):
        raise ValueError(f"unknown draft_mode {draft_mode!r}")
    T_new = max_length - L0
    if T_new <= 0:
        raise ValueError("max_length must exceed prompt length")
    K = k_draft
    W = 2 * K + 2  # verify window: committed backlog + K drafts
    T_buf = max_length + W + K + 2  # slack so that block writes never clip
    use_model_draft = draft_mode == "model"
    if draft_params is None:
        draft_params = params
    if draft_layers is not None:
        draft_params, draft_cfg = shallow_draft(draft_params, cfg, draft_layers)
    if draft_cfg is None:
        draft_cfg = cfg
    dtype = input_embeddings.dtype

    # ---- prefill both models ---------------------------------------------
    hidden, t_cache = backbone_forward(params, input_embeddings, task, cfg, return_cache=True)
    if cache_dtype is not None:
        t_cache = t_cache._replace(ssm_state=t_cache.ssm_state.to(cache_dtype))
    c0 = int(torch.argmax(apply_head(params, hidden[:, -1], task), dim=-1)[0])

    d_cache, step, step_kw = None, None, {}
    if use_model_draft:
        # the draft reuses the caller's prompt embeddings
        _, d_cache = backbone_forward(draft_params, input_embeddings, task, draft_cfg,
                                      return_cache=True)
        step = backbone_step
        if fused_decode_limits(draft_params["layers"], draft_cfg.mixer, draft_cfg.lora,
                               dtype) is None:
            step = backbone_step_fused
            if device.type == "cuda":
                step_kw = {"plan": prepare_fused_decode(
                    draft_params["layers"], task, draft_cfg.mixer, draft_cfg.lora, 1, dtype)}

    seq = np.zeros(T_buf, np.int64)
    seq[:L0] = input_ids[0].cpu().numpy()
    seq[L0] = c0
    eos_at = L0 if (eos_token_id is not None and c0 == eos_token_id) else T_buf
    n_commit, t_pos, d_pos = L0 + 1, L0, L0
    rounds = drafted = accepted = 0

    def cont(p, c, tokens, pos0, valid, cfg_):
        """One continuation pass: consume ``tokens`` (1, W), ``valid`` of them
        real, from cache ``c`` at absolute position pos0. Returns (hidden
        (1, W, d), new cache); ``c`` itself is left as it was."""
        emb = embed_decode_window(p, tokens, pos0, task, cfg_, dtype)
        return backbone_forward(p, emb, task, cfg_, add_mmu_pos=False, return_cache=True,
                                initial_cache=c, valid_len=torch.tensor([valid], device=device))

    while n_commit < max_length and eos_at >= n_commit:
        u = n_commit - t_pos  # committed backlog the target must consume
        D = int(np.clip(W - u, 0, K))  # drafts that still fit in the window

        # ---- draft: catch up on the committed tokens, then propose K ------
        if use_model_draft:
            du = n_commit - d_pos
            d_tok = torch.as_tensor(seq[d_pos:d_pos + W], device=device)[None]
            h_d, d_base = cont(draft_params, d_cache, d_tok, d_pos, du, draft_cfg)
            # the pass consumed seq[:n_commit]; its last real row predicts the first draft
            last = h_d[:, min(max(du - 1, 0), W - 1)]
            tok = torch.argmax(apply_head(draft_params, last, task), dim=-1)  # (1,)
            drafts_dev = [tok]
            work = _clone_cache(d_base)  # the steps update in place; d_base is kept
            for i in range(K - 1):
                h, _ = step(draft_params, tok, n_commit + i, work, task, draft_cfg, dtype=dtype,
                            **step_kw)
                tok = torch.argmax(apply_head(draft_params, h, task), dim=-1)
                drafts_dev.append(tok)
            drafts_dev = torch.cat(drafts_dev)  # (K,) on the device
            d_cache = d_base
        else:
            # prompt lookup: the most recent p with seq[p-g:p] == seq[n-g:n]
            g = ngram
            tail = seq[max(n_commit - g, 0):max(n_commit - g, 0) + g]
            p = -1
            for idx in range(n_commit - 2, g - 1, -1):
                if np.array_equal(seq[idx - g:idx], tail):
                    p = idx
                    break
            if p >= 0:
                start = min(p, T_buf - K)
                drafts_np = seq[start:start + K].copy()
            else:
                drafts_np = np.full(K, seq[n_commit - 1], np.int64)
            drafts_dev = torch.as_tensor(drafts_np, device=device)

        # ---- verify: one target pass over [backlog ++ drafts] -------------
        committed = torch.as_tensor(seq[t_pos:t_pos + W], device=device)
        wi = torch.arange(W, device=device)
        di = wi - u
        use_draft = (di >= 0) & (di < D)
        wtok = torch.where(use_draft, drafts_dev[torch.clamp(di, 0, K - 1)], committed)
        v = u + D
        h, t_new = cont(params, t_cache, wtok[None], t_pos, v, cfg)
        if cache_dtype is not None:
            t_new = t_new._replace(ssm_state=t_new.ssm_state.to(cache_dtype))
        preds = torch.argmax(apply_head(params, h[0], task), dim=-1)  # (W,)
        both = torch.cat([drafts_dev, preds]).cpu().numpy()  # ONE host read a round
        drafts, preds_h = both[:K], both[K:]

        # accept drafts while they match the target's own argmax chain
        j = 0
        while j < D and drafts[j] == preds_h[u + j - 1]:
            j += 1
        correction = int(preds_h[min(max(u - 1 + j, 0), W - 1)])
        block = [int(t) for t in drafts[:j]] + [correction]
        if eos_token_id is not None and eos_token_id in block:
            first_eos = block.index(eos_token_id)
            block = block[: first_eos + 1]
            if eos_at >= T_buf:
                eos_at = n_commit + first_eos
        seq[n_commit:n_commit + len(block)] = block

        if j == D:  # whole window consumed: the verify cache is exact
            t_cache, t_pos = t_new, t_pos + v
        d_pos = n_commit
        n_commit += len(block)
        rounds, drafted, accepted = rounds + 1, drafted + D, accepted + j

    end = min(n_commit, eos_at + 1, max_length)
    out = np.where(np.arange(T_buf) < end, seq, 0)[:max_length]
    return SpecDecodeOutput(
        sequences=torch.as_tensor(out, device=device)[None], num_generated=end - L0,
        rounds=rounds, drafted=drafted, accepted=accepted)
